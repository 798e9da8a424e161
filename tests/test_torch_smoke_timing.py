"""``chip_smoke.time_kernel``'s bookkeeping, with the card's timers
stubbed.

A kernels-line row's ``ms`` is the kernel's device time: the profiler's
kernel records, else CUDA events around the raw launches alone
(``kernel_event_ms``, which runs every time).  When the profiler gives no
complete trace the row takes the event timer's time, and when that fails
too the row's ``ms`` is None and no share of the bound is computed.  The
wrapper's time (CUDA events around the whole wrapper call) goes in
``wrapper_ms`` only.
"""

import pytest

import chip_smoke

WRAPPER_MS, PLAIN_MS, EVENTS_MS = 0.2333, 4.8, 0.0322
NBYTES, NBASES = 18_696_024, 8_000_000


def _kernel():
    pass


def _plain():
    pass


def _prepare():
    raise AssertionError("the stubbed event timer launches nothing")


def _events_fail(prepare):
    raise RuntimeError("no event pair on this stream")


@pytest.mark.parametrize("events", ["time", "fail"])
def test_row_never_takes_the_wrapper_time(monkeypatch, capsys, events):
    """The profiler's trace is incomplete (``kernel_profiler_ms`` gives
    None): the row's ``ms`` is the event timer's, or None when that
    fails, never the wrapper's, and the printed share is computed from
    the kernel's time or not at all."""
    monkeypatch.setattr(chip_smoke, "cuda_time_ms",
                        lambda fn: WRAPPER_MS if fn is _kernel else PLAIN_MS)
    monkeypatch.setattr(chip_smoke, "kernel_profiler_ms",
                        lambda fn, launches, name: None)
    monkeypatch.setattr(chip_smoke, "kernel_event_ms",
                        (lambda prepare: EVENTS_MS) if events == "time"
                        else _events_fail)
    row = chip_smoke.time_kernel("k2", "K2 stub", _kernel, _plain, _prepare,
                                 "stats_k2_", NBYTES, NBASES,
                                 launches_per_call=2)
    out = capsys.readouterr().out
    b_ms, b_by = chip_smoke.bound(NBYTES, NBASES)
    assert (row["wrapper_ms"], row["plain_ms"]) == (WRAPPER_MS, PLAIN_MS)
    assert (row["bound_ms"], row["bound_by"]) == (b_ms, b_by)
    wrapper_share = "%.1f%% of the bound" % (100 * b_ms / WRAPPER_MS)
    assert wrapper_share not in out
    if events == "time":
        assert row["ms"] == EVENTS_MS
        assert "%.1f%% of the bound" % (100 * b_ms / EVENTS_MS) in out
        assert "CUDA events around the raw launches %.4f" % EVENTS_MS \
            in out
    else:
        assert row["ms"] is None
        assert "share not computed" in out and "% of the bound" not in out
        assert "no event pair on this stream" in out
