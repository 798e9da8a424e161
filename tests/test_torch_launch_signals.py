"""The port's local launcher (``hpgq_torch.dist.launch``) when a rank
fails or the parent is stopped: a rank that raises, SIGTERM to the parent,
SIGINT to the parent alone and SIGINT to the parent's whole process group
(a terminal's Ctrl-C), and SIGINT again while the parent stops ranks that
outlive SIGTERM.  The parent exits non-zero within 60 s, every rank is
gone, the launcher's temporary directory too, and no report is written.
Ctrl-C in a checkpointed run, and its resume, are in
``tests/test_torch_launch_resume.py``.

Each case starts two CPU ranks from a parent of its own (a subprocess);
the rank targets are in ``tests/torch_rank_targets.py``.
"""

import os
import signal
import subprocess
import sys
import time

import pytest

from gen import make_fastq

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TESTS = os.path.join(REPO, "tests")


def _alive(pid: int) -> bool:
    """A process that runs (not gone, not a zombie)."""
    try:
        with open("/proc/%d/stat" % pid) as f:
            return f.read().rsplit(")", 1)[1].split()[0] != "Z"
    except OSError:
        return False


def _stopped_launch(tmp_path, target, args, sig=None, group=False,
                    times=1):
    """Run ``launch(target, (args,), ['cpu', 'cpu'])`` in a parent of its
    own (jax and ``hpgq`` blocked there), with ``FQ``, ``OUT``, ``CK`` and
    ``PIDS`` naming the input, the output directory, the checkpoint and
    the directory where each rank notes its pid once it waits; with
    ``sig``, send it ``times`` times, a second apart, once both ranks
    wait, to the parent alone or to its process group.  Returns (the
    parent's exit status, its stderr, the seconds it took, the ranks'
    pids, its private ``TMPDIR``)."""
    fq = str(tmp_path / "in.fq")
    make_fastq(fq, 2000, min_len=40, max_len=110, seed=9)
    out, pids, tmp = tmp_path / "out", tmp_path / "pids", tmp_path / "tmp"
    for d in (out, pids, tmp):
        d.mkdir()
    code = ("import sys\n"
            "sys.path[:0] = [%r, %r]\n"
            "for n in ('jax', 'jaxlib', 'hpgq'):\n"
            "    sys.modules[n] = None\n"
            "from hpgq_torch.dist.launch import launch\n"
            "from hpgq_torch.options import StatsOptions\n"
            "from torch_rank_targets import (fail_on_rank_one, "
            "stats_then_wait,\n"
            "                                wait_forever, "
            "wait_through_sigterm)\n"
            "FQ, OUT, CK, PIDS = %r, %r, %r, %r\n"
            "launch(%s, (%s,), ['cpu', 'cpu'])\n"
            % (REPO, TESTS, fq, str(out), str(tmp_path / "ck"), str(pids),
               target, args))
    env = dict(os.environ, TMPDIR=str(tmp))
    t0 = time.perf_counter()
    p = subprocess.Popen([sys.executable, "-c", code], env=env,
                         stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                         text=True, start_new_session=group)
    try:
        if sig is not None:
            while len(os.listdir(pids)) < 2:
                assert p.poll() is None and time.perf_counter() - t0 < 50
                time.sleep(0.1)
            for i in range(times):
                time.sleep(i and 1.0)
                if group:
                    os.killpg(p.pid, sig)
                else:
                    p.send_signal(sig)
        _, err = p.communicate(timeout=60 - (time.perf_counter() - t0))
    finally:
        if p.poll() is None:
            p.kill()
            p.wait()
    secs = time.perf_counter() - t0
    ranks = [int((pids / n).read_text()) for n in sorted(os.listdir(pids))]
    return p.returncode, err, secs, ranks, tmp


def _nothing_left(code, err, secs, ranks, tmp, out):
    """Non-zero in under 60 s, no rank running, the private ``TMPDIR``
    empty, no report."""
    assert code != 0, err[-2000:]
    assert secs < 60
    assert len(ranks) in (1, 2) and not any(_alive(r) for r in ranks)
    assert os.listdir(tmp) == []
    assert not [n for n in os.listdir(out) if n.endswith(".summary.txt")]


STOPS = {  # how: (the signal, to the parent's group, how many times, the
    # rank target, its args)
    "rank 1 raises": (None, False, 0, "fail_on_rank_one",
                      "StatsOptions(in_filename=FQ, out_dirname=OUT, "
                      "batch_size=300), PIDS"),
    "SIGTERM to the parent": (signal.SIGTERM, False, 1, "wait_forever",
                              "PIDS"),
    "SIGINT to the parent": (signal.SIGINT, False, 1, "wait_forever",
                             "PIDS"),
    "SIGINT to the group": (signal.SIGINT, True, 1, "wait_forever", "PIDS"),
    "SIGINT to the parent twice, ranks deaf to SIGTERM": (
        signal.SIGINT, False, 2, "wait_through_sigterm", "PIDS"),
}


@pytest.mark.parametrize("how", list(STOPS))
def test_a_failure_stops_every_rank(tmp_path, how):
    """Two CPU ranks; rank 1 raises while rank 0 waits in the merge, or
    both wait (rank 0 in a collective) and the parent, or its whole
    group, gets the signal; a second SIGINT lands while the parent waits
    out the grace period of ranks that ignore SIGTERM.  The parent exits
    non-zero in under 60 s, leaves no rank running and no temporary
    directory, and no report is written."""
    sig, group, times, target, args = STOPS[how]
    code, err, secs, ranks, tmp = _stopped_launch(tmp_path, target, args,
                                                  sig, group, times)
    if sig is None:
        assert "rank 1 fails on purpose" in err
        assert "RankFailed" in err
    _nothing_left(code, err, secs, ranks, tmp, tmp_path / "out")
