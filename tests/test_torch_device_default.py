"""The port's sessions, accumulators and zeroed-state factories default to
the card.

``hpgq``'s counterparts take ``device=None``, JAX's default device, the
accelerator (``hpgq/pipeline/session.py:47``,
``hpgq/core/accumulator.py:76,95-96``).  The port's default is
``"cuda"``, resolved by ``hpgq_torch.device.resolve_device``: on a machine
without CUDA a call that names no device raises ``DeviceUnavailable``
rather than run on the CPU unnoticed, and ``device="cpu"`` builds on the
CPU.  CUDA is hidden here, so the test holds on any machine.
"""

import pytest
import torch

from hpgq_torch.core.accumulator import DeviceAccumulator
from hpgq_torch.device import DeviceUnavailable
from hpgq_torch.kernels.cgr_torch import zero_cgr_acc
from hpgq_torch.kernels.stats_torch import zero_partials
from hpgq_torch.pipeline.cgr_run import CgrSession
from hpgq_torch.pipeline.session import (
    PairedStatsSession,
    ShapeCachedFn,
    StatsSession,
)


def _tensors(obj):
    """The tensors a session or a factory built."""
    if isinstance(obj, dict):
        return list(obj.values())
    for name in ("acc", "_acc1", "_acc2"):
        got = getattr(obj, name, None)
        if isinstance(got, DeviceAccumulator):
            got = got.acc
        if isinstance(got, dict):
            return list(got.values())
    return []


FACTORIES = {  # name: a call that takes ``device`` as a keyword or not
    "StatsSession(33)": lambda **kw: StatsSession(33, **kw),
    "PairedStatsSession(33)": lambda **kw: PairedStatsSession(33, **kw),
    "ShapeCachedFn(fn, 512)": lambda **kw: ShapeCachedFn(
        lambda c, q, n, v: v, 512, **kw),
    "DeviceAccumulator(128, 33)": lambda **kw: DeviceAccumulator(128, 33,
                                                                 **kw),
    "CgrSession(4, 33, 1024)": lambda **kw: CgrSession(4, 33, 1024, **kw),
    "zero_partials(128)": lambda **kw: zero_partials(128, **kw),
    "zero_cgr_acc(4)": lambda **kw: zero_cgr_acc(4, **kw),
}


@pytest.mark.parametrize("name", list(FACTORIES))
def test_no_device_means_the_card(monkeypatch, name):
    """Without CUDA, no device named raises ``DeviceUnavailable``;
    ``device="cpu"`` builds on the CPU, tensors and all."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    build = FACTORIES[name]
    with pytest.raises(DeviceUnavailable, match="CUDA is not available"):
        build()
    got = build(device="cpu")
    if not isinstance(got, dict):
        assert got.device == torch.device("cpu")
    tensors = _tensors(got)
    assert all(t.device.type == "cpu" for t in tensors)
    if not isinstance(got, (ShapeCachedFn, CgrSession)):
        assert tensors  # the state lives in tensors on that device
