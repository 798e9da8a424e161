"""hpgq_torch — the PyTorch/CUDA port of hpgq for one NVIDIA H100.

The JAX package ``hpgq`` stays the reference; this package runs the same
commands with PyTorch, and every Pallas kernel on a ported path becomes a
kernel written by hand for Hopper (``hpgq_torch/kernels/csrc``).  Host
layers without a jax import (reader, native packer, options, counters,
report, checkpoint) are shared with ``hpgq``.

Ported so far: single-end ``stats``, with and without the inline filter
(``python -m hpgq_torch stats ...`` or :func:`hpgq_torch.stats`).  The
device is explicit: ``"cuda"`` by default, ``"cpu"`` only when asked for.
"""

__version__ = "0.1.0"


def __getattr__(name):
    """Lazy top-level API: ``import hpgq_torch`` loads no torch until a
    command is used."""
    if name == "stats":
        from . import api

        return api.stats
    raise AttributeError(name)
