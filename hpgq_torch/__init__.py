"""hpgq_torch — the PyTorch/CUDA port of hpgq for one NVIDIA H100.

The JAX package ``hpgq`` stays the reference; this package runs the same
commands with PyTorch, and every Pallas kernel on a ported path becomes a
kernel written by hand for Hopper (``hpgq_torch/kernels/csrc``).  The
port imports nothing of ``hpgq``: it keeps its own copies of the host
layers it needs (reader, native packer, options, counters, report,
checkpoint), in ``hpgq``'s layout, with the same formats.

Ported: every command of ``hpgq``, single-end or paired: ``stats`` for
reads of any length, with and without the inline filter and with
``--kmers``; ``filter``; ``edit`` and ``prepro``; ``cgr`` (``python -m
hpgq_torch <command> ...``, or :func:`hpgq_torch.stats`,
:func:`~hpgq_torch.filter_reads`, :func:`~hpgq_torch.edit`,
:func:`~hpgq_torch.prepro`, :func:`~hpgq_torch.cgr`); ``--sharded`` runs
over ``torch.distributed``, one rank per local card that the command
starts itself or one rank of a ``torchrun`` run; the legacy single-binary
flags and ``--profile-dir``.  The device is explicit: ``"cuda"`` by default,
``"cpu"`` only when asked for.
"""

__version__ = "0.1.0"


def __getattr__(name):
    """Lazy top-level API: ``import hpgq_torch`` loads no torch until a
    command is used."""
    if name in ("stats", "filter_reads", "edit", "prepro", "cgr"):
        from . import api

        return getattr(api, name)
    raise AttributeError(name)
