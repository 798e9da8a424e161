"""K1/K2 wrappers and dispatch: fused stats + inline-filter partials.

:func:`batch_partials_cuda` launches K1's plain entry and
:func:`batch_partials_cuda_2u` its 2u entry (``csrc/stats_k1.cu``, which
replaces ``hpgq/kernels/stats_pallas.py:_stats_kernel``);
:func:`batch_partials_cuda_long` launches ``csrc/stats_k2.cu`` (which
replaces ``_stats_kernel_blockwise``).  All return the partials dict of
``stats_pallas.batch_partials_pallas`` (``stats_pallas.py:253-273``),
int64.  :func:`make_batch_partials` is the port of
``stats_pallas.make_batch_partials`` (``:575-611``): K1 for CUDA tensors
at lcap <= 4096, K2 above (with no upper limit), the plain twin
(``stats_torch.fused_partials``) for CPU tensors, and the k-mer pass on
the pass mask of whichever ran.  :func:`batch_partials_2u` takes a 2u
batch straight from the wire: K1's 2u entry on CUDA, the decode and the
plain twin on the CPU; :func:`batch_partials_ragged` likewise a long
block's ragged 6-bit wire, through K2's ragged entry
(:func:`batch_partials_cuda_ragged`).  Nothing falls back from one to
another.
"""

from __future__ import annotations

import threading

import torch

from ..constants import MAX_VALUE, MIN_VALUE
from ..core.counters import GC_BINS, QUAL_BINS
from .stats_torch import MIN_LENGTH_INIT, fused_partials, kmer_partials
from .wire_torch import (
    pad_wire_cols,
    ragged_table,
    wire_unbits2u,
    wire_unragged,
)

MAX_LCAP = 4096  # K1's limit; longer reads go through K2

LAUNCHES = 0  # K1 plain-entry launches since the last reset
LAUNCHES_2U = 0  # K1 2u-entry launches since the last reset
LAUNCHES_K2 = 0  # K2 calls, either entry (launch A, and B with criteria)
_count_lock = threading.Lock()

_NUM_READS, _ACC_LENGTH, _MIN_LEN, _MAX_LEN, _NUM_PASSED, _NUM_FAILED = range(6)


def crit_struct(crit, phred: int):
    """The kernel's ``K1Crit`` argument for a FilterCriteria (or None)."""
    from .build import K1Crit

    if crit is None:
        return K1Crit(on=0, phred=phred)
    c = crit.substituted()
    return K1Crit(
        on=1, min_len=c.min_read_length, max_len=c.max_read_length,
        min_q=c.min_read_quality, max_q=c.max_read_quality,
        oq_on=int(c.max_out_of_quality != MAX_VALUE),
        max_oq=c.max_out_of_quality,
        qwin_on=int(c.quality_window_on), begin=c.begin_quality_nt,
        end=c.end_quality_nt,
        left_len=c.left_length if c.left_length > MIN_VALUE else 0,
        min_lq=c.min_left_quality, max_lq=c.max_left_quality,
        right_len=c.right_length if c.right_length > MIN_VALUE else 0,
        min_rq=c.min_right_quality, max_rq=c.max_right_quality,
        max_n=c.max_N, phred=phred,
    )


def _check(name, t, dtype, shape, device):
    if t.device != device:
        raise ValueError("%s is on %s, expected %s" % (name, t.device, device))
    if t.dtype != dtype:
        raise ValueError("%s has dtype %s, expected %s" % (name, t.dtype,
                                                          dtype))
    if shape is not None and tuple(t.shape) != shape:
        raise ValueError("%s has shape %s, expected %s" % (
            name, tuple(t.shape), shape))
    if not t.is_contiguous():
        raise ValueError("%s is not contiguous" % name)


def _cuda_device(kernel: str, t):
    if t.device.type != "cuda":
        raise ValueError("the %s wrapper needs CUDA tensors, got %s"
                         % (kernel, t.device))
    return t.device


def _check_rows(codes, quals, lens, valid, lcap: int):
    """Check the plain entries' inputs; returns ``(B, L)``."""
    if codes.dim() != 2:
        raise ValueError("codes must be [B, L], got %s" % (tuple(codes.shape),))
    B, L = codes.shape
    if L > lcap:
        raise ValueError("L %d exceeds lcap %d" % (L, lcap))
    dev = codes.device
    _check("codes", codes, torch.int8, (B, L), dev)
    _check("quals", quals, torch.uint8, (B, L), dev)
    _check("lens", lens, torch.int32, (B,), dev)
    _check("valid", valid, torch.bool, (B,), dev)
    return B, L


class _Outputs:
    """Every output of a launch cut from ONE zeroed device buffer: the int64
    partials (scalars [8], length/quality/GC histograms, coverage, quality
    and base sums per position, base totals [5]) and ``n_i64_extra`` int64
    scratch slots, ``n_f32`` floats, and the bool pass mask [B]."""

    def __init__(self, dev, lcap: int, B: int, n_f32: int,
                 n_i64_extra: int = 0):
        sizes = (8, lcap + 1, QUAL_BINS, GC_BINS, lcap, lcap, 5 * lcap, 5,
                 n_i64_extra)
        n64 = sum(sizes)
        buf = torch.zeros(8 * n64 + 4 * n_f32 + B, dtype=torch.uint8,
                          device=dev)
        ints = buf[:8 * n64].view(torch.int64)
        (self.scal, self.lh, self.qh, self.gh, self.cov, self.qpn, bpn,
         self.bt, self.scratch) = torch.split(ints, sizes)
        self.bpn = bpn.view(5, lcap)
        self.f32 = buf[8 * n64:8 * n64 + 4 * n_f32].view(torch.float32)
        self.passed = buf[8 * n64 + 4 * n_f32:].view(torch.bool)

    def ptrs(self):
        """The output pointers in the launchers' order (scalars ...
        bpn)."""
        return (self.scal.data_ptr(), self.lh.data_ptr(), self.qh.data_ptr(),
                self.gh.data_ptr(), self.cov.data_ptr(), self.qpn.data_ptr(),
                self.bpn.data_ptr())

    def partials(self, acc_quality, base_totals, crit) -> dict:
        p = {
            "num_reads": self.scal[_NUM_READS],
            "acc_length": self.scal[_ACC_LENGTH],
            "min_length": self.scal[_MIN_LEN],
            "max_length": self.scal[_MAX_LEN],
            "acc_quality": acc_quality,
            "base_totals": base_totals,
            "length_hist": self.lh,
            "quality_hist": self.qh,
            "gc_hist": self.gh,
            "cov_per_nt": self.cov,
            "qual_per_nt": self.qpn,
            "base_per_nt": self.bpn,
            "_passed_mask": self.passed,
        }
        if crit is not None:
            p["_num_passed"] = self.scal[_NUM_PASSED]
            p["_num_failed"] = self.scal[_NUM_FAILED]
        return p


def _count(kernel: str) -> None:
    global LAUNCHES, LAUNCHES_2U, LAUNCHES_K2
    with _count_lock:
        if kernel == "K1":
            LAUNCHES += 1
        elif kernel == "K1 2u":
            LAUNCHES_2U += 1
        else:
            LAUNCHES_K2 += 1


def _raise_if(rc: int, kernel: str, lib) -> None:
    if rc != 0:
        raise RuntimeError("%s launch failed: %s (cudaError %d)" % (
            kernel, lib.hpgq_k1_error_string(rc).decode(), rc))


def _k1_outputs(lib, dev, wire2u: int, B: int, L: int, lcap: int, W: int):
    nt = lib.hpgq_k1_tiles(wire2u, B, L, lcap, W) if B else 0
    if nt < 0:
        raise ValueError("K1 has no shared-memory layout for L %d, lcap %d"
                         % (L, lcap))
    out = _Outputs(dev, lcap, B, nt + 1)
    if not B:  # nothing to launch: the zeros are the result, min its init
        out.scal[_MIN_LEN] = MIN_LENGTH_INIT
    return out, out.f32[:nt], out.f32[nt]


def batch_partials_cuda(codes, quals, lens, valid, lcap: int, phred: int,
                        crit=None) -> dict:
    """Launch K1's plain entry on ``torch.cuda.current_stream()``.

    ``codes`` int8 [B, L], ``quals`` uint8 [B, L], ``lens`` int32 [B],
    ``valid`` bool [B], all contiguous on one CUDA device; ``L <= lcap <=
    4096``.  Raises on anything else, and if the launch is refused."""
    launch, finish = prepare_k1(codes, quals, lens, valid, lcap, phred,
                                crit)
    if launch():
        _count("K1")
    return finish()


def batch_partials_cuda_2u(buf, exc, pal, n_valid: int, L: int, lcap: int,
                           phred: int, crit=None) -> dict:
    """Launch K1's 2u entry on ``torch.cuda.current_stream()``: the
    partials of :func:`batch_partials_cuda` over the decoded batch, read
    straight from the 2u wire (``buf`` uint8 [B, W], ``exc`` int32
    exceptions in ascending order as the packers write them, ``pal`` uint8
    [4]; rows below ``n_valid`` have length ``L``)."""
    launch, finish = prepare_k1_2u(buf, exc, pal, n_valid, L, lcap, phred,
                                   crit)
    if launch():
        _count("K1 2u")
    return finish()


def batch_partials_cuda_long(codes, quals, lens, valid, lcap: int,
                             phred: int, crit=None) -> dict:
    """Launch K2 on ``torch.cuda.current_stream()``: the contract of
    :func:`batch_partials_cuda` for any ``L <= lcap`` (no upper limit).
    Raises on bad inputs, and if a launch is refused."""
    launch, finish = prepare_k2(codes, quals, lens, valid, lcap, phred, crit)
    if launch():
        _count("K2")
    return finish()


def batch_partials_cuda_ragged(buf, rows: int, L: int, lcap: int,
                               phred: int, crit=None) -> dict:
    """Launch K2's ragged entry on ``torch.cuda.current_stream()``: the
    partials of :func:`batch_partials_cuda_long` over a long block read
    straight from its ragged 6-bit wire (``buf`` uint8, the table then the
    rows, ``rows`` rows, the longest ``L <= lcap``;
    ``hpgq_torch.io.native.ragged_layout``)."""
    launch, finish = prepare_k2_ragged(buf, rows, L, lcap, phred, crit)
    if launch():
        _count("K2")
    return finish()


# The wrappers above in two halves, ``(launch, finish)``: the checks and
# the zeroed outputs (and K1's 16-byte row padding) come first;
# ``launch()`` is the raw launch alone, on the current stream at its call,
# counts nothing and returns whether a kernel went (an empty batch sends
# none); ``finish()`` returns the partials.  The kernels add into their
# outputs and elect a last block through a counter in them, so each launch
# needs outputs of its own: one prepare, one launch.  A timer can put CUDA
# events around ``launch()`` alone.

def prepare_k1(codes, quals, lens, valid, lcap: int, phred: int, crit=None):
    """K1's plain entry, ready to launch (see above)."""
    if lcap > MAX_LCAP:
        raise ValueError("K1 takes lcap <= %d, got %d; longer reads go "
                         "through K2 (batch_partials_cuda_long)"
                         % (MAX_LCAP, lcap))
    dev = _cuda_device("K1", codes)
    B, L = _check_rows(codes, quals, lens, valid, lcap)
    from .build import load

    lib = load()
    out, tiles, acc_q = _k1_outputs(lib, dev, 0, B, L, lcap, 0)
    # the kernel stages rows by 16-byte copies: rows of a multiple of 16
    # bytes, 16-byte aligned (the packers' widths are already)
    ld = -(-max(L, 1) // 16) * 16
    if B and (ld != L or codes.data_ptr() % 16 or quals.data_ptr() % 16):
        codes = torch.nn.functional.pad(codes, (0, ld - L))
        quals = torch.nn.functional.pad(quals, (0, ld - L))

    def launch() -> bool:
        if not B:
            return False
        _raise_if(lib.hpgq_k1_launch(
            codes.data_ptr(), quals.data_ptr(), lens.data_ptr(),
            valid.data_ptr(), B, L, ld, lcap, crit_struct(crit, phred),
            *out.ptrs(), out.bt.data_ptr(), tiles.data_ptr(),
            acc_q.data_ptr(), out.passed.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream), "K1", lib)
        return True

    return launch, lambda: out.partials(acc_q, out.bt, crit)


def prepare_k1_2u(buf, exc, pal, n_valid: int, L: int, lcap: int,
                  phred: int, crit=None):
    """K1's 2u entry, ready to launch (see above)."""
    if lcap > MAX_LCAP or L > lcap:
        raise ValueError("the K1 2u entry takes L <= lcap <= %d, got L %d, "
                         "lcap %d" % (MAX_LCAP, L, lcap))
    dev = _cuda_device("K1 2u", buf)
    if buf.dim() != 2 or exc.dim() != 1:
        raise ValueError("buf must be [B, W] and exc 1-D, got %s and %s"
                         % (tuple(buf.shape), tuple(exc.shape)))
    B, W = buf.shape
    _check("buf", buf, torch.uint8, (B, W), dev)
    _check("exc", exc, torch.int32, None, dev)
    _check("pal", pal, torch.uint8, (4,), dev)
    if not 0 <= n_valid <= B or L > 2 * W:
        raise ValueError("n_valid %d or L %d do not fit a [%d, %d] 2u batch"
                         % (n_valid, L, B, W))
    from .build import load

    lib = load()
    out, tiles, acc_q = _k1_outputs(lib, dev, 1, B, L, lcap, W)

    def launch() -> bool:
        if not B:
            return False
        _raise_if(lib.hpgq_k1_launch_2u(
            buf.data_ptr(), exc.data_ptr(), exc.shape[0], pal.data_ptr(),
            n_valid, B, W, L, lcap, crit_struct(crit, phred), *out.ptrs(),
            out.bt.data_ptr(), tiles.data_ptr(), acc_q.data_ptr(),
            out.passed.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream), "K1 2u", lib)
        return True

    return launch, lambda: out.partials(acc_q, out.bt, crit)


def prepare_k2(codes, quals, lens, valid, lcap: int, phred: int, crit=None):
    """K2, ready to launch (see above): ``launch()`` sends launch A, and B
    with criteria."""
    dev = _cuda_device("K2", codes)
    B, L = _check_rows(codes, quals, lens, valid, lcap)
    from .build import load

    lib = load()
    out = _Outputs(dev, lcap, B, B, lib.hpgq_k2_scratch_slots(B))
    out.scal[_MIN_LEN] = MIN_LENGTH_INIT

    def launch() -> bool:
        if not B:
            return False
        _raise_if(lib.hpgq_k2_launch(
            codes.data_ptr(), quals.data_ptr(), lens.data_ptr(),
            valid.data_ptr(), B, L, lcap, crit_struct(crit, phred),
            *out.ptrs(), out.scratch.data_ptr(), out.f32.data_ptr(),
            out.passed.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream), "K2", lib)
        return True

    # f32 per-row means summed in float64, in a fixed order: the same
    # value every run
    return launch, lambda: out.partials(out.f32.sum(dtype=torch.float64),
                                        out.bpn.sum(dim=1), crit)


def prepare_k2_ragged(buf, rows: int, L: int, lcap: int, phred: int,
                      crit=None):
    """K2's ragged entry, ready to launch (see above)."""
    from ..io.native import ragged_head

    dev = _cuda_device("K2 ragged", buf)
    head = ragged_head(rows)
    if buf.dim() != 1 or L > lcap or buf.shape[0] < head:
        raise ValueError("not a ragged wire of %d rows of at most L %d <= "
                         "lcap %d: %s bytes" % (rows, L, lcap,
                                                tuple(buf.shape)))
    _check("buf", buf, torch.uint8, None, dev)
    if buf.data_ptr() % 16:
        raise ValueError("a ragged wire must start 16-byte aligned")
    table = [t.data_ptr() for t in ragged_table(buf, rows)]
    from .build import load

    lib = load()
    out = _Outputs(dev, lcap, rows, rows, lib.hpgq_k2_scratch_slots(rows))
    out.scal[_MIN_LEN] = MIN_LENGTH_INIT

    def launch() -> bool:
        if not rows:
            return False
        _raise_if(lib.hpgq_k2_launch_ragged(
            buf.data_ptr() + head, *table, rows, L, lcap,
            crit_struct(crit, phred), *out.ptrs(),
            out.scratch.data_ptr(), out.f32.data_ptr(),
            out.passed.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream), "K2 ragged", lib)
        return True

    return launch, lambda: out.partials(out.f32.sum(dtype=torch.float64),
                                        out.bpn.sum(dim=1), crit)


def batch_partials_ragged(buf, rows: int, L: int, lcap: int, phred: int,
                          crit=None) -> dict:
    """The partials of one long block's ragged 6-bit wire: K2's ragged
    entry for CUDA tensors, the decode (``wire_unragged`` +
    ``pad_wire_cols``) and the plain twin for CPU tensors."""
    if buf.device.type == "cuda":
        return batch_partials_cuda_ragged(buf, rows, L, lcap, phred, crit)
    if buf.device.type != "cpu":
        raise ValueError("no stats kernel for device %s" % buf.device)
    codes, quals, lens, valid = wire_unragged(buf, rows, L)
    codes, quals = pad_wire_cols(codes, quals, lcap)
    return fused_partials(codes, quals, lens, valid, lcap, phred, crit)


def batch_partials_2u(buf, exc, pal, n_valid: int, L: int, lcap: int,
                      phred: int, crit=None) -> dict:
    """The partials of one 2u batch: K1's 2u entry for CUDA tensors, the
    decode (``wire_unbits2u`` + ``pad_wire_cols``) and the plain twin for
    CPU tensors."""
    if buf.device.type == "cuda":
        return batch_partials_cuda_2u(buf, exc, pal, n_valid, L, lcap, phred,
                                      crit)
    if buf.device.type != "cpu":
        raise ValueError("no stats kernel for device %s" % buf.device)
    codes, quals, lens, valid = wire_unbits2u(buf, exc, pal, n_valid, L=L)
    codes, quals = pad_wire_cols(codes, quals, lcap)
    return fused_partials(codes, quals, lens, valid, lcap, phred, crit)


def make_batch_partials(lcap: int, phred: int, crit=None,
                        kmers_on: bool = False):
    """``fn(codes, quals, lens, valid) -> partials``: K1 (lcap <= 4096) or
    K2 for CUDA tensors, the plain twin for CPU tensors; with ``kmers_on``
    the k-mer fields over the rows of the ``_passed_mask`` that came out."""

    def fn(codes, quals, lens, valid):
        if codes.device.type == "cuda":
            bp = batch_partials_cuda if lcap <= MAX_LCAP \
                else batch_partials_cuda_long
            p = bp(codes, quals, lens, valid, lcap, phred, crit)
        elif codes.device.type == "cpu":
            return fused_partials(codes, quals, lens, valid, lcap, phred,
                                  crit, kmers_on)
        else:
            raise ValueError("no stats kernel for device %s" % codes.device)
        if kmers_on:
            p.update(kmer_partials(codes, lens, p["_passed_mask"], lcap))
        return p

    return fn
