"""K1/K2 wrappers and dispatch: fused stats + inline-filter partials.

:func:`batch_partials_cuda` launches the hand-written kernel
``csrc/stats_k1.cu`` (which replaces ``hpgq/kernels/stats_pallas.py:
_stats_kernel``), :func:`batch_partials_cuda_long` launches
``csrc/stats_k2.cu`` (which replaces ``_stats_kernel_blockwise``); both
return the partials dict of ``stats_pallas.batch_partials_pallas``
(``stats_pallas.py:253-273``), int64.  :func:`make_batch_partials` is the
port of ``stats_pallas.make_batch_partials`` (``:575-611``): K1 for CUDA
tensors at lcap <= 4096, K2 above (with no upper limit), the plain twin
(``stats_torch.fused_partials``) for CPU tensors, and the k-mer pass on
the pass mask of whichever ran.  Nothing falls back from one to another.
"""

from __future__ import annotations

import threading

import torch

from hpgq.constants import MAX_VALUE, MIN_VALUE
from hpgq.core.counters import GC_BINS, QUAL_BINS

from .stats_torch import MIN_LENGTH_INIT, fused_partials, kmer_partials

MAX_LCAP = 4096  # K1's limit; longer reads go through K2

LAUNCHES = 0  # K1 launches by batch_partials_cuda since the last reset
LAUNCHES_K2 = 0  # K2 launches by batch_partials_cuda_long since the last reset
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
    if tuple(t.shape) != shape:
        raise ValueError("%s has shape %s, expected %s" % (
            name, tuple(t.shape), shape))
    if not t.is_contiguous():
        raise ValueError("%s is not contiguous" % name)


def _launch(kernel: str, codes, quals, lens, valid, lcap: int, phred: int,
            crit) -> dict:
    """Check the inputs, allocate the outputs, launch ``kernel`` ("k1" or
    "k2") on ``torch.cuda.current_stream()`` and count the launch."""
    global LAUNCHES, LAUNCHES_K2
    if codes.device.type != "cuda":
        raise ValueError("the %s wrapper needs CUDA tensors, got %s"
                         % (kernel.upper(), codes.device))
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

    from .build import load

    lib = load()
    # K1 sums the mean quality per block of rows, K2 per row
    nf = max(1, -(-B // lib.hpgq_k1_rows_per_block())) if kernel == "k1" \
        else B
    launch = lib.hpgq_k1_launch if kernel == "k1" else lib.hpgq_k2_launch
    # one zeroed int64 buffer, cut into the outputs
    sizes = (8, lcap + 1, QUAL_BINS, GC_BINS, lcap, lcap, 5 * lcap)
    ints = torch.zeros(sum(sizes), dtype=torch.int64, device=dev)
    scal, lh, qh, gh, cov, qpn, bpn = torch.split(ints, sizes)
    scal[_MIN_LEN] = MIN_LENGTH_INIT
    fq = torch.zeros(nf, dtype=torch.float32, device=dev)
    passed = torch.zeros(B, dtype=torch.bool, device=dev)
    if B:  # an empty batch has nothing to launch: the zeros are its result
        rc = launch(
            codes.data_ptr(), quals.data_ptr(), lens.data_ptr(),
            valid.data_ptr(), B, L, lcap, crit_struct(crit, phred),
            scal.data_ptr(), lh.data_ptr(), qh.data_ptr(), gh.data_ptr(),
            cov.data_ptr(), qpn.data_ptr(), bpn.data_ptr(), fq.data_ptr(),
            passed.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
        if rc != 0:
            raise RuntimeError("%s launch failed: %s (cudaError %d)" % (
                kernel.upper(), lib.hpgq_k1_error_string(rc).decode(), rc))
        with _count_lock:
            if kernel == "k1":
                LAUNCHES += 1
            else:
                LAUNCHES_K2 += 1
    bpn = bpn.view(5, lcap)
    p = {
        "num_reads": scal[_NUM_READS],
        "acc_length": scal[_ACC_LENGTH],
        "min_length": scal[_MIN_LEN],
        "max_length": scal[_MAX_LEN],
        # f32 partial sums in a fixed order -> the same value every run
        "acc_quality": fq.sum(),
        "base_totals": bpn.sum(dim=1),
        "length_hist": lh,
        "quality_hist": qh,
        "gc_hist": gh,
        "cov_per_nt": cov,
        "qual_per_nt": qpn,
        "base_per_nt": bpn,
        "_passed_mask": passed,
    }
    if crit is not None:
        p["_num_passed"] = scal[_NUM_PASSED]
        p["_num_failed"] = scal[_NUM_FAILED]
    return p


def batch_partials_cuda(codes, quals, lens, valid, lcap: int, phred: int,
                        crit=None) -> dict:
    """Launch K1 on ``torch.cuda.current_stream()``.

    ``codes`` int8 [B, L], ``quals`` uint8 [B, L], ``lens`` int32 [B],
    ``valid`` bool [B], all contiguous on one CUDA device; ``L <= lcap <=
    4096``.  Raises on anything else, and if the launch is refused."""
    if lcap > MAX_LCAP:
        raise ValueError("K1 takes lcap <= %d, got %d; longer reads go "
                         "through K2 (batch_partials_cuda_long)"
                         % (MAX_LCAP, lcap))
    return _launch("k1", codes, quals, lens, valid, lcap, phred, crit)


def batch_partials_cuda_long(codes, quals, lens, valid, lcap: int,
                             phred: int, crit=None) -> dict:
    """Launch K2 on ``torch.cuda.current_stream()``: the contract of
    :func:`batch_partials_cuda` for any ``L <= lcap`` (no upper limit).
    Raises on bad inputs, and if a launch is refused."""
    return _launch("k2", codes, quals, lens, valid, lcap, phred, crit)


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
