"""The port's wire decoders and per-batch steps against the JAX engine.

Buffers come from ``hpgq``'s native packers (``hpgq.io.packer``, byte-equal
to the port's copy: ``tests/test_torch_isolation.py``); each torch decoder
must give the same bytes as its jnp counterpart and as ``pack_block``.  The port's steps (decode -> pad -> partials -> merge) are
held against ``stats_jnp.make_stats_step2u`` / ``make_stats_step`` with the
Pallas kernel in interpret mode, over several batches: integer fields
exact, ``acc_quality`` to 1e-3 relative (f32 sums in another order).
"""

import numpy as np
import pytest
import torch

from gen import make_fastq

from hpgq.io.fastq import FastqReader
from hpgq.io.native import bitwire2c_width, bitwire2q_width, bitwire6_width
from hpgq.io.packer import (
    pack_block,
    pack_block_bitwire_tier,
    try_pack_block_2u,
)
from hpgq.kernels import stats_jnp
from hpgq.options import FilterCriteria
from hpgq_torch.core.accumulator import to_numpy
from hpgq_torch.kernels import step as tstep
from hpgq_torch.kernels import wire_torch
from hpgq_torch.kernels.stats_torch import zero_partials

torch.set_num_threads(2)

CRIT = FilterCriteria(min_read_length=50, max_read_length=200,
                      min_read_quality=20, max_read_quality=60, max_N=2)
TIERS = {"2c": -1, "2q": 0, "6bit": 1, "7bit": 2}
INT_KEYS = ("num_reads", "num_passed", "num_failed", "acc_length",
            "min_length", "max_length", "base_totals", "length_hist",
            "quality_hist", "gc_hist", "cov_per_nt", "qual_per_nt",
            "base_per_nt")


def _blocks(tmp_path, n=2000, batch=700, **kw):
    path = tmp_path / "w.fq"
    kw.setdefault("n_prob", 0.02)
    kw.setdefault("lowercase_prob", 0.05)
    make_fastq(str(path), n, **kw)
    with FastqReader(str(path), batch_size=batch) as rd:
        return list(rd)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _assert_same(got, want, ref, exact_padding=True):
    """``got`` byte-equal to the jnp decode ``want``, and to ``pack_block``'s
    ``ref`` — everywhere for the 2c/2u decoders, which re-set the padding;
    inside each read's length for the 2q/6/7-bit layouts, whose padding
    bytes are whatever the bitstream holds (as in the jnp decoders)."""
    for name, g, w in zip(("codes", "quals", "lens", "valid"), got, want):
        g = g.numpy()
        w = np.asarray(w)
        assert g.dtype == w.dtype, (name, g.dtype, w.dtype)
        np.testing.assert_array_equal(g, w, err_msg=name)
    lens = ref[2]
    inside = np.arange(ref[0].shape[1])[None, :] < lens[:, None]
    for name, g, r in zip(("codes", "quals", "lens", "valid"), got, ref):
        g = g.numpy()
        if name in ("codes", "quals") and not exact_padding:
            g, r = np.where(inside, g, 0), np.where(inside, r, 0)
        np.testing.assert_array_equal(g, r, err_msg=name)


@pytest.mark.parametrize("length", [100, 48, 37])
def test_decode_2u_matches_jnp(tmp_path, length):
    for block in _blocks(tmp_path, min_len=length, max_len=length, seed=12,
                         qual_bins=(2, 12, 23, 37)):
        out = try_pack_block_2u(block, pad_reads_to=1024)
        assert out is not None
        buf, exc, pal, n_valid, Lu = out
        got = wire_torch.wire_unbits2u(_t(buf), _t(exc), _t(pal), n_valid,
                                       L=Lu)
        want = stats_jnp.wire_unbits2u(buf, exc, pal, n_valid, L=Lu)
        ref = pack_block(block, max_len=got[0].shape[1], pad_reads_to=1024)
        _assert_same(got, want, ref)


@pytest.mark.parametrize("tier", list(TIERS), ids=list(TIERS))
@pytest.mark.parametrize("varlen", [True, False], ids=["varlen", "fixed"])
def test_decode_tiers_match_jnp(tmp_path, tier, varlen):
    kw = dict(min_len=41, max_len=127) if varlen else dict(min_len=100,
                                                           max_len=100)
    bins = (2, 12, 23, 37) if tier in ("2c", "2q") else None
    for block in _blocks(tmp_path, seed=11, qual_bins=bins, **kw):
        out = pack_block_bitwire_tier(block, 128, TIERS[tier],
                                      pad_reads_to=1024)
        assert out is not None, tier
        ref = pack_block(block, max_len=128, pad_reads_to=1024)
        if tier == "2c":
            buf, exc = out
            got = wire_torch.wire_unbits2c(_t(buf), _t(exc))
            want = stats_jnp.wire_unbits2c(buf, exc)
        else:
            got = wire_torch.wire_unbits(_t(out))
            want = stats_jnp.wire_unbits(out)
        _assert_same(got, want, ref, exact_padding=tier == "2c")


def test_bitwire_kind_matches_jnp():
    for L in range(8, 1024 + 8, 8):
        for W in (10 * L // 8 + 8, bitwire6_width(L), bitwire2q_width(L),
                  bitwire2c_width(L)):
            assert wire_torch.bitwire_kind(W) == stats_jnp.bitwire_kind(W)
            assert wire_torch.bitwire_logical_len(W) == \
                stats_jnp.bitwire_logical_len(W)
    with pytest.raises(ValueError):
        wire_torch.bitwire_kind(13)


def test_2c_without_sidecar_raises():
    W = bitwire2c_width(64)
    with pytest.raises(ValueError, match="sidecar"):
        wire_torch.wire_unbits(torch.zeros((4, W), dtype=torch.uint8))


def test_exception_restore_drops_out_of_range():
    """Sentinels at exactly B*L (the packers' padding) and any other index
    outside [0, B*L) are dropped, as jnp's mode='drop' does; real entries
    restore codes 4 (N) and 5 (OTHER)."""
    codes2 = torch.zeros((2, 8), dtype=torch.uint8)
    n = codes2.numel()
    exc = torch.tensor([(3 << 1) | 0, (9 << 1) | 1, n << 1, n << 1,
                        (n + 40) << 1, -8], dtype=torch.int32)
    out = wire_torch._restore_exceptions(codes2, exc, n)
    want = np.zeros(n, np.uint8)
    want[3], want[9] = 4, 5
    np.testing.assert_array_equal(out.numpy(), want)
    assert out.shape == (n,)


def test_pad_wire_cols_matches_jnp():
    rng = np.random.default_rng(4)
    codes = rng.integers(0, 6, size=(5, 40)).astype(np.int8)
    quals = rng.integers(33, 75, size=(5, 40)).astype(np.uint8)
    for lcap in (40, 128):
        got = wire_torch.pad_wire_cols(_t(codes), _t(quals), lcap)
        want = stats_jnp.pad_wire_cols(codes, quals, lcap)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
            assert g.numpy().dtype == np.asarray(w).dtype


def _compare_acc(acc_t, acc_j):
    host = to_numpy(acc_t)
    for k in INT_KEYS:
        np.testing.assert_array_equal(host[k], np.asarray(acc_j[k]),
                                      err_msg=k)
    np.testing.assert_allclose(float(host["acc_quality"]),
                               float(acc_j["acc_quality"]), rtol=1e-3)


@pytest.mark.parametrize("crit", [None, CRIT], ids=["plain", "filtered"])
def test_step2u_matches_jax(tmp_path, crit):
    blocks = _blocks(tmp_path, n=1200, batch=400, min_len=100, max_len=100,
                     seed=14, qual_bins=(2, 12, 23, 37))
    step_j = stats_jnp.make_stats_step2u(128, 33, False, crit, 100,
                                         engine="pallas_interpret")
    step_t = tstep.make_stats_step2u(128, 33, crit, 100)
    acc_j = stats_jnp.zero_partials(128)
    acc_t = zero_partials(128)
    tstep.WIRE_BATCHES.clear()
    for block in blocks:
        buf, exc, pal, n_valid, Lu = try_pack_block_2u(block,
                                                       pad_reads_to=512)
        acc_j = step_j(acc_j, buf, exc, pal, n_valid)
        acc_t = step_t(acc_t, _t(buf), _t(exc), _t(pal), n_valid)
    assert tstep.WIRE_BATCHES["2u"] == len(blocks) == 3
    _compare_acc(acc_t, acc_j)


@pytest.mark.parametrize("kmers", [False, True], ids=["no-kmers", "kmers"])
@pytest.mark.parametrize("crit", [None, CRIT], ids=["plain", "filtered"])
def test_step2u_routes_by_need(tmp_path, crit, kmers):
    """Without k-mers a 2u batch goes to ``batch_partials_2u`` (K1's 2u
    entry on CUDA; on the CPU its plain version decodes there, outside
    ``unwire``); with k-mers it is decoded by ``unwire`` first, since the
    k-mer pass reads codes.  Either way the step equals JAX's
    ``make_stats_step2u``."""
    blocks = _blocks(tmp_path, n=800, batch=400, min_len=100, max_len=100,
                     seed=15, qual_bins=(2, 12, 23, 37))
    step_j = stats_jnp.make_stats_step2u(128, 33, kmers, crit, 100,
                                         engine="pallas_interpret")
    step_t = tstep.make_stats_step2u(128, 33, crit, 100, kmers_on=kmers)
    acc_j = stats_jnp.zero_partials(128, kmers_on=kmers)
    acc_t = zero_partials(128, kmers_on=kmers)
    tstep.WIRE_BATCHES.clear()
    tstep.DECODED.clear()
    for block in blocks:
        buf, exc, pal, n_valid, Lu = try_pack_block_2u(block,
                                                       pad_reads_to=512)
        acc_j = step_j(acc_j, buf, exc, pal, n_valid)
        acc_t = step_t(acc_t, _t(buf), _t(exc), _t(pal), n_valid)
    assert tstep.WIRE_BATCHES["2u"] == len(blocks) == 2
    assert tstep.DECODED[("cpu", "2u")] == (len(blocks) if kmers else 0)
    _compare_acc(acc_t, acc_j)
    if kmers:
        for k in ("kmer_counts", "kmer_per_nt"):
            np.testing.assert_array_equal(acc_t[k].numpy(),
                                          np.asarray(acc_j[k]), err_msg=k)


def test_step2u_past_k1_lcap_decodes(tmp_path):
    """A session grown past K1's 4096 columns (an earlier long-read block)
    still takes 2u batches: they are decoded for K2, which takes tensors,
    and give the same sums as the step at lcap 128."""
    blocks = _blocks(tmp_path, n=600, batch=300, min_len=100, max_len=100,
                     seed=17, qual_bins=(2, 12, 23, 37))
    acc = {128: zero_partials(128), 4224: zero_partials(4224)}
    tstep.DECODED.clear()
    for block in blocks:
        buf, exc, pal, n_valid, _ = try_pack_block_2u(block, pad_reads_to=512)
        for lcap in acc:
            acc[lcap] = tstep.make_stats_step2u(lcap, 33, CRIT, 100)(
                acc[lcap], _t(buf), _t(exc), _t(pal), n_valid)
    assert tstep.DECODED[("cpu", "2u")] == len(blocks) == 2  # lcap 4224 only
    short, wide = acc[128], acc[4224]
    for k in INT_KEYS:
        w = wide[k].numpy()
        if k in ("cov_per_nt", "qual_per_nt", "base_per_nt", "length_hist"):
            assert not w[..., 129:].any(), k
            w = w[..., :short[k].shape[-1]]
        np.testing.assert_array_equal(w, short[k].numpy(), err_msg=k)


@pytest.mark.parametrize("native", [True, False], ids=["native", "numpy"])
def test_2u_exceptions_ascend(tmp_path, native):
    """K1's 2u entry binary-searches each tile's exceptions, so the
    sidecar must come in ascending flat-index order: both packers (the
    native one's per-thread slices, compacted in thread order, and the
    numpy one's row-major nonzero) write it so, sentinels last."""
    from hpgq_torch.io import packer as tpacker
    from hpgq_torch.io.fastq import FastqReader as TReader

    path = tmp_path / "exc.fq"
    make_fastq(str(path), 3000, min_len=100, max_len=100, n_prob=0.03,
               seed=16, qual_bins=(2, 12, 23, 37))
    with TReader(str(path), batch_size=1500) as rd:
        for block in rd:
            if native:
                buf, exc, pal, n_valid, Lu = tpacker.try_pack_block_2u(
                    block, pad_reads_to=2048)
            else:
                buf, exc, pal, n_valid = tpacker.wire_bitpack2u_np(
                    *tpacker.pack_block(block, max_len=104,
                                        pad_reads_to=2048))
            assert n_valid == 1500
            real = exc[exc < (2048 * 104) << 1]
            assert len(real) > 1000  # N positions at 3%
            assert np.all(np.diff(exc.astype(np.int64)) >= 0)


@pytest.mark.parametrize("tier", list(TIERS), ids=list(TIERS))
def test_step_bitpack_matches_jax(tmp_path, tier):
    bins = (2, 12, 23, 37) if tier in ("2c", "2q") else None
    blocks = _blocks(tmp_path, n=1200, batch=400, min_len=41, max_len=127,
                     seed=15, qual_bins=bins)
    step_j = stats_jnp.make_stats_step(128, 33, crit=CRIT,
                                       engine="pallas_interpret",
                                       wire="bitpack", donate=False)
    step_t = tstep.make_stats_step(128, 33, CRIT, wire="bitpack")
    acc_j = stats_jnp.zero_partials(128)
    acc_t = zero_partials(128)
    tstep.WIRE_BATCHES.clear()
    for block in blocks:
        out = pack_block_bitwire_tier(block, 128, TIERS[tier],
                                      pad_reads_to=512)
        args = out if isinstance(out, tuple) else (out,)
        acc_j = step_j(acc_j, *args)
        acc_t = step_t(acc_t, *(_t(a) for a in args))
    assert tstep.WIRE_BATCHES[tier] == len(blocks)
    _compare_acc(acc_t, acc_j)


def test_step_plain_matches_jax(tmp_path):
    blocks = _blocks(tmp_path, n=900, batch=300, min_len=30, max_len=200,
                     seed=16)
    step_j = stats_jnp.make_stats_step(256, 33, crit=CRIT,
                                       engine="pallas_interpret",
                                       donate=False)
    step_t = tstep.make_stats_step(256, 33, CRIT)
    acc_j = stats_jnp.zero_partials(256)
    acc_t = zero_partials(256)
    for block in blocks:
        packed = pack_block(block, max_len=256, pad_reads_to=512)
        acc_j = step_j(acc_j, *packed)
        acc_t = step_t(acc_t, *(_t(a) for a in packed))
    _compare_acc(acc_t, acc_j)


@pytest.mark.parametrize("shape", ["varlen", "fixed", "padded"])
def test_decode_qn8_matches_jnp(tmp_path, shape):
    """The qn8 decoder on ``pack_block_qnwire`` buffers: all four outputs
    equal ``stats_jnp.wire_unqn8``'s (codes 4 at N, 0 elsewhere), and
    quals/lens/valid equal ``pack_block``'s inside each read."""
    from hpgq.io.packer import pack_block_qnwire

    kw = {"varlen": dict(min_len=41, max_len=127),
          "fixed": dict(min_len=100, max_len=100),
          "padded": dict(min_len=5, max_len=60)}[shape]
    rows, L = (1024, 64) if shape == "padded" else (700, 128)
    for block in _blocks(tmp_path, seed=17, **kw):
        buf = pack_block_qnwire(block, L, pad_reads_to=rows)
        assert buf.shape == (rows, L + 8)
        assert wire_torch.qnwire_logical_len(buf.shape[1]) == \
            stats_jnp.qnwire_logical_len(buf.shape[1]) == L
        got = wire_torch.wire_unqn8(_t(buf))
        want = stats_jnp.wire_unqn8(buf)
        for name, g, w in zip(("codes", "quals", "lens", "valid"), got, want):
            assert g.numpy().dtype == np.asarray(w).dtype, name
            np.testing.assert_array_equal(g.numpy(), np.asarray(w),
                                          err_msg=name)
        codes, quals, lens, valid = pack_block(block, max_len=L,
                                               pad_reads_to=rows)
        inside = np.arange(L)[None, :] < lens[:, None]
        np.testing.assert_array_equal(got[2].numpy(), lens)
        np.testing.assert_array_equal(got[3].numpy(), valid)
        np.testing.assert_array_equal(np.where(inside, got[1].numpy(), 0),
                                      np.where(inside, quals, 0))
        np.testing.assert_array_equal(got[0].numpy() == 4,
                                      (codes == 4) & inside)
