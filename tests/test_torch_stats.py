"""The port's K1/K2 contract (plain twin on the CPU) against the JAX engine.

``hpgq_torch.kernels.stats_cuda.make_batch_partials`` runs the plain twin
for CPU tensors; it is held against the Pallas kernels K1 and K2 in
interpret mode and against ``stats_jnp.batch_partials`` + ``verdicts`` on
the same numpy inputs (the cases of ``tests/test_pallas.py``), with and
without the k-mer ride-along.  Integer fields match
exactly; the f32 ``acc_quality`` to 1e-3 relative, the tolerance
``test_pallas.py`` uses, because f32 sums taken in another order differ in
the last bits.  The CUDA kernels themselves are checked on the card by
``chip_smoke.py``, which imports no jax.
"""

import dataclasses

import numpy as np
import pytest
import torch

from hpgq.constants import PHRED33
from hpgq.kernels import stats_jnp, stats_pallas
from hpgq.kernels.stats_pallas import (
    TB,
    batch_partials_pallas,
    batch_partials_pallas_long,
)
from hpgq.options import FilterCriteria
from hpgq_torch.core.accumulator import from_jax_partials, to_numpy
from hpgq_torch.kernels import build, stats_cuda, stats_torch
from hpgq_torch.kernels.stats_cuda import make_batch_partials

torch.set_num_threads(2)

CRIT = FilterCriteria(
    min_read_length=10, max_read_length=100,
    min_read_quality=5, max_read_quality=45,
    left_length=8, min_left_quality=10, max_left_quality=60,
    right_length=8, min_right_quality=10, max_right_quality=60,
    max_out_of_quality=30, max_N=3,
)
CRITS = {
    "plain": None,
    "filtered": CRIT,
    # [D8] legacy quality position window: screens see [12, 60) only
    "qwindow": dataclasses.replace(CRIT, begin_quality_nt=12,
                                   end_quality_nt=60),
    # left and right windows alone (every other threshold unset)
    "windows": FilterCriteria(left_length=6, min_left_quality=20,
                              max_left_quality=40, right_length=10,
                              min_right_quality=15),
    "bench": FilterCriteria(min_read_length=50, max_read_length=200,
                            min_read_quality=20, max_read_quality=60,
                            max_N=2),
}
INT_KEYS = (
    "num_reads", "acc_length", "min_length", "max_length", "base_totals",
    "length_hist", "quality_hist", "gc_hist", "cov_per_nt", "qual_per_nt",
    "base_per_nt",
)
KMER_KEYS = ("kmer_counts", "kmer_per_nt")
# a long-read filter: every check at once, with a quality window
LONG_CRIT = FilterCriteria(
    min_read_length=500, max_read_length=7000,
    min_read_quality=20, max_read_quality=40,
    left_length=50, min_left_quality=15, max_left_quality=60,
    right_length=80, min_right_quality=15,
    max_out_of_quality=4000, max_N=150,
    begin_quality_nt=100, end_quality_nt=5000,
)


def _rand_batch(B, L, seed=0, with_n=True, varlen=True):
    rng = np.random.default_rng(seed)
    lens = (rng.integers(1, L + 1, size=B) if varlen
            else np.full(B, L)).astype(np.int32)
    codes = rng.integers(0, 4, size=(B, L)).astype(np.int8)
    if with_n:
        codes[rng.random((B, L)) < 0.02] = 4
    pos = np.arange(L)[None, :]
    codes = np.where(pos < lens[:, None], codes, np.int8(5))
    quals = np.where(pos < lens[:, None], rng.integers(33, 74, size=(B, L)),
                     0).astype(np.uint8)
    valid = rng.random(B) < 0.9
    return codes, quals, lens, valid


def _port(codes, quals, lens, valid, lcap, crit, kmers_on=False):
    fn = make_batch_partials(lcap, PHRED33, crit, kmers_on)
    return fn(*(torch.from_numpy(np.ascontiguousarray(a))
                for a in (codes, quals, lens, valid)))


def _compare(want, got, n_sel, keys=INT_KEYS):
    for k in keys:
        np.testing.assert_array_equal(np.asarray(want[k]),
                                      got[k].numpy(), err_msg=k)
    if n_sel:
        np.testing.assert_allclose(float(got["acc_quality"]),
                                   float(want["acc_quality"]), rtol=1e-3)


@pytest.mark.parametrize("crit", list(CRITS.values()), ids=list(CRITS))
@pytest.mark.parametrize("B,L", [(TB, 128), (TB * 3, 128), (100, 256)])
def test_partials_match_pallas_and_jnp(B, L, crit):
    lcap = max(L, 128)
    codes, quals, lens, valid = _rand_batch(B, L, seed=B + L)
    got = _port(codes, quals, lens, valid, lcap, crit)
    if crit is not None:
        ok = np.asarray(stats_jnp.verdicts(codes, quals, lens, crit, PHRED33))
        sel = valid & ok
        assert int(got["_num_passed"]) == int(sel.sum())
        assert int(got["_num_failed"]) == int((valid & ~ok).sum())
    else:
        sel = valid
    np.testing.assert_array_equal(got["_passed_mask"].numpy(), sel)
    p_jnp = stats_jnp.batch_partials(codes, quals, lens, sel, lcap, PHRED33)
    _compare(p_jnp, got, int(sel.sum()))
    p_pal = batch_partials_pallas(codes, quals, lens, valid, lcap, PHRED33,
                                  crit, interpret=True)
    _compare(p_pal, got, int(sel.sum()))
    if crit is not None:
        assert int(p_pal["_num_passed"]) == int(got["_num_passed"])
        assert int(p_pal["_num_failed"]) == int(got["_num_failed"])


def test_all_invalid_rows():
    codes, quals, lens, _ = _rand_batch(TB, 128, seed=3)
    valid = np.zeros(TB, dtype=bool)
    p = _port(codes, quals, lens, valid, 128, None)
    assert int(p["num_reads"]) == 0
    assert int(p["max_length"]) == 0
    assert int(p["min_length"]) == stats_torch.MIN_LENGTH_INIT
    assert int(p["length_hist"].sum()) == 0
    ref = batch_partials_pallas(codes, quals, lens, valid, 128, PHRED33,
                                None, interpret=True)
    _compare(ref, p, 0)


def test_lcap_larger_than_l():
    codes, quals, lens, valid = _rand_batch(64, 128, seed=5)
    lcap = 384
    got = _port(codes, quals, lens, valid, lcap, None)
    _compare(stats_jnp.batch_partials(codes, quals, lens, valid, lcap,
                                      PHRED33), got, int(valid.sum()))
    _compare(batch_partials_pallas(codes, quals, lens, valid, lcap, PHRED33,
                                   None, interpret=True), got,
             int(valid.sum()))


def test_zero_length_and_empty_batch():
    """Length-0 rows take no GC key and no quality mean; an empty batch
    leaves every field at its zero/INIT value."""
    codes, quals, lens, valid = _rand_batch(50, 128, seed=8)
    lens[:7] = 0
    valid[:7] = True
    got = _port(codes, quals, lens, valid, 128, CRIT)
    ok = np.asarray(stats_jnp.verdicts(codes, quals, lens, CRIT, PHRED33))
    sel = valid & ok
    _compare(stats_jnp.batch_partials(codes, quals, lens, sel, 128, PHRED33),
             got, int(sel.sum()))
    empty = _port(codes[:0], quals[:0], lens[:0], valid[:0], 128, None)
    assert int(empty["num_reads"]) == 0
    assert int(empty["min_length"]) == stats_torch.MIN_LENGTH_INIT


@pytest.mark.parametrize("crit", [None, CRIT], ids=["plain", "filtered"])
def test_merge_into_matches_jnp(crit):
    """Several batches merged (with the Kahan step) into int64 state equal
    the jnp merge of the same partials."""
    acc_t = stats_torch.zero_partials(128)
    acc_j = stats_jnp.zero_partials(128)
    for s in range(4):
        codes, quals, lens, valid = _rand_batch(300, 128, seed=40 + s)
        p = _port(codes, quals, lens, valid, 128, crit)
        sel = p.pop("_passed_mask").numpy()
        p.pop("_num_passed", None)
        p.pop("_num_failed", None)
        stats_torch.merge_into(acc_t, p)
        acc_j = stats_jnp.merge_into(acc_j, stats_jnp.batch_partials(
            codes, quals, lens, sel, 128, PHRED33))
    for k in INT_KEYS:
        np.testing.assert_array_equal(np.asarray(acc_j[k]),
                                      acc_t[k].numpy(), err_msg=k)
        assert acc_t[k].dtype == torch.int64
    np.testing.assert_allclose(float(acc_t["acc_quality"]),
                               float(acc_j["acc_quality"]), rtol=1e-6)


@pytest.mark.parametrize("kmers_acc,kmers_p,drop,error", [
    (True, False, None, AssertionError),  # k-mer state, k-mer-less batch
    (False, False, "cov_per_nt", KeyError),  # a fixed field missing
    (False, True, None, None),  # k-mer fields without k-mer state: unused
], ids=["kmers-missing", "field-missing", "kmers-unused"])
def test_merge_into_field_mismatch(kmers_acc, kmers_p, drop, error):
    """merge_into drops no field silently: partials that lack a field the
    accumulator keeps raise."""
    codes, quals, lens, valid = _rand_batch(50, 128, seed=49)
    p = _port(codes, quals, lens, valid, 128, None, kmers_on=kmers_p)
    p.pop("_passed_mask")
    if drop:
        del p[drop]
    acc = stats_torch.zero_partials(128, kmers_on=kmers_acc)
    if error is None:
        stats_torch.merge_into(acc, p)
        assert int(acc["num_reads"]) == int(valid.sum())
    else:
        with pytest.raises(error):
            stats_torch.merge_into(acc, p)


def test_carry_state_from_jax():
    """State carried across: half the batches through the JAX step, the
    partials handed over with from_jax_partials, the rest through the
    port's step — equal to the all-JAX run; to_numpy hands it back."""
    from hpgq_torch.kernels.step import make_stats_step

    batches = [_rand_batch(TB, 128, seed=60 + s) for s in range(4)]
    step_j = stats_jnp.make_stats_step(128, PHRED33, crit=CRIT, jit=False,
                                       engine="pallas_interpret")
    acc_j = stats_jnp.zero_partials(128)
    for b in batches[:2]:
        acc_j = step_j(acc_j, *b)
    acc_t = from_jax_partials({k: np.asarray(v) for k, v in acc_j.items()},
                              "cpu")
    step_t = make_stats_step(128, PHRED33, CRIT)
    for b in batches[2:]:
        acc_t = step_t(acc_t, *(torch.from_numpy(a) for a in b))
        acc_j = step_j(acc_j, *b)
    host = to_numpy(acc_t)
    for k in INT_KEYS + ("num_passed", "num_failed"):
        np.testing.assert_array_equal(np.asarray(acc_j[k]), host[k],
                                      err_msg=k)
    np.testing.assert_allclose(float(host["acc_quality"]),
                               float(acc_j["acc_quality"]), rtol=1e-3)


def test_dispatch_is_by_device_with_no_fallback():
    """CPU tensors take the plain twin; the kernel wrapper refuses CPU
    tensors instead of computing on them, and K1 refuses lcap > 4096 (K2)."""
    codes, quals, lens, valid = (torch.from_numpy(a) for a in
                                 _rand_batch(32, 128, seed=2))
    before = stats_cuda.LAUNCHES
    make_batch_partials(128, PHRED33)(codes, quals, lens, valid)
    assert stats_cuda.LAUNCHES == before  # plain twin: no launch counted
    with pytest.raises(ValueError, match="CUDA tensors"):
        stats_cuda.batch_partials_cuda(codes, quals, lens, valid, 128,
                                       PHRED33)
    with pytest.raises(ValueError, match="no stats kernel"):
        make_batch_partials(128, PHRED33)(codes.to("meta"), quals, lens,
                                          valid)


def test_long_lcap_plain_twin_matches_jnp():
    """The plain twin has no lcap limit (K1's 4096 is a kernel limit)."""
    codes, quals, lens, valid = _rand_batch(16, 4608, seed=12)
    got = _port(codes, quals, lens, valid, 4608, CRIT)
    ok = np.asarray(stats_jnp.verdicts(codes, quals, lens, CRIT, PHRED33))
    sel = valid & ok
    _compare(stats_jnp.batch_partials(codes, quals, lens, sel, 4608,
                                      PHRED33), got, int(sel.sum()))


def test_crit_struct_substitutes_sentinels():
    """The kernel's criteria argument: unset thresholds arrive substituted
    (MIN 0 / MAX 100000) with the optional checks flagged off."""
    off = stats_cuda.crit_struct(None, 33)
    assert (off.on, off.phred) == (0, 33)
    c = stats_cuda.crit_struct(CRITS["bench"], 64)
    assert (c.on, c.min_len, c.max_len, c.min_q, c.max_q) == (1, 50, 200, 20,
                                                               60)
    assert (c.oq_on, c.qwin_on, c.left_len, c.right_len) == (0, 0, 0, 0)
    assert (c.max_n, c.phred) == (2, 64)
    w = stats_cuda.crit_struct(CRITS["qwindow"], 33)
    assert (w.oq_on, w.max_oq, w.qwin_on, w.begin, w.end) == (1, 30, 1, 12,
                                                              60)
    assert (w.left_len, w.min_lq, w.max_lq) == (8, 10, 60)
    assert (w.right_len, w.min_rq, w.max_rq) == (8, 10, 60)


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(build, "NVCC_FALLBACK", str(tmp_path / "nvcc"))
    monkeypatch.setattr(build, "BUILD_DIR", str(tmp_path / "build"))
    with pytest.raises(build.KernelBuildError, match="nvcc not found"):
        build.build()


def test_build_raises_when_nvcc_fails(monkeypatch, tmp_path):
    fake = tmp_path / "nvcc"
    fake.write_text("#!/bin/sh\necho 'error: no such target' >&2\nexit 3\n")
    fake.chmod(0o755)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "none"))
    monkeypatch.setattr(build, "nvcc_path", lambda: str(fake))
    monkeypatch.setattr(build, "BUILD_DIR", str(tmp_path / "build"))
    with pytest.raises(build.KernelBuildError, match="no such target"):
        build.build()
    # nothing half-built is left behind to be loaded later
    assert not list((tmp_path / "build").rglob("*.so"))


@pytest.mark.parametrize("crit", [None, CRIT, LONG_CRIT],
                         ids=["plain", "filtered", "long"])
@pytest.mark.parametrize("B,L,lcap", [
    (TB, 4608, 4608),      # just past K1's limit
    (100, 8192, 8192),     # rows not a multiple of a tile
    (64, 4608, 8192),      # lcap wider than the batch L
])
def test_long_partials_match_pallas_and_jnp(B, L, lcap, crit):
    """The K2 contract's plain twin against the blockwise Pallas kernel
    (interpret mode) and against jnp, at test_pallas.py's long shapes."""
    codes, quals, lens, valid = _rand_batch(B, L, seed=B + L)
    lens[:3] = 0  # length-0 rows take no GC key
    got = _port(codes, quals, lens, valid, lcap, crit)
    if crit is not None:
        ok = np.asarray(stats_jnp.verdicts(codes, quals, lens, crit, PHRED33))
        sel = valid & ok
        assert int(got["_num_passed"]) == int(sel.sum())
        assert int(got["_num_failed"]) == int((valid & ~ok).sum())
    else:
        sel = valid
    np.testing.assert_array_equal(got["_passed_mask"].numpy(), sel)
    _compare(stats_jnp.batch_partials(codes, quals, lens, sel, lcap, PHRED33),
             got, int(sel.sum()))
    p_pal = batch_partials_pallas_long(codes, quals, lens, valid, lcap,
                                       PHRED33, crit, interpret=True)
    np.testing.assert_array_equal(np.asarray(p_pal["_passed_mask"]), sel)
    _compare(p_pal, got, int(sel.sum()))


def test_long_max_sentinel_no_overflow():
    """Reads of 24576 with only a minimum quality set: the substituted MAX
    sentinel (100000) times the length passes int32, and every valid read
    must pass, as in the blockwise Pallas kernel."""
    B, L = 32, 24576
    crit = FilterCriteria(min_read_quality=5)
    rng = np.random.default_rng(77)
    lens = np.full(B, L, np.int32)
    codes = rng.integers(0, 4, size=(B, L)).astype(np.int8)
    quals = rng.integers(40, 70, size=(B, L)).astype(np.uint8)
    valid = rng.random(B) < 0.9
    got = _port(codes, quals, lens, valid, L, crit)
    assert int(got["_num_passed"]) == int(valid.sum())
    assert int(got["_num_failed"]) == 0
    np.testing.assert_array_equal(got["_passed_mask"].numpy(), valid)
    p_pal = batch_partials_pallas_long(codes, quals, lens, valid, L, PHRED33,
                                       crit, interpret=True)
    np.testing.assert_array_equal(np.asarray(p_pal["_passed_mask"]), valid)
    _compare(p_pal, got, int(valid.sum()))


@pytest.mark.parametrize("crit", [None, LONG_CRIT], ids=["plain", "long"])
def test_long_twin_past_tpu_limit_matches_jnp(crit):
    """lcap 66048, past the Pallas kernel's 65536: the twin (what K2 is
    held against on the card) against jnp, which ``hpgq`` runs there."""
    B, L = 4, 66048
    codes, quals, lens, valid = _rand_batch(B, L, seed=66)
    lens[0], valid[0] = L, True
    got = _port(codes, quals, lens, valid, L, crit, kmers_on=True)
    sel = valid
    if crit is not None:
        sel = valid & np.asarray(stats_jnp.verdicts(codes, quals, lens, crit,
                                                    PHRED33))
    np.testing.assert_array_equal(got["_passed_mask"].numpy(), sel)
    want = stats_jnp.batch_partials(codes, quals, lens, sel, L, PHRED33,
                                    kmers_on=True)
    _compare(want, got, int(sel.sum()), INT_KEYS + KMER_KEYS)


@pytest.mark.parametrize("crit", [None, CRIT], ids=["plain", "filtered"])
@pytest.mark.parametrize("L", [128, 4608])
def test_kmers_ride_along_matches_pallas(L, crit):
    """k-mers on the pass mask of K1's (lcap 128) or K2's (lcap 4608)
    contract against stats_pallas.make_batch_partials(kmers_on=True)."""
    codes, quals, lens, valid = _rand_batch(TB, L, seed=9 + L)
    got = _port(codes, quals, lens, valid, L, crit, kmers_on=True)
    fn = stats_pallas.make_batch_partials(L, PHRED33, True, crit,
                                          interpret=True)
    want = fn(codes, quals, lens, valid)
    _compare(want, got, int(got["_passed_mask"].sum()),
             INT_KEYS + KMER_KEYS)
    assert int(got["kmer_counts"].sum()) > 0
    assert got["kmer_per_nt"].shape == (1024, L)


def test_kmers_narrower_than_a_kmer_are_zero():
    """A batch of width 4 (< k) has no window: zero k-mer tables of lcap
    columns, as jnp gives."""
    codes, quals, lens, valid = _rand_batch(40, 4, seed=4)
    got = _port(codes, quals, lens, valid, 128, None, kmers_on=True)
    want = stats_jnp.batch_partials(codes, quals, lens, valid, 128, PHRED33,
                                    kmers_on=True)
    _compare(want, got, int(valid.sum()), INT_KEYS + KMER_KEYS)
    assert int(got["kmer_counts"].sum()) == 0


@pytest.mark.parametrize("L", [128, 4608])
def test_stats_step_with_kmers_matches_jax(L):
    """make_stats_step(kmers_on=True) over several batches against the JAX
    step with the Pallas engine in interpret mode."""
    from hpgq_torch.kernels.step import make_stats_step

    step_j = stats_jnp.make_stats_step(L, PHRED33, kmers_on=True, crit=CRIT,
                                       jit=False, engine="pallas_interpret")
    step_t = make_stats_step(L, PHRED33, CRIT, kmers_on=True)
    acc_j = stats_jnp.zero_partials(L, kmers_on=True)
    acc_t = stats_torch.zero_partials(L, kmers_on=True)
    for s in range(2):
        b = _rand_batch(TB, L, seed=80 + s)
        acc_j = step_j(acc_j, *b)
        acc_t = step_t(acc_t, *(torch.from_numpy(a) for a in b))
    for k in INT_KEYS + KMER_KEYS + ("num_passed", "num_failed"):
        np.testing.assert_array_equal(np.asarray(acc_j[k]),
                                      acc_t[k].numpy(), err_msg=k)
    np.testing.assert_allclose(float(acc_t["acc_quality"]),
                               float(acc_j["acc_quality"]), rtol=1e-3)


def test_carry_long_kmer_state_from_jax():
    """A JAX accumulator with k-mers at lcap 4608 handed over with
    from_jax_partials, continued by the port's step and folded: equal to
    the all-JAX run, k-mer tables included."""
    from hpgq.core.accumulator import fold_partials as fold_j
    from hpgq.core.counters import StatsCounters
    from hpgq_torch.core.accumulator import fold_partials
    from hpgq_torch.kernels.step import make_stats_step

    L = 4608
    batches = [_rand_batch(TB, L, seed=90 + s) for s in range(3)]
    step_j = stats_jnp.make_stats_step(L, PHRED33, kmers_on=True,
                                       crit=LONG_CRIT, jit=False,
                                       engine="pallas_interpret")
    acc_j = step_j(stats_jnp.zero_partials(L, kmers_on=True), *batches[0])
    acc_t = from_jax_partials({k: np.asarray(v) for k, v in acc_j.items()},
                              "cpu")
    assert acc_t["kmer_per_nt"].dtype == torch.int64
    step_t = make_stats_step(L, PHRED33, LONG_CRIT, kmers_on=True)
    for b in batches[1:]:
        acc_t = step_t(acc_t, *(torch.from_numpy(a) for a in b))
        acc_j = step_j(acc_j, *b)
    got = StatsCounters(phred=PHRED33, kmers_on=True)
    fold_partials(got, to_numpy(acc_t))
    want = StatsCounters(phred=PHRED33, kmers_on=True)
    fold_j(want, {k: np.asarray(v) for k, v in acc_j.items()})
    assert got.num_passed > 0 and got.num_failed > 0
    assert int(got.kmer_counts.sum()) > 0
    assert got.equals(want)
    assert (got.num_passed, got.num_failed) == (want.num_passed,
                                                want.num_failed)


class _CudaTyped:
    """Stands in for a CUDA tensor where only the device is read."""

    device = torch.device("cuda")


def test_dispatch_picks_k1_or_k2_by_lcap(monkeypatch):
    """CUDA-typed inputs go to K1 up to lcap 4096 and to K2 above it, with
    no upper limit; CPU tensors take the plain twin and count no launch."""
    calls = []

    def record(name):
        def fn(codes, quals, lens, valid, lcap, phred, crit=None):
            calls.append((name, lcap))
            return {"_passed_mask": None}
        return fn

    monkeypatch.setattr(stats_cuda, "batch_partials_cuda", record("k1"))
    monkeypatch.setattr(stats_cuda, "batch_partials_cuda_long", record("k2"))
    x = _CudaTyped()
    for lcap in (128, 4096, 4224, 65536, 131072):
        make_batch_partials(lcap, PHRED33, CRIT)(x, x, x, x)
    assert calls == [("k1", 128), ("k1", 4096), ("k2", 4224), ("k2", 65536),
                     ("k2", 131072)]
    before = (stats_cuda.LAUNCHES, stats_cuda.LAUNCHES_K2)
    for lcap in (4096, 4224):
        t = [torch.from_numpy(a) for a in _rand_batch(16, 256, seed=lcap)]
        p = make_batch_partials(lcap, PHRED33, CRIT, kmers_on=True)(*t)
        assert p["kmer_per_nt"].shape == (1024, lcap)
    assert len(calls) == 5
    assert (stats_cuda.LAUNCHES, stats_cuda.LAUNCHES_K2) == before


def test_kernel_wrappers_refuse_what_they_do_not_take():
    t = [torch.from_numpy(a) for a in _rand_batch(16, 256, seed=1)]
    with pytest.raises(ValueError, match="K2 wrapper needs CUDA tensors"):
        stats_cuda.batch_partials_cuda_long(*t, 8192, PHRED33)
    with pytest.raises(ValueError, match="K1 takes lcap <= 4096"):
        stats_cuda.batch_partials_cuda(*t, 4224, PHRED33)


def test_2u_wrapper_refuses_what_it_does_not_take():
    """K1's 2u entry takes only CUDA tensors (no CPU fallback inside the
    wrapper) and only a 2u batch that fits it; ``batch_partials_2u``
    sends CPU tensors to the decode and the plain twin instead."""
    buf = torch.zeros((16, 52), dtype=torch.uint8)
    exc = torch.full((8,), (16 * 104) << 1, dtype=torch.int32)
    pal = torch.tensor([35, 45, 56, 70], dtype=torch.uint8)
    with pytest.raises(ValueError, match="K1 2u wrapper needs CUDA"):
        stats_cuda.batch_partials_cuda_2u(buf, exc, pal, 16, 100, 128,
                                          PHRED33)
    with pytest.raises(ValueError, match="L <= lcap <= 4096"):
        stats_cuda.batch_partials_cuda_2u(buf, exc, pal, 16, 100, 8192,
                                          PHRED33)
    before = stats_cuda.LAUNCHES_2U
    p = stats_cuda.batch_partials_2u(buf, exc, pal, 10, 100, 128, PHRED33)
    assert stats_cuda.LAUNCHES_2U == before
    assert int(p["num_reads"]) == 10 and int(p["acc_length"]) == 1000
    assert p["_passed_mask"].tolist() == [True] * 10 + [False] * 6


@pytest.mark.parametrize("B,lcap,n_f32,extra", [(0, 128, 1, 0),
                                                (300, 4608, 300, 2410)])
def test_kernel_outputs_share_one_zeroed_buffer(B, lcap, n_f32, extra):
    """The wrappers cut every output from one zeroed allocation: the int64
    fields in the partials' shapes, then the f32 slots, then the pass
    mask, none overlapping."""
    out = stats_cuda._Outputs(torch.device("cpu"), lcap, B, n_f32, extra)
    shapes = [t.shape for t in (out.scal, out.lh, out.qh, out.gh, out.cov,
                                out.qpn, out.bpn, out.bt, out.scratch)]
    assert shapes == [(8,), (lcap + 1,), (256,), (101,), (lcap,), (lcap,),
                      (5, lcap), (5,), (extra,)]
    assert out.f32.dtype == torch.float32 and out.f32.shape == (n_f32,)
    assert out.passed.dtype == torch.bool and out.passed.shape == (B,)
    views = [out.scal, out.lh, out.qh, out.gh, out.cov, out.qpn, out.bpn,
             out.bt, out.scratch, out.f32, out.passed]
    spans = sorted((v.data_ptr(), v.data_ptr() + v.numel() * v.element_size())
                   for v in views if v.numel())
    assert all(a[1] <= b[0] for a, b in zip(spans, spans[1:]))
    assert spans[-1][1] - spans[0][0] == (
        8 * (8 + (lcap + 1) + 256 + 101 + 7 * lcap + 5 + extra)
        + 4 * n_f32 + B)
    for v in views:
        v.fill_(1)  # each view writes only its own bytes
    assert int(out.scal.sum()) == 8 and int(out.passed.sum()) == B
    p = out.partials(out.f32[0] if n_f32 else None, out.bt, None)
    assert p["_passed_mask"] is out.passed and "_num_passed" not in p


# ------------------------------------------------------------ paired steps

PAIR_CRITS = {"none": None, "bench": CRITS["bench"],
              "all": CRITS["qwindow"]}  # every check, quality window too
PAIR_MATES = {  # the two mates' corpora for each wire
    "plain": (dict(min_len=41, max_len=127, seed=31),
              dict(min_len=41, max_len=127, seed=32,
                   qual_bins=(2, 12, 23, 37))),
    "bitpack": (dict(min_len=41, max_len=127, seed=33),
                dict(min_len=41, max_len=127, seed=34,
                     qual_bins=(2, 12, 23, 37))),
    # 2u on both mates, of different uniform lengths (L1 != L2)
    "2u": (dict(min_len=100, max_len=100, seed=35,
                qual_bins=(2, 12, 23, 37)),
           dict(min_len=96, max_len=96, seed=36,
                qual_bins=(2, 12, 23, 37))),
}


def _mate_blocks(tmp_path, name, n=1200, batch=400, **kw):
    from gen import make_fastq
    from hpgq.io.fastq import FastqReader

    path = str(tmp_path / name)
    make_fastq(path, n, n_prob=0.02, **kw)
    with FastqReader(path, batch_size=batch) as rd:
        return list(rd)


def _payload(block, wire, lcap, rows=512):
    """One mate's host payload in the port's form (the 2u tuple tagged)."""
    from hpgq.io.packer import (
        pack_block,
        pack_block_wire,
        try_pack_block_2u,
        wire_len,
    )

    if wire == "2u":
        return ("2u",) + try_pack_block_2u(block, pad_reads_to=rows)
    if wire == "bitpack":
        return pack_block_wire(block, "bitpack",
                               wire_len(block.max_len(), lcap),
                               pad_reads_to=rows, allow6=True, allow2c=True)
    return pack_block(block, max_len=lcap, pad_reads_to=rows)


def _on_cpu(payload):
    from hpgq_torch.pipeline.session import to_device

    return to_device((payload,), torch.device("cpu"))[0]


def _compare_pair(acc_j, acc_t, keys):
    host = to_numpy(acc_t)
    for k in keys:
        np.testing.assert_array_equal(np.asarray(acc_j[k]), host[k],
                                      err_msg=k)
    np.testing.assert_allclose(float(host["acc_quality"]),
                               float(acc_j["acc_quality"]), rtol=1e-4)


def _run_pair_steps(batches, lcap, crit, kmers, jax_step, port=None):
    """Batch 0 through ``jax_step``; both accumulators handed over with
    from_jax_partials; the rest through ``jax_step`` and through the
    port's paired step (on the same batches, or on ``port``'s payloads of
    them).  Returns the two (JAX, port) accumulator pairs."""
    from hpgq_torch.kernels.step import make_paired_stats_step

    acc1_j = stats_jnp.zero_partials(lcap, kmers)
    acc2_j = stats_jnp.zero_partials(lcap, kmers)
    acc1_j, acc2_j = jax_step(acc1_j, acc2_j, *batches[0])
    acc1_t, acc2_t = (from_jax_partials({k: np.asarray(v)
                                         for k, v in a.items()}, "cpu")
                      for a in (acc1_j, acc2_j))
    step_t = make_paired_stats_step(lcap, PHRED33, crit, kmers)
    for (in1, in2), (p1, p2) in zip(batches[1:], (port or batches)[1:]):
        acc1_j, acc2_j = jax_step(acc1_j, acc2_j, in1, in2)
        acc1_t, acc2_t = step_t(acc1_t, acc2_t, _on_cpu(p1), _on_cpu(p2))
    return (acc1_j, acc1_t), (acc2_j, acc2_t)


@pytest.mark.parametrize("kmers", [False, True], ids=["nokmers", "kmers"])
@pytest.mark.parametrize("wire", list(PAIR_MATES))
@pytest.mark.parametrize("crit", list(PAIR_CRITS.values()),
                         ids=list(PAIR_CRITS))
def test_paired_step_matches_jax(tmp_path, crit, wire, kmers):
    """The port's paired step against ``stats_jnp.make_paired_stats_step``
    (``make_paired_stats_step2u`` for the 2u wire, mates of 100 and 96 bp)
    with the jnp engine, three batches, state carried over from JAX:
    integers exact (the pair tallies in mate 1's accumulator),
    ``acc_quality`` to 1e-4 relative."""
    from hpgq_torch.kernels import step as tstep

    lcap = 128
    kw1, kw2 = PAIR_MATES[wire]
    pairs = list(zip(_mate_blocks(tmp_path, "m1.fq", **kw1),
                     _mate_blocks(tmp_path, "m2.fq", **kw2)))
    batches = [(_payload(b1, wire, lcap), _payload(b2, wire, lcap))
               for b1, b2 in pairs]
    if wire == "2u":
        step_j = stats_jnp.make_paired_stats_step2u(
            lcap, PHRED33, kmers, crit, 100, 96, engine="jnp", jit=False)

        def jax_step(a1, a2, in1, in2):
            return step_j(a1, a2, *in1[1:5], *in2[1:5])
    else:
        jax_step = stats_jnp.make_paired_stats_step(
            lcap, PHRED33, kmers, crit, jit=False, engine="jnp",
            wire="bitpack" if wire == "bitpack" else None)
    tstep.WIRE_BATCHES.clear()
    (a1j, a1t), (a2j, a2t) = _run_pair_steps(batches, lcap, crit, kmers,
                                             jax_step)
    keys = INT_KEYS + (KMER_KEYS if kmers else ())
    _compare_pair(a1j, a1t, keys + ("num_passed", "num_failed"))
    _compare_pair(a2j, a2t, keys)
    assert sum(tstep.WIRE_BATCHES.values()) == 2 * (len(batches) - 1)
    if wire == "2u":
        assert tstep.WIRE_BATCHES["2u"] == 4
    if crit is not None:
        assert 0 < int(a1t["num_passed"]) < int(a1t["num_passed"]
                                                + a1t["num_failed"])
    assert int(a2t["num_passed"]) == 0  # the tallies live in mate 1 only


def test_paired_step_mixed_tiers_match_plain_jax(tmp_path):
    """Mate 1 on the 2u wire, mate 2 on the adaptive bitpack tiers (the
    mates need not share a tier in the port): equal to the JAX paired step
    on the plain tensors of the same blocks."""
    from hpgq.io.packer import pack_block

    lcap = 128
    crit = CRITS["bench"]
    b1s = _mate_blocks(tmp_path, "m1.fq", min_len=100, max_len=100,
                       seed=37, qual_bins=(2, 12, 23, 37))
    b2s = _mate_blocks(tmp_path, "m2.fq", min_len=41, max_len=127, seed=38)
    plain = [(pack_block(b1, max_len=lcap, pad_reads_to=512),
              pack_block(b2, max_len=lcap, pad_reads_to=512))
             for b1, b2 in zip(b1s, b2s)]
    mixed = [(_payload(b1, "2u", lcap), _payload(b2, "bitpack", lcap))
             for b1, b2 in zip(b1s, b2s)]
    assert all(not isinstance(m2, tuple) or len(m2) == 2 for _, m2 in mixed)
    jax_step = stats_jnp.make_paired_stats_step(lcap, PHRED33, False, crit,
                                                jit=False, engine="jnp")
    (a1j, a1t), (a2j, a2t) = _run_pair_steps(plain, lcap, crit, False,
                                             jax_step, port=mixed)
    _compare_pair(a1j, a1t, INT_KEYS + ("num_passed", "num_failed"))
    _compare_pair(a2j, a2t, INT_KEYS)


def test_paired_step_long_reads_match_jax():
    """lcap 4608 (K2's contract on the CPU twin) with a long-read filter:
    equal to the jnp paired step."""
    lcap = 4608
    batches = []
    for s in range(3):
        m1 = _rand_batch(48, lcap, seed=200 + s)
        m2 = _rand_batch(48, lcap, seed=300 + s)
        batches.append((m1, m2))
    jax_step = stats_jnp.make_paired_stats_step(lcap, PHRED33, False,
                                                LONG_CRIT, jit=False,
                                                engine="jnp")
    (a1j, a1t), (a2j, a2t) = _run_pair_steps(batches, lcap, LONG_CRIT, False,
                                             jax_step)
    _compare_pair(a1j, a1t, INT_KEYS + ("num_passed", "num_failed"))
    _compare_pair(a2j, a2t, INT_KEYS)
    assert int(a1t["num_passed"]) > 0 and int(a1t["num_failed"]) > 0
