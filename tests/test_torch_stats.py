"""The port's K1 contract (plain twin on the CPU) against the JAX engine.

``hpgq_torch.kernels.stats_cuda.make_batch_partials`` runs the plain twin
for CPU tensors; it is held against the Pallas kernel K1 in interpret mode
and against ``stats_jnp.batch_partials`` + ``verdicts`` on the same numpy
inputs (the cases of ``tests/test_pallas.py``).  Integer fields match
exactly; the f32 ``acc_quality`` to 1e-3 relative, the tolerance
``test_pallas.py`` uses, because f32 sums taken in another order differ in
the last bits.  The CUDA kernel itself is checked on the card by
``chip_smoke.py``, which imports no jax.
"""

import dataclasses

import numpy as np
import pytest
import torch

from hpgq.constants import PHRED33
from hpgq.kernels import stats_jnp
from hpgq.kernels.stats_pallas import TB, batch_partials_pallas
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


def _port(codes, quals, lens, valid, lcap, crit):
    fn = make_batch_partials(lcap, PHRED33, crit)
    return fn(*(torch.from_numpy(np.ascontiguousarray(a))
                for a in (codes, quals, lens, valid)))


def _compare(want, got, n_sel):
    for k in INT_KEYS:
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
