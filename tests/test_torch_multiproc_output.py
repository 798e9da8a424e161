"""Two ranks of the port's ``--sharded`` `filter`, `edit`, `prepro` and
`cgr` over gloo on the CPU (mirrors of ``tests/test_multiproc.py``'s
``test_two_process_sharded_output`` and ``..._sharded_cgr``, single-end
and paired): every output file byte-equal to ``hpgq``'s single-process
run, the counts summed, the CGR tables the same on both ranks.  The
harness is ``tests/test_torch_multiproc.py``'s.
"""

import numpy as np
import pytest

from gen import make_fastq

import hpgq.pipeline.cgr_run as hcgr_run
import hpgq.pipeline.run as hrun
from test_torch_multiproc import (
    OUTPUT_CASES,
    assert_same_tree,
    base_opts,
    hpgq_opts,
    run_ranks,
)


@pytest.mark.parametrize("paired", [False, True], ids=["single", "paired"])
@pytest.mark.parametrize("cmd", list(OUTPUT_CASES))
def test_two_rank_sharded_output(tmp_path, cmd, paired):
    """Per-rank shards in a shared output dir, concatenated by rank 0 in
    rank order: every file byte-equal to ``hpgq``'s single-process output,
    the counts summed, no shard left."""
    inputs = [str(tmp_path / "a.fq"), str(tmp_path / "b.fq")][:1 + paired]
    for i, p in enumerate(inputs):
        make_fastq(p, 2400, min_len=40, max_len=110, n_prob=0.02,
                   seed=31 + i)
    extra = {"filter_on": True} if cmd == "edit" else {}
    if cmd == "prepro":
        extra = dict(ltrim_nts=5, rtrim_nts=3, min_quality=27,
                     max_quality=64)
    opts = base_opts(inputs, tmp_path / "out", **extra)
    results = run_ranks(tmp_path, "o", cmd, opts, OUTPUT_CASES[cmd])
    ref = dict(opts, out_dirname=str(tmp_path / "ref"), batch_size=512)
    runner = hrun.run_filter if cmd == "filter" else hrun.run_edit
    want = runner(hpgq_opts(cmd, ref, OUTPUT_CASES[cmd]))
    for res in results:
        for k in ("num_passed", "num_failed", "num_edited"):
            assert res.get(k, 0) == want.get(k, 0), (k, res, want)
    assert_same_tree(opts["out_dirname"], ref["out_dirname"])


@pytest.mark.parametrize("paired", [False, True], ids=["single", "paired"])
def test_two_rank_sharded_cgr(tmp_path, paired):
    """Both ranks hold the summed tables and word count; rank 0's PGM and
    ``.gs`` files equal ``hpgq``'s single-process ones."""
    inputs = [str(tmp_path / "c.fq"), str(tmp_path / "d.fq")][:1 + paired]
    for i, p in enumerate(inputs):
        make_fastq(p, 2000, min_len=40, max_len=110, n_prob=0.02,
                   seed=23 + i)
    opts = base_opts(inputs, tmp_path / "out", k=4, write_gs=True)
    results = run_ranks(tmp_path, "c", "cgr", opts)
    ref = dict(opts, out_dirname=str(tmp_path / "ref"), batch_size=512)
    want = hcgr_run.run_cgr(hpgq_opts("cgr", ref))
    for res in results:
        ts, tq, words = res["tables"]
        np.testing.assert_array_equal(ts, want["table_seq"])
        np.testing.assert_array_equal(tq, want["table_q"])
        assert words == want["fq_word_count"]
    assert_same_tree(opts["out_dirname"], ref["out_dirname"])
