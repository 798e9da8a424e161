"""``tests/test_property.py``'s property-based cases (hypothesis) on the
port's own copies: record-block parsing over adversarial FASTQ shapes
(``hpgq_torch.io.fastq``), packer invariants (``hpgq_torch.io.packer``),
and wire round-trips through the port's decoders
(``hpgq_torch.kernels.wire_torch``), each decode also held against
``hpgq``'s ``stats_jnp`` decoder on the same buffer.  The fused4 wire's
round-trip stays out (that wire is not ported).
"""

import numpy as np
import torch
from hypothesis import given, settings, strategies as st

from hpgq.kernels import stats_jnp
from hpgq_torch.io.fastq import FastqReader
from hpgq_torch.io.packer import (
    pack_block,
    round_up,
    wire_bitpack_np,
    wire_qn8_np,
)
from hpgq_torch.kernels.wire_torch import wire_unbits, wire_unqn8

SEQ_ALPHABET = b"ACGTNacgtnRYKM"  # includes ambiguity codes -> BASE_OTHER
QUAL_MIN, QUAL_MAX = 33, 126


@st.composite
def fastq_records(draw, max_records=12, max_len=200):
    n = draw(st.integers(1, max_records))
    recs = []
    for i in range(n):
        ln = draw(st.integers(1, max_len))
        seq = bytes(
            draw(st.lists(st.sampled_from(list(SEQ_ALPHABET)),
                          min_size=ln, max_size=ln))
        )
        qual = bytes(
            draw(st.lists(st.integers(QUAL_MIN, QUAL_MAX),
                          min_size=ln, max_size=ln))
        )
        recs.append((b"@r%d some description" % i, seq, qual))
    return recs


def _write(recs, crlf=False, final_newline=True) -> bytes:
    eol = b"\r\n" if crlf else b"\n"
    out = bytearray()
    for hdr, seq, qual in recs:
        out += hdr + eol + seq + eol + b"+" + eol + qual + eol
    if not final_newline and out:
        del out[-(2 if crlf else 1):]
    return bytes(out)


@settings(max_examples=60, deadline=None)
@given(recs=fastq_records(), crlf=st.booleans(), final_newline=st.booleans(),
       batch=st.integers(1, 7))
def test_reader_parses_any_record_shape(tmp_path_factory, recs, crlf,
                                        final_newline, batch):
    path = str(tmp_path_factory.mktemp("prop") / "p.fq")
    with open(path, "wb") as f:
        f.write(_write(recs, crlf, final_newline))
    got = []
    with FastqReader(path, batch_size=batch) as rd:
        for block in rd:
            for i in range(block.num_reads):
                got.append((block.sequence(i), block.quality(i)))
    assert got == [(s, q) for _, s, q in recs]


@settings(max_examples=60, deadline=None)
@given(recs=fastq_records(), pad=st.sampled_from([0, 16, 64]))
def test_pack_invariants(tmp_path_factory, recs, pad):
    path = str(tmp_path_factory.mktemp("prop") / "p.fq")
    with open(path, "wb") as f:
        f.write(_write(recs))
    with FastqReader(path, batch_size=10**9) as rd:
        (block,) = list(rd)
    L = round_up(max(len(s) for _, s, _ in recs), 128)
    codes, quals, lens, valid = pack_block(block, max_len=L, pad_reads_to=pad)
    n = len(recs)
    assert (lens[:n] == [len(s) for _, s, _ in recs]).all()
    assert valid[:n].all() and not valid[n:].any()
    # quality bytes are raw ASCII within each read, zero beyond
    for i, (_, s, q) in enumerate(recs):
        np.testing.assert_array_equal(
            np.asarray(quals[i, : len(q)]), np.frombuffer(q, np.uint8)
        )
        assert (np.asarray(quals[i, len(q):]) == 0).all()
        assert (np.asarray(codes[i, len(s):]) == 5).all()
        # codes in 0..5 always
        assert ((codes[i] >= 0) & (codes[i] <= 5)).all()


def _decoded(decode, jnp_decode, buf):
    """The port's decode of ``buf`` as numpy, equal to ``hpgq``'s."""
    got = [x.numpy() for x in decode(torch.from_numpy(buf))]
    for g, w in zip(got, jnp_decode(buf)):
        np.testing.assert_array_equal(g, np.asarray(w))
    return got


@settings(max_examples=60, deadline=None)
@given(data=st.data())
def test_wire_roundtrips(data):
    B = data.draw(st.integers(1, 24))
    L = data.draw(st.sampled_from([8, 16, 64, 128, 256]))
    rng = np.random.default_rng(data.draw(st.integers(0, 2**31)))
    lens = rng.integers(0, L + 1, size=B).astype(np.int32)
    pos = np.arange(L)[None, :]
    codes = np.where(pos < lens[:, None],
                     rng.integers(0, 6, size=(B, L)), 5).astype(np.int8)
    quals = np.where(pos < lens[:, None],
                     rng.integers(0, 128, size=(B, L)), 0).astype(np.uint8)
    valid = rng.random(B) < 0.8

    # bitpack: decode(encode(x)) == x for valid rows, zeros elsewhere
    c2, q2, l2, v2 = _decoded(wire_unbits, stats_jnp.wire_unbits,
                              wire_bitpack_np(codes, quals, lens, valid))
    np.testing.assert_array_equal(v2, valid)
    np.testing.assert_array_equal(l2, np.where(valid, lens, 0))
    np.testing.assert_array_equal(c2, np.where(valid[:, None], codes & 7, 0))
    np.testing.assert_array_equal(q2, np.where(valid[:, None], quals & 0x7F, 0))

    # qn8: quals + is-N survive; codes collapse to the N indicator
    c4, q4, l4, v4 = _decoded(wire_unqn8, stats_jnp.wire_unqn8,
                              wire_qn8_np(codes, quals, lens, valid))
    np.testing.assert_array_equal(v4, valid)
    np.testing.assert_array_equal(l4, np.where(valid, lens, 0))
    np.testing.assert_array_equal(q4, np.where(valid[:, None], quals & 0x7F, 0))
    np.testing.assert_array_equal(
        c4, np.where(valid[:, None], (codes == 4) * np.int8(4), 0))
