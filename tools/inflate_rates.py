"""Host-side rates of the port's gzip reader on the benchmark's text.

Draws the text of a cell's file from its seed with the benchmark's own
generator (``benchmark/traffic``), writes it as three single-member gzip
files at the cell's level, and reads each whole with the one-thread
decoder and with the parallel one (``hpgq_torch.io.native.inflate``):

- ``pieces``: the generator's file, pieces deflated independently, each
  ended by a sync flush (no match crosses a piece);
- ``flush_free``: one deflate stream, no flush;
- ``primed``: pigz's layout, 128 KiB pieces each primed with the 32 KB
  before it and ended by a sync flush.

Every read is held to the text byte for byte.  One JSON line a file and
decoder: the seconds of each read, the median rate of text, and the
parallel reader's counts (``inflate-chunks``, ``inflate-markers``,
``inflate-restarts``) of one read, which is one pass of the cell.

    python3 tools/inflate_rates.py --cell se100_gz_stats_filter --reps 5
    python3 tools/inflate_rates.py --cell ont_chunk_gz_stats_filter --reads 4000

Files go to a private temporary directory, removed at the end.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import json
import os
import statistics
import sys
import tempfile
import time
import zlib

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from hpgq_torch.io.native import inflate  # noqa: E402

PIGZ_PIECE = 128 << 10  # pigz's default block
GZ_HEAD = b"\x1f\x8b\x08\x00\x00\x00\x00\x00\x00\xff"


def _cell(name: str) -> "tuple[dict, dict, object]":
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        spec = json.load(f)
    cell = next(w for w in spec["workloads"] if w["name"] == name)
    conf = next(c for c in spec["configs"] if c["name"] == cell["config"])
    with open(os.path.join(ROOT, conf["file"])) as f:
        config = json.load(f)
    with open(os.path.join(ROOT, "benchmark", "traffic", cell["traffic"] + ".json")) as f:
        traffic = json.load(f)
    module = traffic.get("generator", "generate")
    gen = __import__("benchmark.traffic." + module, fromlist=["make_corpus"])
    return config, traffic, gen


def _trailer(text: bytes) -> bytes:
    return (zlib.crc32(text) & 0xFFFFFFFF).to_bytes(4, "little") + \
        (len(text) & 0xFFFFFFFF).to_bytes(4, "little")


def flush_free(text: bytes, level: int) -> bytes:
    co = zlib.compressobj(level, zlib.DEFLATED, 31)
    return co.compress(text) + co.flush()


def _primed_piece(args) -> bytes:
    text, at, level, last = args
    zdict = text[max(0, at - 32768):at]
    co = (zlib.compressobj(level, zlib.DEFLATED, -15, zdict=zdict) if zdict
          else zlib.compressobj(level, zlib.DEFLATED, -15))
    piece = text[at:at + PIGZ_PIECE]
    return co.compress(piece) + co.flush(zlib.Z_FINISH if last else zlib.Z_SYNC_FLUSH)


def primed(text: bytes, level: int, threads: int) -> bytes:
    starts = range(0, len(text), PIGZ_PIECE)
    jobs = [(text, at, level, at + PIGZ_PIECE >= len(text)) for at in starts]
    with concurrent.futures.ThreadPoolExecutor(threads) as pool:
        body = b"".join(pool.map(_primed_piece, jobs))
    return GZ_HEAD + body + _trailer(text)


def read_all(lib, path: str, parallel) -> "tuple[float, bytes, dict]":
    t = time.perf_counter()
    r = inflate.GzipReader(lib, path, *parallel)
    parts = []
    while True:
        b = r.read(16 << 20)
        if not b:
            break
        parts.append(b)
    counts = r.take_counts()
    r.close()
    return time.perf_counter() - t, b"".join(parts), counts


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cell", default="se100_gz_stats_filter")
    ap.add_argument("--seed", type=int, default=2**31 + 4321)
    ap.add_argument("--reads", type=int, default=0,
                    help="reads_per_file for the draw (default: the configuration's)")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--files", default="pieces,flush_free,primed")
    ap.add_argument("--out", default="", help="also append the lines to this file")
    args = ap.parse_args(argv)
    lib = inflate.get_lib()
    if lib is None:
        print("the native decoder is not built", file=sys.stderr)
        return 1
    config, traffic, gen = _cell(args.cell)
    if args.reads:
        config = dict(config, reads_per_file=args.reads)
    level = int(traffic["gzip_level"])
    cores = len(os.sched_getaffinity(0))
    lines = []
    with tempfile.TemporaryDirectory() as d:
        corpus = gen.make_corpus(config, traffic, args.seed, d)
        with open(corpus.path, "rb") as f:
            files = {"pieces": f.read()}
        _, text, _ = read_all(lib, corpus.path, (0, 0))
        names = args.files.split(",")
        if "flush_free" in names:
            files["flush_free"] = flush_free(text, level)
        if "primed" in names:
            files["primed"] = primed(text, level, min(8, cores))
        plan = inflate._workers(corpus.path)
        for name in names:
            path = os.path.join(d, name + ".gz")
            with open(path, "wb") as f:
                f.write(files[name])
            nworkers = inflate._workers(path) or max(2, cores // 2)
            for decoder, par in (("one_thread", (0, 0)),
                                 ("parallel", (nworkers, inflate.CHUNK_BYTES))):
                secs, counts = [], {}
                for _ in range(args.reps):
                    s, got, counts = read_all(lib, path, par)
                    if got != text:
                        print("MISMATCH", name, decoder, file=sys.stderr)
                        return 1
                    secs.append(s)
                line = {"cell": args.cell, "file": name, "decoder": decoder,
                        "workers": par[0], "cores": cores,
                        "engages_by_itself": bool(plan) if name == "pieces" else None,
                        "gz_bytes": len(files[name]), "text_bytes": len(text),
                        "seconds": [round(x, 4) for x in secs],
                        "text_MB_per_s": round(len(text) / statistics.median(secs) / 1e6, 1),
                        "counts_per_pass": counts}
                lines.append(line)
                print(json.dumps(line), flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "a") as f:
            for line in lines:
                f.write(json.dumps(line) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
