"""The port's own copy of ``hpgq/utils/checkpoint.py`` (the port imports nothing of
``hpgq``); the same
format, so either package resumes the other's checkpoints.

Checkpoint / resume for streaming runs.

The reference has no checkpointing (single streaming pass; SURVEY §5) — for
multi-GB multi-host runs the new framework persists, per host shard, the
exact restart state: the int64 counter snapshot plus the input's logical
byte offset.  Resume = load counters, seek the reader, continue; merging is
associative so the result is identical to an uninterrupted run
(tests/test_checkpoint.py proves equality).

Format: a single .npz (atomic tmp+rename) holding the counters' arrays,
scalars, and a JSON meta blob (command config fingerprint — a resume with a
different config is refused).
"""

from __future__ import annotations

import json
import os
import tempfile
from typing import Optional

import numpy as np

from ..core.counters import StatsCounters

FORMAT_VERSION = 1

_SCALARS = (
    "num_reads", "num_passed", "num_failed", "acc_length", "min_length",
    "max_length", "acc_quality", "num_As", "num_Cs", "num_Gs", "num_Ts",
    "num_Ns", "phred",
)
_ARRAYS = (
    "length_hist", "quality_hist", "gc_hist", "count_quality_per_nt",
    "acc_quality_per_nt", "base_per_nt", "kmer_counts", "kmer_counts_by_pos",
)


def save_counters_checkpoint(
    path: str,
    counters: Optional[StatsCounters],
    offset: int,
    config_key: str,
    extra: Optional[dict] = None,
    counters2: Optional[StatsCounters] = None,
) -> str:
    """Atomically persist counters + input offset (+ arbitrary extra arrays).

    ``counters`` may be None for commands whose restart state is only the
    offset + extras (filter/edit: output sizes and pass/fail counts);
    ``counters2`` holds the mate-2 accumulator for paired-end stats."""
    meta = {
        "version": FORMAT_VERSION,
        "offset": int(offset),
        "config_key": config_key,
        "has_counters": counters is not None,
    }
    if counters is not None:
        meta["kmers_on"] = counters.kmers_on
        meta["filter_on"] = counters.filter_on
        meta["scalars"] = {k: _py(getattr(counters, k)) for k in _SCALARS}
    if counters2 is not None:
        meta["kmers_on2"] = counters2.kmers_on
        meta["filter_on2"] = counters2.filter_on
        meta["scalars2"] = {k: _py(getattr(counters2, k)) for k in _SCALARS}
    payload = {
        "__meta__": np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8),
    }
    if counters is not None:
        for k in _ARRAYS:
            v = getattr(counters, k, None)
            if v is not None:
                payload[k] = v
    if counters2 is not None:
        for k in _ARRAYS:
            v = getattr(counters2, k, None)
            if v is not None:
                payload["c2_" + k] = v
    for k, v in (extra or {}).items():
        payload["x_" + k] = np.asarray(v)

    d = os.path.dirname(path) or "."
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".npz.tmp", dir=d)
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, **payload)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return path


def _py(v):
    return v.item() if hasattr(v, "item") else v


def load_counters_checkpoint(path: str, config_key: str):
    """(counters, offset, extra) — None if absent. Raises on config mismatch."""
    if not os.path.exists(path):
        return None
    with np.load(path, allow_pickle=False) as z:
        meta = json.loads(bytes(z["__meta__"].tobytes()).decode())
        if meta.get("version") != FORMAT_VERSION:
            raise ValueError("unsupported checkpoint version in %s" % path)
        if meta["config_key"] != config_key:
            raise ValueError(
                "checkpoint %s was written by a different configuration "
                "(%s != %s); refusing to resume" % (path, meta["config_key"],
                                                    config_key)
            )
        def restore(scalars_key, kmers_key, filter_key, prefix):
            c = StatsCounters(
                phred=int(meta[scalars_key]["phred"]),
                kmers_on=meta[kmers_key],
            )
            c.filter_on = meta[filter_key]
            for k, v in meta[scalars_key].items():
                setattr(c, k, type(getattr(c, k))(v))
            lcap = int(z[prefix + "count_quality_per_nt"].shape[0])
            c.ensure_length(lcap)
            for k in _ARRAYS:
                if prefix + k in z.files:
                    arr = z[prefix + k]
                    cur = getattr(c, k)
                    if cur is None or cur.shape != arr.shape:
                        setattr(c, k, arr.copy())
                    else:
                        cur[...] = arr
            return c

        c = None
        if meta.get("has_counters", True):
            c = restore("scalars", "kmers_on", "filter_on", "")
        extra = {
            k[2:]: z[k].copy() for k in z.files if k.startswith("x_")
        }
        if "scalars2" in meta:
            extra["__counters2__"] = restore(
                "scalars2", "kmers_on2", "filter_on2", "c2_"
            )
    return c, int(meta["offset"]), extra
