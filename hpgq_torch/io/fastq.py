"""The port's own copy of ``hpgq/io/fastq.py`` (the port imports nothing of
``hpgq``); its records, blocks and outputs are ``hpgq``'s.  The readers
also take a pass's stage timers (:mod:`hpgq_torch.utils.timers`): the
gzip inflate and the chunk index are timed on the threads that run them.

FASTQ file handling: streaming record-block reader and writers.

TPU-native replacement for the reference's ``fastq_file`` layer
(``fastq_fopen`` / ``fastq_fread_se`` / ``fastq_fwrite``, call sites
``src/stats_fastq.c:183,425,503``, ``src/filter_fastq.c:114,165-169,186-192``).
Instead of one heap object per read, a :class:`RecordBlock` keeps the raw
bytes of up to ``batch_size`` records plus numpy line-offset arrays; the
packer (``hpgq_torch.io.packer``) turns a block into padded ``[B, L]`` tensors with
zero per-read Python work, and writers re-slice the original bytes so
filter/edit outputs are byte-exact copies of the input records.

Supports plain and gzip inputs (gzip detected by magic, like a
gzip-capable ``fastq_fopen``).
"""

from __future__ import annotations

import gzip
import os
import queue
import threading
from typing import Iterator, Optional

import numpy as np

from ..utils.timers import NO_TIMERS
from . import native
from .native import inflate
from .native.inflate import GzipReader

_CHUNK = 16 * 1024 * 1024


class FastqParseError(ValueError):
    """Structurally invalid FASTQ input (desynced 4-line grouping,
    truncated quality line, missing '@'/'+' markers).  The CLI converts
    this into a clean reference-style ``Error:`` message + exit."""


class ReadaheadFile:
    """Background decode thread over a forward-only file-like (plain gzip).

    The decode need not run on the pipeline's critical path: a daemon
    thread reads ahead into a bounded queue (``depth`` x ``chunk_bytes`` of
    decompressed readahead) while the consumer indexes/packs the previous
    chunks — the native decoder and zlib both release the GIL, so decode
    genuinely overlaps the numpy and native-packer work.  The native
    decoder spreads one member over a pool of threads where the file and
    the cores allow (:class:`~hpgq_torch.io.native.inflate.GzipReader`);
    this thread then waits for its output in order.  This is the
    plain-gzip analog of the BGZF reader's parallel block readahead
    (``hpgq_torch.io.bgzf``) and replaces the reference's in-thread
    ``gzFile`` reads (gzip-capable ``fastq_fopen``, src/stats_fastq.c:425).
    Each piece's read is ``timers``' ``inflate`` stage; the wait for room
    in the queue is not.  Each piece's bytes are counted under the file's
    ``COUNTER`` (``inflate-native-bytes``), or ``inflate-zlib-bytes``, and
    the parallel decoder's counts (``inflate-chunks``, ``inflate-markers``,
    ``inflate-restarts``) beside them."""

    def __init__(self, fh, chunk_bytes: int = _CHUNK, depth: int = 4,
                 timers=NO_TIMERS):
        # chunk_bytes matches the block reader's _CHUNK so that gzip
        # inputs yield the same block sizes as plain files: a gzip file
        # and its plain text give the same batches
        self._fh = fh
        self._timers = timers
        self._counter = getattr(fh, "COUNTER", "inflate-zlib-bytes")
        self._take_counts = getattr(fh, "take_counts", dict)
        self._q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._cur = memoryview(b"")
        self._stop = threading.Event()
        self._eof = False
        self._thread = threading.Thread(
            target=self._fill, args=(chunk_bytes,), daemon=True,
            name="hpgq-gunzip",
        )
        self._thread.start()

    def _fill(self, chunk_bytes: int):
        def put(item) -> bool:
            while not self._stop.is_set():
                try:
                    self._q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        try:
            while not self._stop.is_set():
                with self._timers.stage("inflate"):
                    data = self._fh.read(chunk_bytes)
                self._timers.count(self._counter, len(data))
                for name, n in self._take_counts().items():
                    self._timers.count(name, n)
                if not put(data):
                    return
                if not data:
                    return
        except BaseException as e:  # surface at the consumer's next read()
            put(e)

    def read(self, n: int) -> bytes:
        """Up to ``n`` bytes (short reads are fine for the block reader;
        b'' means EOF)."""
        if not self._cur:
            if self._eof:
                return b""
            item = self._q.get()
            if isinstance(item, BaseException):
                self._eof = True
                raise item
            if not item:
                self._eof = True
                return b""
            self._cur = memoryview(item)
        take = self._cur[:n]
        self._cur = self._cur[n:]
        # always bytes: callers concatenate tails / format record slices,
        # which memoryview does not support (zero-copy when the piece is
        # consumed whole — the common case, since consumers read >= piece)
        return take.obj if len(take) == len(take.obj) else bytes(take)

    def close(self):
        self._stop.set()
        while True:  # unblock a producer stuck on a full queue
            try:
                self._q.get_nowait()
            except queue.Empty:
                break
        self._thread.join(timeout=5)
        self._fh.close()


def _find_newlines(chunk, num_threads: int = 0) -> np.ndarray:
    """Newline offsets; native memchr on ``num_threads`` when built (0: the
    thread's team), numpy scan otherwise."""
    if native.available():
        return native.find_newlines(chunk, num_threads)
    arr = np.frombuffer(chunk, dtype=np.uint8)
    return np.flatnonzero(arr == 0x0A).astype(np.int64)


def _kind(path: str) -> str:
    """``plain``, ``gzip`` or ``bgzf``, by the file's magic."""
    with open(path, "rb") as probe:
        if probe.read(2) != b"\x1f\x8b":
            return "plain"
    from .bgzf import is_bgzf

    return "bgzf" if is_bgzf(path) else "gzip"


def _decoder(path: str, kind: str) -> str:
    """The decode pool a reader of ``path`` runs, as :func:`plan` names
    it: ``bgzf``, ``gzip`` where the native decoder reads the file on
    several threads (two chunks or more), else none."""
    if kind == "gzip" and inflate.get_lib() and inflate._workers(path):
        return "gzip"
    return "bgzf" if kind == "bgzf" else ""


def open_maybe_gzip(path: str, mode: str = "rb", timers=NO_TIMERS,
                    decode=None):
    """Open a file, transparently decompressing gzip (magic-sniffed).

    BGZF files (bgzip framing) get the seekable block reader — logical
    ``seek`` is cheap, enabling byte-range sharding and resume on
    compressed inputs (``hpgq_torch.io.bgzf``), which times each member's
    inflate in ``timers``.  Other gzip input is read by the native decoder
    (:class:`~hpgq_torch.io.native.inflate.GzipReader`), or by
    :mod:`gzip` where the library cannot be built or ``HPGQ_NO_NATIVE`` is
    set; gzip output is :mod:`gzip`'s.  ``decode``: the threads of the
    file's decode pool as the caller planned them (gzip: 0 for the
    one-thread decoder); None leaves each reader its own rule."""
    if "r" in mode:
        kind = _kind(path)
        if kind == "bgzf":
            from .bgzf import BgzfFile

            return BgzfFile(path, timers=timers, workers=decode or 0)
        if kind == "gzip":
            return inflate.open_gzip(path, decode) or gzip.open(path, mode)
        return open(path, mode)
    if path.endswith(".gz"):
        return gzip.open(path, mode)
    return open(path, mode)


class RecordBlock:
    """A batch of FASTQ records backed by one contiguous byte buffer.

    ``starts``/``ends`` are ``[N, 4]`` int64 arrays of line byte-offsets into
    ``buf`` (lines: header, sequence, separator, quality), newline excluded.
    """

    __slots__ = ("buf", "starts", "ends", "arr", "base_offset")

    def __init__(self, buf: bytes, starts: np.ndarray, ends: np.ndarray,
                 base_offset: int = 0):
        self.buf = buf
        self.starts = starts
        self.ends = ends
        self.arr = np.frombuffer(buf, dtype=np.uint8)
        self.base_offset = base_offset

    def slice(self, lo: int, hi: int) -> "RecordBlock":
        """Zero-copy record-range view sharing this block's buffer."""
        sub = RecordBlock.__new__(RecordBlock)
        sub.buf = self.buf
        sub.arr = self.arr
        sub.starts = self.starts[lo:hi]
        sub.ends = self.ends[lo:hi]
        sub.base_offset = self.base_offset
        return sub

    @property
    def end_offset(self) -> int:
        """Logical file offset just past this block's last record — a valid
        resume point for ``FastqReader(start_offset=...)`` (checkpointing)."""
        if self.starts.shape[0] == 0:
            return self.base_offset
        e = int(self.ends[-1, 3])
        term = 2 if self.arr[e] == 0x0D else 1  # CRLF-aware
        return self.base_offset + e + term

    @property
    def span_bytes(self) -> int:
        """Bytes covered by THIS block's records (slice-aware — a slice's
        first record usually starts mid-chunk, so end_offset - base_offset
        would overcount)."""
        if self.starts.shape[0] == 0:
            return 0
        return self.end_offset - self.base_offset - int(self.starts[0, 0])

    @property
    def num_reads(self) -> int:
        return self.starts.shape[0]

    @property
    def seq_lens(self) -> np.ndarray:
        return (self.ends[:, 1] - self.starts[:, 1]).astype(np.int32)

    def max_len(self) -> int:
        return int(self.seq_lens.max()) if self.num_reads else 0

    def record_bytes(self, i: int) -> bytes:
        s, e = self.starts[i], self.ends[i]
        return b"%s\n%s\n%s\n%s\n" % (
            self.buf[s[0] : e[0]],
            self.buf[s[1] : e[1]],
            self.buf[s[2] : e[2]],
            self.buf[s[3] : e[3]],
        )

    def sequence(self, i: int) -> bytes:
        return self.buf[self.starts[i, 1] : self.ends[i, 1]]

    def quality(self, i: int) -> bytes:
        return self.buf[self.starts[i, 3] : self.ends[i, 3]]

    def _emit_spans(self, out, starts: np.ndarray, ends: np.ndarray):
        """Write buf[s:e) spans in order — native memcpy concat when built,
        python join otherwise."""
        from . import native

        if native.available():
            out.write(native.concat_spans(self.arr, starts, ends))
        else:
            buf = self.buf
            out.write(
                b"".join(buf[int(s) : int(e)] for s, e in zip(starts, ends))
            )

    def _term_end(self, ends_col: np.ndarray) -> np.ndarray:
        """Span end including the full line terminator (handles CRLF: the
        content ``ends`` exclude a trailing '\\r', so the terminator is 1 or
        2 bytes)."""
        return ends_col + 1 + (self.arr[ends_col] == 0x0D).astype(np.int64)

    def selected_spans(self, select: np.ndarray):
        """(starts, ends, count) span lists for the records where
        ``select`` is True — each record is one contiguous span
        [header_start, quality_newline] of the original chunk."""
        idx = np.flatnonzero(select)
        if not idx.size:
            return None, None, 0
        return (self.starts[idx, 0], self._term_end(self.ends[idx, 3]),
                int(idx.size))

    def trimmed_spans(
        self,
        ltrim: np.ndarray,
        rtrim: np.ndarray,
        select: Optional[np.ndarray] = None,
    ):
        """(starts, ends, count) span lists with per-read head/tail trims
        applied to the sequence and quality lines (the ``edit.fq`` shape).

        6 spans per record over the original buffer — the newline pieces
        reuse the line-end newline bytes already in the chunk:
        [hdr+\\n][seq[lt:len-rt]][\\n][sep+\\n][qual[lt:len-rt]][\\n]."""
        if select is not None:
            idx = np.flatnonzero(select)
        else:
            idx = np.arange(self.num_reads)
        n = int(idx.size)
        if n == 0:
            return None, None, 0
        s = self.starts[idx].astype(np.int64)
        e = self.ends[idx].astype(np.int64)
        lt = np.asarray(ltrim)[idx].astype(np.int64)
        rt = np.asarray(rtrim)[idx].astype(np.int64)

        seq_s, seq_e = s[:, 1] + lt, e[:, 1] - rt
        q_s, q_e = s[:, 3] + lt, e[:, 3] - rt
        over = seq_e < seq_s  # over-trimmed -> empty seq/qual lines
        seq_e = np.where(over, seq_s, seq_e)
        q_e = np.where(over, q_s, q_e)

        starts = np.stack(
            [s[:, 0], seq_s, e[:, 1], s[:, 2], q_s, e[:, 3]], axis=1
        ).reshape(-1)
        ends = np.stack(
            [self._term_end(e[:, 0]), seq_e, self._term_end(e[:, 1]),
             self._term_end(e[:, 2]), q_e, self._term_end(e[:, 3])],
            axis=1,
        ).reshape(-1)
        return starts, ends, n

    def write_selected(self, out, select: np.ndarray, pump=None) -> int:
        """Append records where ``select`` is True, preserving input order.

        Output assembly is a vectorized span gather — no per-record Python
        work.  With ``pump`` (:class:`AsyncSpanPump`), the concat + file
        write run on the pump's thread instead (overlapping the next
        batch's device round-trip)."""
        starts, ends, n = self.selected_spans(select)
        if n:
            if pump is not None:
                pump.submit(out, self, starts, ends)
            else:
                self._emit_spans(out, starts, ends)
        return n

    def write_trimmed(
        self,
        out,
        ltrim: np.ndarray,
        rtrim: np.ndarray,
        select: Optional[np.ndarray] = None,
        pump=None,
    ) -> int:
        """Append records with per-read head/tail trims applied to the
        sequence and quality lines (the ``edit.fq`` writer); span shape
        documented on :meth:`trimmed_spans`.  ``pump``: see
        :meth:`write_selected`."""
        starts, ends, n = self.trimmed_spans(ltrim, rtrim, select)
        if n:
            if pump is not None:
                pump.submit(out, self, starts, ends)
            else:
                self._emit_spans(out, starts, ends)
        return n


class AsyncSpanPump:
    """Background output writer: span concat + file writes for a command's
    output files run on ONE dedicated thread, overlapping the next batch's
    pack/H2D/device round-trip — the TPU-shaped analog of the reference's
    consumer writing results while workers compute
    (``src/filter_fastq.c:161-170`` ∥ ``:134-149``).

    A single thread serving ALL of a command's outputs preserves the exact
    write order (and thus byte-identical files); the queue is bounded so
    at most ``depth`` span batches (each pinning its source chunk buffer)
    are in flight.  The span concat (native memcpy via ctypes) and the
    ``file.write`` both release the GIL, so the overlap is real.  The first
    writer-side exception re-raises on the submitting thread at the next
    ``submit``/``drain``/``close``."""

    def __init__(self, depth: int = 4, sync: "Optional[bool]" = None):
        """``sync`` forces inline (threadless) writes; default reads
        ``HPGQ_ASYNC_WRITES`` (0/off disables the thread — A/B + debug)."""
        import queue
        import threading

        if sync is None:
            sync = os.environ.get("HPGQ_ASYNC_WRITES", "1") in ("0", "off")
        self.sync = sync
        self._err = None
        self._t = None
        if not sync:
            self._q = queue.Queue(maxsize=max(1, depth))
            self._t = threading.Thread(target=self._run,
                                       name="hpgq-span-pump", daemon=True)
            self._t.start()

    def _run(self):
        while True:
            item = self._q.get()
            try:
                if item is None:
                    return
                if self._err is None:
                    out, block, starts, ends = item
                    block._emit_spans(out, starts, ends)
            except BaseException as e:  # noqa: BLE001 — relayed to caller
                self._err = e
            finally:
                self._q.task_done()

    def _check(self):
        if self._err is not None:
            err, self._err = self._err, None
            raise err

    def submit(self, out, block, starts, ends):
        if self.sync:
            block._emit_spans(out, starts, ends)
            return
        self._check()
        self._q.put((out, block, starts, ends))

    def drain(self):
        """Block until every submitted write hit its file (checkpoint
        barriers need the writers' byte sizes to be final)."""
        if self.sync:
            return
        self._q.join()
        self._check()

    def close(self):
        if self._t is not None and self._t.is_alive():
            self._q.put(None)
            self._t.join()
        self._check()

    def __enter__(self):
        return self

    def __exit__(self, et, ev, tb):
        if ev is None:
            self.close()
        else:  # already failing: drain best-effort, keep the original error
            try:
                self.close()
            except BaseException:  # noqa: BLE001
                pass
        return False


def concat_same_chunk(blocks: "list[RecordBlock]") -> RecordBlock:
    """Merge RecordBlocks that share one underlying chunk buffer into a
    single block (zero-copy: the merged block is just the union of the
    slices' record tables).  Only valid for blocks over the SAME ``arr``
    (the reader emits consecutive slices of each 16 MB chunk, so this
    covers every same-chunk run); offsets/end_offset/span_bytes all stay
    exact because the buffer and base_offset are unchanged."""
    if len(blocks) == 1:
        return blocks[0]
    b0 = blocks[0]
    out = RecordBlock.__new__(RecordBlock)
    out.buf = b0.buf
    out.arr = b0.arr
    out.base_offset = b0.base_offset
    out.starts = np.concatenate([b.starts for b in blocks])
    out.ends = np.concatenate([b.ends for b in blocks])
    return out


def coalesce_blocks(blocks, target_reads: int):
    """Batch consecutive same-chunk RecordBlocks up to ``target_reads``
    per emitted block — the dispatch-coalescing iterator for explicit
    small ``--batch-size`` runs (one device round-trip per ~target reads
    instead of one per reader block; through a high-latency link the
    dispatch count, not bytes, is the ceiling).  Record content, order,
    and resume offsets are untouched; a chunk boundary always flushes
    (merging across chunks would need a buffer copy for no extra win —
    chunks already hold ~target reads)."""
    pend: "list[RecordBlock]" = []
    n = 0
    for b in blocks:
        if pend and (b.arr is not pend[0].arr
                     or n + b.num_reads > target_reads):
            yield concat_same_chunk(pend)
            pend, n = [], 0
        pend.append(b)
        n += b.num_reads
        if n >= target_reads:
            yield concat_same_chunk(pend)
            pend, n = [], 0
    if pend:
        yield concat_same_chunk(pend)


def _first_bad(chunk, starts: np.ndarray, ends: np.ndarray) -> int:
    """numpy's record checks, where the native library is not built:
    each line end moved back over a '\\r' before its newline (in
    ``ends``), and the first record whose sequence and quality lengths
    differ or whose header is not '@' or separator not '+' (-1 for
    none).  A desynced 4-line grouping (a truncated or corrupt file)
    shows so; the packers index the chunk by sequence length, so it would
    otherwise become out-of-bounds reads or silently wrong stats."""
    arr = np.frombuffer(chunk, dtype=np.uint8)
    ends -= arr[np.maximum(ends - 1, 0)] == 0x0D  # CRLF line terminators
    sl = ends[:, 1] - starts[:, 1]
    ql = ends[:, 3] - starts[:, 3]
    bad = (sl != ql) | (arr[starts[:, 0]] != 0x40) \
        | (arr[starts[:, 2]] != 0x2B)  # '@' header, '+' separator
    return int(np.flatnonzero(bad)[0]) if bad.any() else -1


def _index_lines(chunk: bytes, nl: np.ndarray, nrec: int) -> "tuple[np.ndarray, np.ndarray]":
    """Build [nrec,4] line start/end offset arrays from newline positions."""
    if nrec == 0:
        z = np.empty((0, 4), dtype=np.int64)
        return z, z
    line_ends = nl[: nrec * 4].reshape(nrec, 4)
    line_starts = np.empty_like(line_ends)
    flat_e = line_ends.ravel()
    flat_s = line_starts.ravel()
    flat_s[0] = 0
    flat_s[1:] = flat_e[:-1] + 1
    return line_starts, line_ends


class FastqReader:
    """Streaming FASTQ reader yielding :class:`RecordBlock` batches.

    ``batch_size`` is in reads, like the reference's producer
    (``fastq_fread_se(fq_reads, max_num_reads, file)``, src/stats_fastq.c:183).
    ``timers``: the pass's stage timers, which get the ``index`` stage of
    each chunk on the thread that iterates the reader and the ``inflate``
    stage of a compressed input on the threads that inflate it, the count
    ``team-short`` and, as a note, the reader's :attr:`plan`.
    """

    def __init__(
        self,
        path: str,
        batch_size: int = 10000,
        start_offset: int = 0,
        end_offset: Optional[int] = None,
        timers=NO_TIMERS,
        shards: int = 1,
        mates: int = 1,
        packers: Optional[int] = None,
    ):
        """``start_offset``/``end_offset`` bound the byte range read — used
        for multi-host sharding of a plain FASTQ file (offsets must be
        record-aligned, see ``hpgq.dist.mesh.split_byte_ranges``).

        ``shards``, ``mates`` and ``packers`` describe the pipeline the
        reader feeds (:func:`hpgq_torch.io.native.plan`): the shard
        pipelines running at once, its readers (2 for paired input) and
        the pack workers asked for (None: the plan's choice, 0: the
        reader's thread packs).  :attr:`plan` shares the host's cores
        among its decode pool, index and pack; the file is opened with
        the plan's decode pool."""
        self.path = path
        self.batch_size = int(batch_size)
        self._timers = timers
        self.plan = native.plan(_decoder(path, _kind(path)), shards, mates,
                                packers)
        timers.note("plan %s: %s" % (os.path.basename(path), self.plan))
        self._fh = open_maybe_gzip(path, "rb", timers, self.plan.decode)
        if start_offset:
            self._fh.seek(start_offset)
        if isinstance(self._fh, (GzipReader, gzip.GzipFile)):
            # plain (non-BGZF) gzip: pipeline the serial inflate off the
            # critical path (seek done above — the wrapper is read-only)
            self._fh = ReadaheadFile(self._fh, timers=timers)
        self._end = end_offset
        self._tail = b""
        self.bytes_consumed = start_offset  # logical (decompressed) offset
        self._raw_read = start_offset

    def close(self):
        self._fh.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def _load_chunk(self) -> Optional[RecordBlock]:
        while True:
            want = _CHUNK
            if self._end is not None:
                want = min(want, self._end - self._raw_read)
            data = self._fh.read(want) if want > 0 else b""
            self._raw_read += len(data)
            if not data and not self._tail:
                return None
            with self._timers.stage("index"):
                block = self._index(data)
            native.count_team_short(self._timers)
            if block is not None:
                return block

    def _index(self, data: bytes) -> Optional[RecordBlock]:
        """The block of the records that end in the carried tail and
        ``data`` (b'': the end of the input), or None when none ends there
        yet and ``data`` joins the tail."""
        if not data:
            chunk, self._tail = self._tail, b""
            if not chunk.endswith(b"\n"):
                chunk += b"\n"
            return self._block_from(chunk)
        # avoid large copies: join (natively, off the interpreter lock)
        # only when a tail carries over, and keep the (partial-record)
        # remainder inside the block buffer — starts/ends simply don't
        # cover it
        chunk = native.join(self._tail, data, self.plan.index) \
            if self._tail else data
        nl = _find_newlines(chunk, self.plan.index)
        nrec = len(nl) // 4
        if nrec == 0:
            self._tail = chunk
            return None
        cut = int(nl[nrec * 4 - 1]) + 1
        self._tail = chunk[cut:]
        return self._block_from(chunk, nl[: nrec * 4], consumed=cut)

    def _block_from(self, chunk: bytes, nl: Optional[np.ndarray] = None,
                    consumed: Optional[int] = None) -> RecordBlock:
        if nl is None:
            nl = _find_newlines(chunk, self.plan.index)
        nrec = len(nl) // 4
        nl = np.asarray(nl, dtype=np.int64)
        if nrec and native.available():
            # the native pass below, with the interpreter lock released
            starts, ends, i = native.record_table(chunk, nl, nrec)
        else:
            starts, ends = _index_lines(chunk, nl, nrec)
            i = _first_bad(chunk, starts, ends) if nrec else -1
        if i >= 0:
            sl = ends[i, 1] - starts[i, 1]
            ql = ends[i, 3] - starts[i, 3]
            raise FastqParseError(
                "malformed FASTQ record near byte offset %d of %s: "
                "header %r, sequence length %d, quality length %d"
                % (self.bytes_consumed + int(starts[i, 0]), self.path,
                   bytes(chunk[starts[i, 0]:
                               min(ends[i, 0], starts[i, 0] + 40)]),
                   int(sl), int(ql))
            )
        base = self.bytes_consumed
        self.bytes_consumed += len(chunk) if consumed is None else consumed
        return RecordBlock(chunk, starts, ends, base_offset=base)

    def __iter__(self) -> Iterator[RecordBlock]:
        carry: Optional[RecordBlock] = None
        carry_pos = 0
        while True:
            if carry is None:
                carry = self._load_chunk()
                carry_pos = 0
                if carry is None:
                    return
            n = carry.num_reads - carry_pos
            if n >= self.batch_size:
                yield carry.slice(carry_pos, carry_pos + self.batch_size)
                carry_pos += self.batch_size
                if carry_pos >= carry.num_reads:
                    carry = None
            else:
                # batch boundary falls inside the chunk tail: emit the remainder
                # as a (short) block — merging is accumulation-invariant.
                if n > 0:
                    yield carry.slice(carry_pos, carry.num_reads)
                carry = None


class FastqWriter:
    """Buffered FASTQ output file (the ``fastq_fopen_mode(name, "w")`` analog).

    ``append_at``: resume support — reopen the existing file, truncate to the
    checkpointed byte size, and continue appending (plain files only; a
    truncated gzip stream is not valid)."""

    def __init__(self, path: str, append_at: "Optional[int]" = None):
        self.path = path
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        if append_at is None:
            self._fh = open_maybe_gzip(path, "wb")
        else:
            if path.endswith(".gz"):
                raise ValueError("cannot resume into a gzip output: %s" % path)
            if not os.path.exists(path):
                open(path, "wb").close()
            # r+b, not ab: POSIX append mode ignores seek/truncate positions
            self._fh = open(path, "r+b")
            size = os.fstat(self._fh.fileno()).st_size
            if append_at > size:
                # truncate() past EOF would silently zero-extend the file
                self._fh.close()
                raise ValueError(
                    "checkpoint expects %d bytes in %s but the file has %d "
                    "— it was truncated or replaced since the checkpoint; "
                    "remove the checkpoint to restart from scratch"
                    % (append_at, path, size)
                )
            self._fh.truncate(append_at)
            self._fh.seek(append_at)

    def write(self, data: bytes):
        self._fh.write(data)

    def flush(self):
        self._fh.flush()

    def tell(self) -> int:
        return self._fh.tell()

    def close(self):
        self._fh.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
