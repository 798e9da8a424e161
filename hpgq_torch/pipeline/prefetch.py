"""The port's own copy of ``hpgq/pipeline/prefetch.py`` (the port imports
nothing of ``hpgq``), with one addition: on a transform pool the
consumer's wait is timed by what it waits on (``timers``).

Background producer: overlap file read/index/pack with device compute.

The TPU-native reshaping of the reference's producer->worker(s)->consumer
thread pipeline (``workflow_run_with``, ``src/stats_fastq.c:455-465``; legacy
bounded batch queue ``old/README:57``): a single producer thread runs the
blocking host work (file read, newline indexing, optionally packing) ahead
of the consumer through a bounded queue, so the host stays busy while the
device step of the previous batch is in flight.  numpy and the native packer
release the GIL for the bulk of the work, so one thread suffices to overlap.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Iterable, Iterator

from ..utils.timers import NO_TIMERS

_SENTINEL = object()


def prefetched(it: Iterable, depth: int = 3, transform: Callable = None,
               workers: int = 1, timers=None) -> Iterator:
    """Iterate ``it`` (optionally mapped through ``transform``) in a
    background thread, ``depth`` items ahead.  Exceptions re-raise at the
    consumption point; the producer stops if the consumer abandons early.

    ``workers > 1`` (needs ``transform``) fans the transform out over a
    thread pool while a single reader thread drains ``it`` in order; results
    are yielded in input order.  This is the engine's host parallelism knob:
    pack + host->device transfer of several batches proceed concurrently
    (numpy, the native packer, and jax transfers all release the GIL), so
    the pipeline's critical path drops to max(stage) instead of sum(stages)
    — the TPU reshaping of the reference's N worker threads
    (``workflow_run_with(num_threads)``, src/stats_fastq.c:465).

    With a pool, ``timers`` (stage timers) get the consumer's wait for the
    next item, split in two: ``wait-reader`` while the reader thread has
    not yet handed it over, ``wait-pack`` while its transform runs.  One
    producer does both in the serial case, whose wait is not split."""
    if workers > 1 and transform is not None:
        return _prefetched_pool(it, depth, transform, workers,
                                timers or NO_TIMERS)
    return _prefetched_serial(it, depth, transform)


def _prefetched_pool(it: Iterable, depth: int, transform: Callable,
                     workers: int, timers) -> Iterator:
    # bounded queue of futures: reader blocks when depth transforms are in
    # flight; consumer resolves futures in submission (= input) order
    q: "queue.Queue" = queue.Queue(maxsize=max(depth, workers))
    stop = threading.Event()
    pool = ThreadPoolExecutor(max_workers=workers,
                              thread_name_prefix="hpgq-pack")

    def read():
        try:
            for item in it:
                fut = pool.submit(transform, item)
                while not stop.is_set():
                    try:
                        q.put(fut, timeout=0.1)
                        break
                    except queue.Full:
                        continue
                if stop.is_set():
                    fut.cancel()
                    return
            while not stop.is_set():
                try:
                    q.put(_SENTINEL, timeout=0.1)
                    break
                except queue.Full:
                    continue
        except BaseException as e:  # reader-side error -> consumer
            while not stop.is_set():
                try:
                    q.put(e, timeout=0.1)
                    break
                except queue.Full:
                    continue

    t = threading.Thread(target=read, daemon=True, name="hpgq-reader")
    t.start()
    try:
        while True:
            with timers.stage("wait-reader"):
                item = q.get()
            if item is _SENTINEL:
                return
            if isinstance(item, BaseException):
                raise item
            with timers.stage("wait-pack"):
                done = item.result()
            yield done
    finally:
        stop.set()
        pool.shutdown(wait=False, cancel_futures=True)


def _prefetched_serial(it: Iterable, depth: int,
                       transform: Callable) -> Iterator:
    q: "queue.Queue" = queue.Queue(maxsize=depth)
    stop = threading.Event()

    def produce():
        try:
            for item in it:
                if transform is not None:
                    item = transform(item)
                while not stop.is_set():
                    try:
                        q.put(item, timeout=0.1)
                        break
                    except queue.Full:
                        continue
                if stop.is_set():
                    return
            while not stop.is_set():
                try:
                    q.put(_SENTINEL, timeout=0.1)
                    break
                except queue.Full:
                    continue
        except BaseException as e:  # propagate into the consumer
            while not stop.is_set():
                try:
                    q.put(e, timeout=0.1)
                    break
                except queue.Full:
                    continue

    t = threading.Thread(target=produce, daemon=True, name="hpgq-producer")
    t.start()
    try:
        while True:
            item = q.get()
            if item is _SENTINEL:
                return
            if isinstance(item, BaseException):
                raise item
            yield item
    finally:
        stop.set()
