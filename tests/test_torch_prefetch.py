"""``tests/test_prefetch.py``'s cases on the port's own copy,
``hpgq_torch.pipeline.prefetch``: producer-thread prefetch, ordering,
exception propagation, early abandon.
"""

import time

from hpgq_torch.pipeline.prefetch import prefetched


def test_order_and_transform():
    out = list(prefetched(range(100), depth=4, transform=lambda x: x * 2))
    assert out == [x * 2 for x in range(100)]


def test_exception_propagates():
    def gen():
        yield 1
        yield 2
        raise ValueError("boom")

    it = prefetched(gen(), depth=2)
    assert next(it) == 1
    assert next(it) == 2
    try:
        next(it)
        assert False, "expected ValueError"
    except ValueError as e:
        assert "boom" in str(e)


def test_pool_order_and_transform():
    """workers>1 fans the transform out but must preserve input order."""
    import random

    def slow_double(x):
        time.sleep(random.random() * 0.003)  # jitter to shuffle completion
        return x * 2

    out = list(prefetched(range(200), depth=6, transform=slow_double, workers=4))
    assert out == [x * 2 for x in range(200)]


def test_pool_transform_exception_propagates():
    def bad(x):
        if x == 5:
            raise ValueError("boom-5")
        return x

    it = prefetched(range(10), depth=3, transform=bad, workers=3)
    got = []
    try:
        for v in it:
            got.append(v)
        assert False, "expected ValueError"
    except ValueError as e:
        assert "boom-5" in str(e)
    assert got == [0, 1, 2, 3, 4]


def test_pool_reader_exception_propagates():
    def gen():
        yield 1
        raise RuntimeError("reader-died")

    it = prefetched(gen(), depth=2, transform=lambda x: x, workers=2)
    assert next(it) == 1
    try:
        next(it)
        assert False, "expected RuntimeError"
    except RuntimeError as e:
        assert "reader-died" in str(e)


def test_pool_consumer_abandons_early():
    produced = []

    def gen():
        for i in range(10_000):
            produced.append(i)
            yield i

    it = prefetched(gen(), depth=2, transform=lambda x: x, workers=2)
    for _ in range(3):
        next(it)
    it.close()
    time.sleep(0.3)
    assert len(produced) < 10_000


def test_consumer_abandons_early():
    produced = []

    def gen():
        for i in range(10_000):
            produced.append(i)
            yield i

    it = prefetched(gen(), depth=2)
    for _ in range(3):
        next(it)
    it.close()
    time.sleep(0.3)
    assert len(produced) < 10_000  # producer stopped, not drained
