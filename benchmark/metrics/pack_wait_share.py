"""``pack_wait_share`` (pipeline layer): the share of the consumers' time
spent waiting on the pack pool, which had the next block but had not yet
packed it and started its copy to the card.

The ``wait-pack`` stage's seconds over the ``read`` and ``compute``
stages' seconds (``input_wait_share``'s base), summed over every pass of
the window and every rank.  ``wait-pack`` lies inside ``read``, beside
``wait-reader``; a run whose program has no such stage reads nothing."""


def read(run):
    w = run.stages.get("wait-pack")
    base = run.stages.get("read", 0.0) + run.stages.get("compute", 0.0)
    if w is None or base <= 0:
        return None
    return 100.0 * w / base
