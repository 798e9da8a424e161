"""``input_wait_share`` (pipeline layer): the share of the consumers' time
spent waiting for the next block, read, packed and copied to the card.

The ``read`` stage's seconds over the ``read`` and ``compute`` stages'
seconds, summed over every consumer thread of every pass (and every rank):
``read`` is a consumer's wait for its next block (``run._iter_packed``),
``compute`` its feeding of the device step.  Lower is faster where the
host pipeline sets the pace."""


def read(run):
    r, c = run.stages.get("read", 0.0), run.stages.get("compute", 0.0)
    if r + c <= 0:
        return None
    return 100.0 * r / (r + c)
