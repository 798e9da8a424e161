"""``mate_wait_share`` (pipeline layer): how long the thread that pairs
the mates' blocks waits on the mates' readers, over the window.

The ``wait-mate-1`` and ``wait-mate-2`` stages' seconds (the pairing
thread's wait for each mate's next block, read and indexed) over the
window's seconds times the ranks, summed over every pass of the window.
Near 100% the mates' readers set the pace.  A single-end run, or a
program with no such stages, reads nothing."""


def read(run):
    waits = [run.stages[k] for k in ("wait-mate-1", "wait-mate-2")
             if k in run.stages]
    if not waits:
        return None
    return 100.0 * sum(waits) / (run.window_s * run.world)
