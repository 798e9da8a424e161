"""``grow_share`` (session layer): the ``grow`` stage's seconds (a stats
session's growth to wider reads: the device accumulator folded to the
host and a wider one allocated, on the consumer) over the window's
seconds times the ranks, summed over every pass of the window.  A run
whose program has no such stage, or that never grows, reads nothing."""


def read(run):
    t = run.stages.get("grow")
    if t is None:
        return None
    return 100.0 * t / (run.window_s * run.world)
