"""``index_busy_share`` (pipeline layer): how busy the reader thread is
indexing, over the window.

The ``index`` stage's seconds (each chunk's newline index, line table
and record check, without the wait for its bytes) over the window's
seconds times the ranks, summed over every pass of the window.  A
program with no such stage reads nothing."""


def read(run):
    t = run.stages.get("index")
    if t is None:
        return None
    return 100.0 * t / (run.window_s * run.world)
