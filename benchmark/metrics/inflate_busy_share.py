"""``inflate_busy_share`` (pipeline layer): how busy the threads that
inflate a compressed input are, over the window.

The ``inflate`` stage's seconds (each read of a piece from the gzip
stream, or each BGZF member) over the window's seconds times the ranks,
summed over every pass of the window.  A plain gzip file has one inflate
thread a rank, so near 100% it sets the pace; a plain input, or a
program with no such stage, reads nothing."""


def read(run):
    t = run.stages.get("inflate")
    if t is None:
        return None
    return 100.0 * t / (run.window_s * run.world)
