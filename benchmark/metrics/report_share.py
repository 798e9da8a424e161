"""``report_share`` (fold and report layer): rank 0's ``reporting`` stage
seconds (``stats_report`` over the folded counters) over the window."""


def read(run):
    t = run.rank_stages[0].get("reporting")
    if t is None:
        return None
    return 100.0 * t / run.window_s
