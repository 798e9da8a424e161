"""``merge_share`` (ranks layer): rank 0's ``vote`` and ``finish-merge``
stage seconds (the last step's fold and the gloo merge of the ranks'
counters, with the wait for the slowest rank) over the window.  A run of
one process has no such stage and reads nothing."""


def read(run):
    stages = run.rank_stages[0]
    if "finish-merge" not in stages:
        return None
    return 100.0 * (stages["finish-merge"] + stages.get("vote", 0.0)) / run.window_s
