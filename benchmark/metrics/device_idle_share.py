"""``device_idle_share`` (device layer): the share of the window in which
no operation ran on the card: 1 less the union of the card's busy
intervals (kernels, copies and memsets, every stream) over the window,
averaged over the cards."""


def read(run):
    if not run.cards or any(c is None for c in run.cards):
        return None
    busy = sum(c["busy_s"] for c in run.cards) / len(run.cards)
    return 100.0 * (1.0 - busy / run.window_s)
