"""``kernel_roofline_share`` (kernels layer): the least time the window's
data needs at the card's memory bandwidth, over the device time of every
operation in the window but host-to-device copies.

The bytes come from the cell's data (:func:`benchmark.yardstick.data_bytes`:
half a byte a base binned, one byte unbinned, four bytes a read), not from
any wire or kernel; the device time is summed over streams and over cards,
so that the bound, the data over one card's bandwidth, is shared between
them."""


def read(run):
    if not run.cards or any(c is None for c in run.cards):
        return None
    device_s = sum(c["non_h2d_s"] for c in run.cards)
    if device_s <= 0:
        return None
    return 100.0 * (run.data_bytes / run.peak_bytes_per_s) / device_s
