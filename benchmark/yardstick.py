"""The constants the benchmark measures against, frozen here.

``PEAK_HBM_BYTES_PER_S``: one NVIDIA H100 SXM's memory bandwidth, 3.35
TB/s (NVIDIA's data sheet; a card set below 700 W runs lower, so a run
prints the card's power limit beside its numbers).

The bytes a pass's data needs on the card are worked out from the cell's
data and not from any wire format or kernel of the program: half a byte a
base for binned reads (a 2-bit base and a 2-bit quality bin), one byte a
base for unbinned reads, and four bytes a read for its length.  No count
of operations enters the bound: an operation count is a property of one
algorithm, and a better one would read over 100%.
"""

PEAK_HBM_BYTES_PER_S = 3.35e12
BYTES_PER_BASE_BINNED = 0.5
BYTES_PER_BASE_UNBINNED = 1.0
BYTES_PER_READ = 4


def data_bytes(config: dict, reads: int, bases: int) -> float:
    """The least bytes that ``reads`` reads of ``bases`` bases of a
    configuration need on the card."""
    per_base = (BYTES_PER_BASE_BINNED if "bins" in config["quality"]
                else BYTES_PER_BASE_UNBINNED)
    return per_base * bases + BYTES_PER_READ * reads
