"""The card's published peaks and the least time a piece of work needs.

NVIDIA H100 SXM data sheet, at its 700 W limit: 3.35 TB/s of device memory
and 67 TFLOP/s of float32 outside the tensor cores. The same numbers as
``chip_smoke.py``'s ``PEAK_BYTES_PER_S`` and ``PEAK_F32_OPS_PER_S``.
"""

PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_OPS_PER_S = 67e12


def least_seconds(bytes_moved: float, ops: float) -> float:
    """The larger of the bytes over the memory rate and the operations over
    the float32 rate (``chip_smoke.bound``, in seconds)."""
    return max(bytes_moved / PEAK_BYTES_PER_S, ops / PEAK_F32_OPS_PER_S)


def combine_max_seconds(ghosts: int, windows: int, nl: int, nr: int) -> float:
    """One build's ``combine_max`` work, counted from the configuration
    (``chip_smoke.combine_bound``): every (window, left half, right half)
    candidate of every ghost takes an add and a max; the halves L [G, W, nl]
    and R [G, W, nr] are read once and A [G, nl, nr] and the G counts are
    written once, all float32 but the int64 counts."""
    ops = 2 * ghosts * windows * nl * nr
    moved = 4 * ghosts * windows * (nl + nr) + 4 * ghosts * nl * nr + 8 * ghosts
    return least_seconds(moved, ops)
