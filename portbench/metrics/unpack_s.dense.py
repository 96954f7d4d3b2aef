"""Seconds a dense build spends turning the survivor bitmasks that crossed
from the card into flat indices (``np.unpackbits`` and ``np.flatnonzero`` in
``builder``, the host side of the transfer rule), inside host extraction:
the mean over the window's builds of ``BuildResult.timings["unpack"]``, the
program's ``unpack`` span. None where no batch crossed as a bitmask."""


def read(window):
    return window.mean_timing("unpack")
