"""Seconds a dense build spends in host extraction and the mif0 filter: the
mean over the window's builds of ``BuildResult.timings["host_extract"]``, a
host clock the program keeps around ``host._extract_batch`` /
``_extract_compact`` and ``core/filter``."""


def read(window):
    return window.mean_timing("host_extract")
