"""Seconds a dense build spends in the mif0 filter (``core/filter``'s
``mif0_filter_values_entries``, called once a key batch inside host
extraction): the mean over the window's builds of
``BuildResult.timings["mif0"]``, the program's ``mif0`` span."""


def read(window):
    return window.mean_timing("mif0")
