"""Seconds a dense build spends writing its zlib-compressed ``.ipk``
(``serialize.save``): the mean over the window's builds of
``BuildResult.timings["serialize"]``, the program's ``serialize`` span."""


def read(window):
    return window.mean_timing("serialize")
