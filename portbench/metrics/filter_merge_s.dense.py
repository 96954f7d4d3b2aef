"""Seconds a dense build spends sorting its rows by (fv, key) and writing
the compressed ``.ipk`` (``host._sort_batch``, ``serialize.save``): the
mean over the window's builds of ``BuildResult.timings["filter_merge"]``."""


def read(window):
    return window.mean_timing("filter_merge")
