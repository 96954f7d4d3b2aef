"""Seconds an on-disk build spends spilling its parts: each key batch's
sort (``host._sort_batch``) and its uncompressed save (``serialize.save``)
under ``<working_dir>/hashmaps/``. The mean over the window's builds of
``BuildResult.timings["spill"]``, the program's ``spill`` span. None where a
build lacks it (an in-RAM build, or the program before the span)."""


def read(window):
    return window.mean_timing("spill")
