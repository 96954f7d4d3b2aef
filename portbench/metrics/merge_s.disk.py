"""Seconds an on-disk build spends in the block loop of its merge
(``host._merge_on_disk``: fill every part's buffer, cut, lexsort, gather
and write the column sections under ``<working_dir>/hashmaps/merge/``). The
mean over the window's builds of ``BuildResult.timings["merge.blocks"]``,
the program's ``merge.blocks`` span. None where a build lacks it."""


def read(window):
    return window.mean_timing("merge.blocks")
