"""Seconds an on-disk build spends writing its ``.ipk`` from the merge's
column sections: the header and the sections streamed through the
compressor (``host._merge_on_disk``). The mean over the window's builds of
``BuildResult.timings["merge.write"]``, the program's ``merge.write`` span.
None where a build lacks it."""


def read(window):
    return window.mean_timing("merge.write")
