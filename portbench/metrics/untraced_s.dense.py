"""Seconds of a dense build that no layer's span covers: the summed self
time of the program's grouping spans (``build_database``, ``prepare``,
``build``, ``computation``, ``filter_merge``), the mean over the window's
builds of ``BuildResult.timings["untraced"]``. Small beside ``build_s.dense``
when the program's spans account for the build."""


def read(window):
    return window.mean_timing("untraced")
