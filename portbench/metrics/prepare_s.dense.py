"""Seconds a dense build spends before stage 1 in ``pipeline.prepare``: the
alignment read and reduced, the tree extended and written, the extended
alignment built and written, the AR replayed and its tree and posteriors
read. The mean over the window's builds of ``BuildResult.timings["prepare"]``,
the program's own ``prepare`` span."""


def read(window):
    return window.mean_timing("prepare")
