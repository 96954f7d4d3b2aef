"""Share of the traced window in which nothing ran on the card (no kernel,
copy or set), in percent, from the ``torch.profiler`` trace."""


def read(window):
    t = window.trace
    if t is None or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
