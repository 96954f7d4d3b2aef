"""``combine_max``'s share of its roofline, in percent: the least time the
window's builds need for their combine work, counted from the configuration
(``peaks.combine_max_seconds``: G ghosts, W windows, sigma^(k/2) left and
sigma^(k - k/2) right halves), over the summed device time of the kernels
whose names match PATTERNS in the trace."""

from portbench import peaks

PATTERNS = [r"combine_max_kernel<false"]


def read(window):
    t = window.trace
    if t is None or not window.builds:
        return None
    spent = t.device_seconds(PATTERNS)
    if not spent:
        return None
    config = window.config
    k = config["build"]["kmer_size"]
    ghosts = 2 * (2 * config["num_leaves"] - 2)
    need = peaks.combine_max_seconds(ghosts, config["width"] - k + 1,
                                     4 ** (k // 2), 4 ** (k - k // 2))
    return 100.0 * window.builds * need / spent
