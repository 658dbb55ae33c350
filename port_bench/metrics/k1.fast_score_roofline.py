"""Kernel K1's share of its roofline: the least time the bytes of its
launches' shapes need at the H100's HBM rate (`peaks.k1_bytes`: every
pyramid level of the batch read and scored once, float32), over the
traced time of its launches."""

from port_bench import peaks

SYMBOL = "fast_score_levels_kernel"


def read(ctx):
    times = [e - s for name, s, e in ctx["trace"].kernels if SYMBOL in name]
    if not times:
        return None
    sh = ctx["shapes"]
    least = len(times) * peaks.k1_least_s(sh["levels"], sh["batch"])
    return 100.0 * least / (sum(times) / 1e9)
