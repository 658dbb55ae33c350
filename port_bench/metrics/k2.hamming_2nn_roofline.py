"""Kernel K2's share of its roofline: the least time the int8 operations
of its launches' shapes need at the H100's 1,979 TOP/s (`peaks.k2_ops`:
batch x 512 keypoints x the arena's 16384 landmark slots x 256 bits),
over the traced time of its launches (the merge kernel is not part of
it)."""

from port_bench import peaks

SYMBOL = "hamming_2nn_kernel"


def read(ctx):
    times = [e - s for name, s, e in ctx["trace"].kernels if SYMBOL in name]
    if not times:
        return None
    sh = ctx["shapes"]
    least = len(times) * peaks.k2_least_s(sh["batch"], sh["n_query"], sh["n_train"])
    return 100.0 * least / (sum(times) / 1e9)
