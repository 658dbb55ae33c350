"""Device ms per global-BA call in the segment sums: the kernels of
PyTorch's `index_add_` (by name), which every observation reduction of
`backend/ba.py::ba_core` runs on."""

SYMBOLS = ("indexFuncLargeIndex", "indexFuncSmallIndex", "index_add")


def read(ctx):
    ns = sum(e - s for name, s, e in ctx["trace"].kernels
             if any(sym in name for sym in SYMBOLS))
    return ns / 1e6 / ctx["units"] if ns else None
