"""Device kernels per batched frame of the fleet: kernel events in the
traced window (copies and sets left out) over its batched frames.  A
lower bound: the tracer drops an event now and then."""

NOT_KERNELS = ("Memcpy", "Memset")


def read(ctx):
    n = sum(1 for name, _, _ in ctx["trace"].kernels
            if not name.startswith(NOT_KERNELS))
    return n / ctx["units"] if n else None
