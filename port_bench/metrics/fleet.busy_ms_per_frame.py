"""Device-busy ms per batched frame of the fleet: the union of the traced
window's device intervals over its batched frames."""


def read(ctx):
    if ctx["trace"].busy_s <= 0:
        return None
    return 1e3 * ctx["trace"].busy_s / ctx["units"]
