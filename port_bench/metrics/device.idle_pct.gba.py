"""Idle share of the card in the traced window of a global-BA cell, in %."""

from port_bench.trace import idle_pct


def read(ctx):
    return idle_pct(ctx["trace"])
