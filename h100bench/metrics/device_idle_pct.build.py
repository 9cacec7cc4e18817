"""The share of the traced window in which no kernel, copy or memset ran
on the card: one minus the union of their intervals over the window."""

from h100bench.harness.readers import idle_pct


def read(ctx):
    return idle_pct(ctx)
