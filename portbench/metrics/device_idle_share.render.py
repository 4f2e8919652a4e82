"""The share of the traced window in which no kernel or copy ran on the
card: 1 minus the union of the profiler's device intervals over the
window."""

from portbench.metrics._shared import idle_share


def read(ctx):
    return idle_share(ctx)
