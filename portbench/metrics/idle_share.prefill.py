"""The share of the traced window in which no operation ran on the card:
1 less the union of its busy intervals over the window's seconds, in
percent."""

from portbench.metrics_common import idle


def read(run: dict):
    return idle(run, "calls")
