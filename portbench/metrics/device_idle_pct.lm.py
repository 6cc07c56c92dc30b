"""Share of the traced window in which no operation ran on the card: one
minus the union of the device intervals over the window (percent)."""

from portbench.core.readings import idle_pct


def read(run):
    return idle_pct(run)
