"""Share of the traced window, in %, in which no operation ran on the card."""


def read(run):
    return run.idle_pct()
