"""Share of the profiled train calls' window (first host or device event
to last) in which no operation ran on the card: one minus the union of
the device operations' intervals over the window, in percent."""


def read(run):
    return run.idle_pct("train")
