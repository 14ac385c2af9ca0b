"""Model FLOPs of the train work completed in the traced run's unprofiled
window (``modelflops.py``) over the window's seconds and the card's
bf16 peak, in percent."""


def read(run):
    return run.mfu_pct("train")
