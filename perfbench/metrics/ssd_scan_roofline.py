"""``ssd_scan``'s share of its roofline: the bound of one call at the run's
shape (``rooflines/ssd_scan.py``) over the call's device time in the
profiled calls (each of its kernels' median launch, by name), in
percent."""


def read(run):
    return run.roofline_pct("ssd_scan")
