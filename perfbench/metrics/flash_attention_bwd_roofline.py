"""``flash_attention_bwd``'s share of its roofline: the bound of one call at the run's
shape (``rooflines/flash_attention_bwd.py``) over the call's device time in the
profiled calls (each of its kernels' median launch, by name), in
percent."""


def read(run):
    return run.roofline_pct("flash_attention_bwd")
