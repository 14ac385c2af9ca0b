"""Host milliseconds from the call of the prefill entry to its return, before
any synchronize: the median over the traced run's unprofiled window."""


def read(run):
    return run.dispatch_ms("prefill")
