"""Share of the traced stretch in which the card ran no kernel and no copy."""


def read(run, trace):
    return 100.0 * (1.0 - trace.busy_s() / trace.window_s) if trace.window_s > 0 else None
