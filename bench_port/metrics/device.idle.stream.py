"""The card's idle share of the traced window, in percent: one less the
union of its kernel and copy intervals over the window's length."""


def read(run):
    tr = run.trace
    if tr is None or tr.window_s <= 0 or not tr.kernels:
        return None  # every cell launches kernels: a trace without them lost its records
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)
