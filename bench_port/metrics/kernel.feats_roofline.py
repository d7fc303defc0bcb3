"""The least time the traced window's feature work needs on the card
(``bench_port/roofline.py``, from the configuration and the valid frames
of this rank's rows) over the device time of every compute kernel in that
window, whichever kernels they are (copies and memsets left out), in
percent."""

from bench_port.roofline import bound_s, feature_work


def read(run):
    tr, work = run.trace, run.work
    if tr is None or not work or not tr.kernels:
        return None
    ops, nbytes = feature_work(run.spec, run.config["route"], run.config["tier"],
                               work["frames"], work["samples"], work["launches"])
    least, _ = bound_s(ops, nbytes)
    return 100.0 * least / tr.kernel_s
