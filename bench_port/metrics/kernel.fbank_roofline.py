"""The least time the traced window's filter-bank work needs on the card
(``bench_port/roofline.py``, from the configuration and the valid frames
of this rank's rows) over the device time of the compute kernels outside
the program's ``"extract.pitch"`` ranges (copies and memsets left out),
in percent: ``kernel.feats_roofline`` of a cell whose extractor also
tracks pitch, whose kernels it leaves out."""

from bench_port.roofline import bound_s, feature_work
from bench_port.trace_pitch import kernels_outside


def read(run):
    tr, work = run.trace, run.work
    if tr is None or not work:
        return None
    outside = kernels_outside(tr)
    if not outside:
        return None
    ops, nbytes = feature_work(run.spec, run.config["route"], run.config["tier"],
                               work["frames"], work["samples"], work["launches"])
    least, _ = bound_s(ops, nbytes)
    return 100.0 * least / sum(max(0.0, min(e, tr.hi) - max(s, tr.lo)) for s, e, _ in outside)
