"""The least time the traced window's pitch work needs on the card
(``bench_port/roofline_pitch.py``, from the configuration's ``"pitch"``
block, the tracked frames of this rank's rows and the traced batches)
over the device time of the compute kernels inside the program's
``"extract.pitch"`` ranges, in percent."""

from bench_port.reference.pitch import PitchSpec
from bench_port.roofline import bound_s
from bench_port.roofline_pitch import pitch_work
from bench_port.trace_pitch import kernels_in


def read(run):
    tr, work = run.trace, run.work
    if tr is None or not work or "pitch_frames" not in work:
        return None
    inside = kernels_in(tr)
    if not inside:
        return None
    pspec = PitchSpec(run.config["pitch"], run.spec.rate)
    least, _ = bound_s(*pitch_work(pspec, work["pitch_frames"], work["launches"]))
    return 100.0 * least / sum(min(e, tr.hi) - max(s, tr.lo) for s, e, _ in inside)
