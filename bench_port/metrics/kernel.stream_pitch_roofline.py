"""The least time the traced window's stream pitch work needs on the card
(``bench_port/roofline_pitch.py``, from the configuration's ``"pitch"``
block, the frames the tracker absorbed in the traced window and its
ticks) over the device time of the compute kernels inside the program's
``"stream.pitch"`` ranges, in percent."""

from bench_port.reference.pitch import PitchSpec
from bench_port.roofline import bound_s
from bench_port.roofline_pitch import pitch_work
from bench_port.trace_stream import kernels_within


def read(run):
    tr, work = run.trace, run.work
    if tr is None or not work or not work.get("pitch_frames"):
        return None
    inside = kernels_within(tr)
    if not inside:
        return None
    pspec = PitchSpec(run.config["pitch"], run.spec.rate)
    least, _ = bound_s(*pitch_work(pspec, work["pitch_frames"], max(1, work["launches"])))
    # each kernel's overlap with the window (a record that lies outside it,
    # such as one with a start of 0, adds nothing)
    busy = sum(max(0.0, min(e, tr.hi) - max(s, tr.lo)) for s, e, _ in inside)
    return 100.0 * least / busy if busy > 0 else None
