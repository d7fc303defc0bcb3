"""The share of the pitch tracker's Viterbi steps that its hand-written
kernel ran (rows times steps, ``csrc/viterbi_kernels.cu``), from
``ShardedExtractor.stats`` (``pitch_kernel_steps`` / ``pitch_steps``, the
program's counters) over the window, in percent."""


def read(run):
    c = run.counters
    if "pitch_kernel_steps" not in c or not c.get("pitch_steps"):
        return None  # a program that does not count the kernel's steps
    return 100.0 * c["pitch_kernel_steps"] / c["pitch_steps"]
