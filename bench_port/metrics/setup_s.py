"""Seconds from the process's start to the start of the measured window:
imports, the card, the kernel libraries, the inputs and the warm-up."""


def read(run):
    return run.setup_s
