"""The control of each cell (the plain reference put in the program's
place, in the precision just below the configuration's) fails the cell's
limits at a test's size on the CPU, where the program passes them.  On
the card, ``bench_port/control.py`` reads both at the cell's own size."""

import pytest
import torch

import small
from bench_port import control


@pytest.mark.parametrize("name", ["fbank40-kaldi-double.corpus", "fbank80-wenet-float.serve",
                                  "fbank80-wenet-float.stream"])
def test_the_control_fails_the_limits(monkeypatch, name):
    limits = small.small_cell(name)["cell"]["limits"]
    cell = control.common.cell
    monkeypatch.setattr(control.common, "cell",
                        lambda n: small.shrink(cell(n, small.DRAFTS.get(n))))
    rows = control.readings(name, [20261019], 1.0, torch.device("cpu"))
    for _, program, ctrl in rows:
        for k, limit in limits.items():
            assert program[k] <= limit and ctrl[k] > limit
