"""The control, the reference in TF32 put in the program's place, comes out not correct.

TF32 (10 stored mantissa bits in every convolution's operands) is the
precision below the configurations' float32 with TF32 off.  At a small size
on the CPU (TF32 emulated by rounding the operands) and, on the card, at
each cell's own size on three seeds.
"""

import pytest

from gpubench import calibrate, harness

BENCH = harness.load_bench()


def _fails(cell, numbers):
    limits = harness.find_cell(BENCH, cell)[3]
    return [k for k, v in numbers.items() if v > limits[k]]


@pytest.mark.parametrize("cell", ["paper_train", "stretch_serve"])
def test_control_fails_on_the_cpu(small, cell):
    import torch

    numbers = calibrate.reference_readings(cell, 2 ** 31 + 5, torch.device("cpu"), "tf32", small)
    assert _fails(cell, numbers), numbers


@pytest.mark.cuda
@pytest.mark.parametrize("cell", [c["name"] for c in BENCH["workloads"]])
@pytest.mark.parametrize("seed", [2 ** 31 + 101, 2 ** 31 + 102, 2 ** 31 + 103])
def test_control_fails_on_the_card(card, cell, seed):
    numbers = calibrate.reference_readings(cell, seed, card, "tf32")
    assert _fails(cell, numbers), numbers
