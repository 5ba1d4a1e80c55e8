"""`correct` has to come out false where the timed path is broken: the
harness is driven without its look for a card, at the tiny sizes, with a
fault planted underneath; and the lower-precision control has to fail.

Faults the generation cell can have: an answer altered where it is
produced (an image), a step that returns its state unchanged (a denoise
step), and half of an SD batch left out (its rows handed the outputs of
the rows computed). A missing exchange between chips belongs to several
chips, which the cell does not have."""

import pytest
import torch

from gillbench import run, tiny

torch.set_num_threads(2)
CPU = torch.device("cpu")


def _go(seed, **kw):
    line, _ = run.run_cell(tiny.cell(), seed=seed, seconds=0.6, trace=0,
                           device=CPU, **kw)
    return line


@pytest.mark.parametrize("seed", [2 ** 31 + 17, 2 ** 33 + 1])
def test_sound_run_is_correct(seed):
    line = _go(seed)
    assert line["correct"], line["checks"]
    assert line["failed"] == 0 and line["attempted"] > 0


@pytest.mark.parametrize("fault", ["answer", "stale", "half_batch"])
def test_fault_is_caught(fault):
    line = _go(2 ** 31 + 19, fault=fault)
    assert not line["correct"], line["checks"]


@pytest.mark.parametrize("seed", [5, 6])
def test_control_fails(seed):
    """The control: the program's own W8 LM and W8A8 UNet."""
    line = _go(seed, control=True)
    assert not line["correct"], line["checks"]
