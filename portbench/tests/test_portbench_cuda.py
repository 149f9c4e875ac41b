"""On a card: each cell at a small size through the whole run, traced, and
correct.  The window is one call: the small epoch holds a few slices."""

import time

import pytest
import torch

from portbench import harness
from portbench.tests import tiny


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["plenoxels-syn-256.steady", "ngp-syn-2p19.probmap"])
def test_cell_on_the_card(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    r = harness.run_cell(cell, 3, 0.01, True, torch.device("cuda", 0), time.perf_counter(),
                         tweak=tiny.for_cell(cell))
    assert r["correct"], r["checks"]
    assert r["device"]["busy_s"] > 0
