"""On the card: one short run of each kind at the tiny preset through the
real kernels. Run on the card with ``python3 -m pytest plexbench/tests -m
cuda``."""
import json
from pathlib import Path

import pytest

from plexbench import harness

DATA = Path(__file__).resolve().parent / "data"


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["tiny.train_mux", "tiny.rollout_mux"])
def test_tiny_cells_run_on_the_card(name):
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the kernels are built with nvcc")
    bench = json.loads((DATA / "bench.json").read_text())
    cell = harness.Cell(name, bench, data=DATA)
    run = harness.Run(cell, 2 ** 33 + 1, 2.0, True)
    result = run.execute()
    assert result["device"]["platform"] == "gpu"
    assert result["correct"], result["checks"]
