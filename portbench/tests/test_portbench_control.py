"""The control comes out not correct: on the card, at each cell's own
size, the reference computed one precision below the configuration's
(fp8 convolutions for the bf16 trunk; for extraction also the TF32
frontend) is put in the program's place, and its readings fail the cell's
limits.  Skips where there is no CUDA device; on the card:

    python3 -m pytest -q portbench/tests/test_portbench_control.py
"""

import json

import pytest
import torch

from portbench import compare, manifest
from portbench.run import Ctx

BENCH = json.loads((manifest.HERE.parent / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card with CUDA (the control runs at the cell's size)")
    return torch.device("cuda", 0)


@pytest.mark.gpu
@pytest.mark.parametrize("cell_name", CELLS)
def test_control_is_not_correct(cell_name, card):
    cell = manifest.resolve(BENCH, cell_name)
    ctx = Ctx(cell.name, cell.config, cell.traffic, 2 ** 31 + 77, 0.0, False, card, cell.limits)
    rows = {r["kind"]: r for r in cell.driver.calibrate(ctx, True)}
    sound = {k: v for k, v in rows.pop("sound").items() if k in cell.limits["checks"]}
    control = next(r for k, r in rows.items() if k.startswith("control"))
    control = {k: v for k, v in control.items() if k in cell.limits["checks"]}
    assert compare.check(sound, cell.limits["checks"])[0]
    assert not compare.check(control, cell.limits["checks"])[0]
