"""On the card, at each cell's own size: the port passes the cell's check,
and the fp8 control and a step over half of the batch fail it. Run there
with `python -m pytest --noconftest -p no:cacheprovider -m cuda
perfbench/tests/test_perfbench_card.py` (about a minute a cell)."""

import json

import pytest
import torch

from perfbench import calibrate, check, run, spec

CELLS = [w["name"] for w in json.loads((run.ROOT / "BENCHMARK.json").read_text())["workloads"]]
SEED = 2 ** 31 + 12345


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_control_and_half_batch_fail_where_the_port_passes(name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cell = spec.load_cell(name, run.ROOT)
    sides = {r["side"]: r for r in calibrate.readings(cell, [SEED], [SEED], "cuda")}
    assert check.judge(sides["program"], cell.limits)[0], sides["program"]
    assert not check.judge(sides["control_fp8"], cell.limits)[0], sides["control_fp8"]
    assert not check.judge(sides["half_batch"], cell.limits)[0], sides["half_batch"]
