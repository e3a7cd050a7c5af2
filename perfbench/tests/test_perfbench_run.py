"""A whole run on the CPU at a tiny size, past the look for a card: the form
of the result's line, and `correct` coming out false with the timed path
broken underneath and with the fp8 control in the port's place."""

import dataclasses
import json
import os
import shutil
import subprocess
import sys

import pytest
import torch

from perfbench import calibrate, check, run, spec
from pytorch_distributed_example_tpu_torch.examples import lm

# Limits for this tiny size, from its CPU readings (seeds 11-13 and 2**31 + 7):
# the port (bf16) against the reference reads loss_gap 4e-5-2.1e-4, grad_gap
# 2.1e-3-3.6e-3, change_gap 5.3e-4-7.8e-4; the fp8 control grad_gap 0.011-0.025.
TINY_LIMITS = {"loss_gap": 1e-3, "grad_gap": 8e-3, "change_gap": 3e-3}
SEED = 2 ** 31 + 7


def tiny_cell(name="mistral7b-train-4k", kv_heads=2, batch=2, limits=TINY_LIMITS):
    c = spec.load_cell(name, run.ROOT)
    cfg = dict(c.config, hidden_size=128, num_attention_heads=4, num_key_value_heads=kv_heads,
               intermediate_size=256, num_hidden_layers=2, vocab_size=512)
    traffic = dict(c.traffic, batch=batch, seq=128)
    return spec.Cell("tiny", 1, cfg, traffic, limits, c.end_to_end, c.per_layer)


@pytest.fixture(autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("traced", [False, True], ids=["trace0", "trace1"])
def test_result_line(traced):
    cell = tiny_cell()
    result, checks = run.run_cell(cell, SEED, 0.3, traced, "cpu")
    keys = list(result)
    assert keys[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert keys[-1] == "checks" and result["checks"] == checks
    assert result["correct"] is True and result["failed"] == 0 and result["attempted"] >= 1
    assert set(checks) == set(check.NUMBERS)
    assert all(set(c) == {"value", "limit"} for c in checks.values())
    want = cell.per_layer if traced else cell.end_to_end
    units = {m["name"]: m["unit"] for m in want}
    assert set(result["metrics"]) <= set(units)
    for name, m in result["metrics"].items():
        assert m["unit"] == units[name] and isinstance(m["value"], float)
    if traced:
        assert {"busy_s", "window_s"} <= set(result["device"])
        assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
    else:
        assert set(result["metrics"]) == set(units)
    json.loads(json.dumps(result))


def test_a_traffic_kind_it_does_not_run_is_refused():
    cell = tiny_cell()
    serve = dataclasses.replace(cell, traffic=dict(cell.traffic, kind="serve"))
    with pytest.raises(ValueError, match="serve"):
        run.run_cell(serve, SEED, 0.1, False, "cpu")


def frozen_step(model, opt, tokens):
    """A step that leaves its state unchanged."""
    opt.zero_grad(set_to_none=True)
    loss = lm.loss_fn(model(tokens), tokens)
    loss.backward()
    return loss.detach()


def half_batch_step(model, opt, tokens):
    """Half of the batch left out, the mean taken over the rest."""
    return lm.train_step(model, opt, tokens[: tokens.shape[0] // 2])


@pytest.mark.parametrize("broken", [frozen_step, half_batch_step],
                         ids=["state_unchanged", "half_batch"])
def test_a_broken_step_is_not_correct(monkeypatch, broken):
    cell = tiny_cell()
    monkeypatch.setattr(spec.kind_module(cell.config["kind"]), "step", broken)
    result, checks = run.run_cell(cell, SEED, 0.2, False, "cpu")
    assert result["correct"] is False
    assert any(c["value"] > c["limit"] for c in checks.values())


@pytest.mark.parametrize("name, kv_heads, batch", [("mistral7b-train-4k", 2, 2),
                                                   ("deepseek7b-train-4k", 4, 2),
                                                   ("mistral7b-train-16k", 2, 1)])
def test_control_and_faults_fail_where_the_port_passes(name, kv_heads, batch):
    cell = tiny_cell(name, kv_heads, batch)
    recs = list(calibrate.readings(cell, [SEED], [SEED], "cpu"))
    sides = {r["side"]: r for r in recs}
    assert set(sides) == {"program", "control_fp8", "half_batch"}
    assert check.judge(sides["program"], TINY_LIMITS)[0]
    assert not check.judge(sides["control_fp8"], TINY_LIMITS)[0]
    assert not check.judge(sides["half_batch"], TINY_LIMITS)[0]


def _bench(*args, cwd, env_extra=None):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", **(env_extra or {}))
    return subprocess.run([sys.executable, "-m", "perfbench.run", *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_no_card_exits_nonzero_with_no_result():
    res = _bench("--workload", "mistral7b-train-16k", "--seed", str(2 ** 31 + 99),
                 "--seconds", "1", "--trace", "0", cwd=run.ROOT)
    assert res.returncode != 0
    assert res.stdout.strip() == ""
    assert "CUDA" in res.stderr


def test_benchmark_files_alone_do_not_run(tmp_path):
    shutil.copy(run.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(run.ROOT / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    res = _bench("--workload", "mistral7b-train-4k", "--seed", "5", "--seconds", "1",
                 "--trace", "0", cwd=tmp_path, env_extra={"PYTHONPATH": str(tmp_path)})
    assert res.returncode != 0
    assert res.stdout.strip() == ""
