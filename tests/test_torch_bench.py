"""The port's bench (`pytorch_distributed_example_tpu_torch/bench.py`)
against the reference's root `bench.py`, on the CPU.

The reference's `_bench_mfu` returns zeros off a TPU, so its pieces are
held to the port's, not its output: the MFU model's param count (the
reference's `TransformerLM` through `jax.eval_shape` of `init`, nothing
materialised), the analytic FLOP formula, and `_mfu_loss` on the same
weights (`models/convert.py`'s `from_flax`; the reference's flash in
interpret mode, the port's plain versions), float32 within rtol 1e-5.
The step itself is `examples/lm.py`'s `train_step`, which
`tests/test_torch_train.py` holds to the reference's step. The one-line
report must carry the reference's keys (read from its source with `ast`)
and the port's own, nothing else.

Every test runs under one intra-op thread: the tensors are small, and the
test runner's workers share the machine's cores.
"""

import ast
import importlib
import json
import math
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_distributed_example_tpu.models import transformer as jtr
from pytorch_distributed_example_tpu_torch import bench
from pytorch_distributed_example_tpu_torch.models import convert, transformer as ttr
from tests._mp_util import REPO
from tests._tf32x3_emulation import one_thread

REF_BENCH = os.path.join(REPO, "bench.py")

# the small configuration: d 128, 2 layers, 4 heads of 32, L 64, B 2, float32
SMALL = dict(vocab_size=512, d_model=128, n_layers=2, n_heads=4)
SMALL_B, SMALL_L = 2, 64
SMALL_MFU = dict(batch=SMALL_B, seq=SMALL_L, warmup=1, steps=2, peak=1e12,
                 model_overrides=dict(SMALL, dtype=torch.float32))
SMALL_MNIST = dict(batch_per_rank=4, warmup=1, steps=2, windows=2)
LOSS_RTOL = 1e-5

# keys of the port's line that the reference's has not
PORT_ONLY = {"flash_launches", "n_params", "model_flops_per_step", "step_ms", "device"}
# keys of the reference's line that only some runs show, and which
ONLY_WHEN = {
    "fused_steps_samples_per_sec_per_chip": "the DDP phase's steps a call > 1",
    "fused_steps_meta": "the DDP phase's steps a call > 1",
    "mfu_steps_per_dispatch": "the MFU phase's steps a call > 1",
    "breakdown_ms": "BENCH_BREAKDOWN",
    "breakdown_error": "a failed breakdown",
    "flash_error": "the reference's dense fallback; the port raises",
    "cpu_flags": "the reference's XLA:CPU fallback",
    "committed_tpu_evidence": "the reference's XLA:CPU fallback",
    "init_attempts": "the reference's JAX platform acquisition",
    "init_errors": "the reference's JAX platform acquisition",
    "persist_error": "the reference's TPU evidence in benchmarks/results.json",
}


@pytest.fixture(autouse=True)
def _one_thread():
    with one_thread():
        yield


@pytest.fixture(scope="module")
def ref_bench():
    sys.path.insert(0, REPO)
    try:
        yield importlib.import_module("bench")
    finally:
        sys.path.remove(REPO)


def _dict_keys(node):
    return {k.value for k in node.keys if isinstance(k, ast.Constant)}


def _ref_line_keys():
    """Every key the reference's `main` can put in its line: the `partial`
    dict, the per-step run meta `_bench_ddp_mnist` returns last, `out`'s
    updates and stores, and `_bench_mfu`'s `flash_info`."""
    tree = ast.parse(open(REF_BENCH).read())
    funcs = {n.name: n for n in tree.body if isinstance(n, ast.FunctionDef)}
    keys = set()
    for fn, names in (("main", {"partial", "out", "run_meta"}), ("_bench_mfu", {"flash_info"})):
        for node in ast.walk(funcs[fn]):
            if isinstance(node, ast.Assign):
                for t in node.targets:
                    if isinstance(t, ast.Name) and t.id in names and isinstance(node.value,
                                                                                ast.Dict):
                        keys |= _dict_keys(node.value)
                    if (isinstance(t, ast.Subscript) and isinstance(t.value, ast.Name)
                            and t.value.id in names and isinstance(t.slice, ast.Constant)):
                        keys.add(t.slice.value)
            if (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
                    and node.func.attr == "update" and isinstance(node.func.value, ast.Name)
                    and node.func.value.id in names):
                keys |= {kw.arg for kw in node.keywords if kw.arg}
    last = max((n for n in ast.walk(funcs["_bench_ddp_mnist"]) if isinstance(n, ast.Return)),
               key=lambda n: n.lineno)
    keys |= _dict_keys(last.value.elts[1])
    return keys - {"partial"}


def _ref_param_count(seq, use_flash=True, **kw):
    cfg = jtr.TransformerConfig(max_seq_len=seq, use_flash=use_flash, **kw)
    shapes = jax.eval_shape(jtr.TransformerLM(cfg).init, jax.random.PRNGKey(0),
                            jax.ShapeDtypeStruct((1, seq), jnp.int32))
    return sum(math.prod(x.shape) for x in jax.tree.leaves(shapes))


def _port_param_count(seq, **kw):
    cfg = ttr.TransformerConfig(max_seq_len=seq, **kw)
    return sum(p.numel() for p in ttr.TransformerLM(cfg, device="meta").parameters())


def test_the_line_reader_sees_the_reference_line():
    keys = _ref_line_keys()
    assert {"metric", "value", "vs_baseline", "mfu", "hfu", "flash_block_q", "windows",
            "memory", "dispatch_mode", "hfu_note", "breakdown_ms"} <= keys
    assert set(ONLY_WHEN) <= keys and not PORT_ONLY & keys


def test_mfu_model_has_the_reference_param_count():
    """The reference's MFU configuration, bf16 with flash, as `_bench_mfu`
    builds it, against `mfu_setup`'s model."""
    ref = _ref_param_count(bench.MFU_SEQ, dtype=jnp.bfloat16, **bench.MFU_MODEL)
    cfg = bench.mfu_config()
    model = ttr.TransformerLM(cfg, device="meta")
    assert sum(p.numel() for p in model.parameters()) == ref == 58_466_816
    assert (cfg.vocab_size, cfg.d_model, cfg.n_layers, cfg.n_heads, cfg.max_seq_len) == (
        32000, 512, 8, 8, 512)
    assert cfg.head_dim == 64 and cfg.dtype == torch.bfloat16 and cfg.use_flash


def test_small_model_param_count_and_flops_match_the_reference():
    n = _ref_param_count(SMALL_L, **SMALL)
    assert _port_param_count(SMALL_L, **SMALL) == n
    cfg = ttr.TransformerConfig(max_seq_len=SMALL_L, **SMALL)
    # the reference's formula, `bench.py:656-659`
    want = (6.0 * n + 12.0 * SMALL["n_layers"] * SMALL["d_model"] * SMALL_L) * SMALL_B * SMALL_L
    assert bench.model_flops_per_step(n, cfg, SMALL_B, SMALL_L) == want


def test_mfu_loss_matches_the_reference(ref_bench):
    jmodel = jtr.TransformerLM(jtr.TransformerConfig(max_seq_len=SMALL_L, **SMALL))
    toks = np.random.default_rng(0).integers(0, SMALL["vocab_size"], (SMALL_B, SMALL_L))
    toks = toks.astype(np.int32)
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(0), jnp.asarray(toks))
    want = float(jax.jit(lambda p, t: ref_bench._mfu_loss(jmodel, p, t))(params, toks))
    tmodel = ttr.TransformerLM(ttr.TransformerConfig(max_seq_len=SMALL_L, **SMALL),
                               device="cpu")
    tmodel.load_state_dict(convert.from_flax(jax.tree.map(np.asarray, params)))
    with torch.no_grad():
        got = float(bench.mfu_loss(tmodel, torch.from_numpy(toks).long()))
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)


@pytest.mark.parametrize("K", [1, 2])
def test_mfu_phase_on_the_cpu_returns_every_key(K):
    out = bench.bench_transformer_mfu(device="cpu", breakdown=True, steps_per_call=K,
                                      **SMALL_MFU)
    n = _ref_param_count(SMALL_L, **SMALL)
    cfg = ttr.TransformerConfig(max_seq_len=SMALL_L, **SMALL)
    assert out["n_params"] == n
    assert out["model_flops_per_step"] == bench.model_flops_per_step(n, cfg, SMALL_B, SMALL_L)
    want = {"mfu", "mfu_tflops", "hfu", "flash_used", "flash_block_q", "flash_block_k",
            "peak_calibration", "mfu_final_loss", "timing", "hfu_note", "breakdown_ms",
            *PORT_ONLY} | ({"mfu_steps_per_dispatch"} if K > 1 else set())
    assert set(out) == want
    assert out["flash_used"] and out["timing"] == "readback_barrier"
    # on the CPU the plain versions run, at their own blocks, and launch nothing
    assert (out["flash_block_q"], out["flash_block_k"]) == bench.resolved_block_sizes(SMALL_L)
    assert set(out["flash_launches"]) == set(bench.ROUTE_LAUNCHES)
    assert not any(out["flash_launches"].values())
    assert out["mfu"] > 0 and out["hfu"] > 0 and out["step_ms"] > 0
    assert math.isfinite(out["mfu_final_loss"]) and out["mfu_final_loss"] < math.log(512)
    assert out["mfu"] == pytest.approx(out["model_flops_per_step"] / (out["step_ms"] / 1e3)
                                       / SMALL_MFU["peak"])
    assert out["peak_calibration"]["peak_source"] == "caller"
    assert set(out["breakdown_ms"]) == {"fwd", "fwd_bwd", "full_step"}
    assert all(v > 0 for v in out["breakdown_ms"].values())


def test_peak_table_picks_the_card():
    assert bench.peak_flops("NVIDIA H100 PCIe") == 756e12
    assert bench.peak_flops("NVIDIA H100 NVL") == 835e12
    assert bench.peak_flops("NVIDIA H100 80GB HBM3") == 989e12
    assert bench.peak_flops("TPU v5 lite") == 0.0


def test_calibrated_peak_keeps_the_larger_rate(monkeypatch):
    monkeypatch.setattr(bench, "_CALIBRATION_CACHE", {})
    # a name the table does not know: the measured chain is the peak
    peak, meta = bench.calibrated_peak("cpu", n=64, reps=4)
    assert meta["peak_source"] == "calibrated_matmul_lower_bound"
    assert meta["nominal_peak_tflops"] == 0.0 and "calibration_error" not in meta
    assert peak > 0 and round(peak / 1e12, 1) == meta["measured_matmul_tflops"]
    assert bench.calibrated_peak("cpu", n=64, reps=4) == (peak, meta)  # cached by name
    # the H100's spec sheet beats anything this CPU measures
    monkeypatch.setattr(bench, "_device_name", lambda device: "NVIDIA H100 80GB HBM3")
    peak, meta = bench.calibrated_peak("cpu", n=64, reps=4)
    assert peak == 989e12 and meta["peak_source"] == "spec_sheet"
    assert meta["nominal_peak_tflops"] == 989.0


def test_mfu_phase_needs_a_card_or_a_peak(monkeypatch):
    with pytest.raises(ValueError, match="pass peak="):
        bench.bench_transformer_mfu(device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench.bench_transformer_mfu()


def test_a_failing_flash_forward_raises_and_builds_no_dense_model(monkeypatch):
    built = []

    class Failing(ttr.TransformerLM):
        def __init__(self, cfg, *args, **kw):
            built.append(cfg.use_flash)
            super().__init__(cfg, *args, **kw)

        def forward(self, tokens):
            raise RuntimeError("flash kernel failed")

    monkeypatch.setattr(bench, "TransformerLM", Failing)
    with pytest.raises(RuntimeError, match="flash kernel failed"):
        bench.bench_transformer_mfu(device="cpu", **SMALL_MFU)
    assert built == [True]


def test_headline_line_has_the_reference_keys(tmp_path):
    """Both phases at world 2 in driver mode on the CPU, the DDP phase's
    fused row and the MFU phase's two steps a call, under BENCH_TRACE's
    profiler: the line has the reference's keys, less those this run
    cannot show, and the port's own; `vs_baseline` comes from the given
    file."""
    baseline = tmp_path / "baseline.json"
    baseline.write_text(json.dumps({"samples_per_sec_per_chip": 1000.0}))
    line = bench.run_headline(
        2, 2, SMALL_MNIST, dict(SMALL_MFU, breakdown=True, steps_per_call=2),
        baseline_path=str(baseline), device="cpu", trace_dir=str(tmp_path / "trace"))
    assert json.loads(json.dumps(line)) == line
    assert set(line) == (_ref_line_keys() - (set(ONLY_WHEN) - {
        "fused_steps_samples_per_sec_per_chip", "fused_steps_meta", "mfu_steps_per_dispatch",
        "breakdown_ms"})) | PORT_ONLY
    assert line["metric"] == "ddp_mnist_samples_per_sec_per_chip"
    assert line["unit"] == "samples/s/chip" and line["world"] == 2
    assert line["value"] > 0
    assert line["vs_baseline"] == pytest.approx(line["value"] / 1000.0, abs=1e-3)
    assert line["platform"] == "cpu" and line["device_kind"] == "cpu"
    assert line["fused_steps_meta"]["steps_per_dispatch"] == 2
    assert line["mfu_steps_per_dispatch"] == 2 and line["mfu"] > 0
    # the DDP phase's timed windows were traced, once
    traces = os.listdir(tmp_path / "trace")
    assert len(traces) == 1 and json.load(open(tmp_path / "trace" / traces[0]))
    # without the baseline file there is nothing to compare with
    missing = bench.headline_line({**_mnist_result(line)}, None, str(tmp_path / "none.json"))
    assert missing["vs_baseline"] == 0.0


def _mnist_result(line):
    return {"samples_per_s_per_device": line["value"], "world": line["world"],
            "windows": line["windows"], "warmup": line["warmup"], "steps": line["steps"],
            "final_loss": line["final_loss"], "memory": line["memory"], "device": "cpu"}


def test_a_failed_mfu_phase_prints_the_partial_line_and_exits_1(monkeypatch, tmp_path, capsys):
    def fail(**kw):
        raise RuntimeError("no kernel")

    monkeypatch.setattr(bench, "bench_transformer_mfu", fail)
    with pytest.raises(bench.HeadlineError) as failed:
        bench.run_headline(2, 1, SMALL_MNIST, {}, baseline_path=str(tmp_path / "b.json"),
                           device="cpu")
    line = failed.value.line
    assert line["phase"] == "mfu" and line["error"] == "RuntimeError: no kernel"
    assert line["value"] > 0 and "mfu" not in line and "windows" in line
    assert not bench.dist.is_initialized()  # the DDP phase's group is gone

    # main prints that line and exits 1 (the reference exits 0 with mfu 0)
    def raise_it(*args, **kw):
        raise failed.value

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(bench, "run_headline", raise_it)
    with pytest.raises(SystemExit) as exit_:
        bench.main([])
    assert exit_.value.code == 1
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == line


def test_main_passes_the_reference_variables(monkeypatch):
    seen = {}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(bench, "run_headline", lambda *a, **kw: seen.update(args=a, kw=kw))
    for var, value in (("BENCH_MFU_BATCH", "4"), ("BENCH_MFU_SEQ", "256"),
                       ("BENCH_MFU_WARMUP", "2"), ("BENCH_MFU_STEPS", "9"),
                       ("BENCH_MFU_SCAN", "3"), ("BENCH_BREAKDOWN", "1"),
                       ("BENCH_TRACE", "/trace")):
        monkeypatch.setenv(var, value)
    bench.main(["--world-size", "4"])
    assert seen["args"] == (4, 1)
    assert seen["kw"] == {"trace_dir": "/trace", "mfu_kw": dict(
        batch=4, seq=256, warmup=2, steps=9, steps_per_call=3, breakdown=True)}


def test_main_without_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench.main([])
