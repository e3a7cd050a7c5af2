"""The readers of device time by model region, on a canned recorder summary."""

import pytest

from perfbench import spec, trace
from perfbench.tests.test_perfbench_imports import FORBIDDEN, PORT, top_level_modules
from pytorch_distributed_example_tpu_torch.utils import spans

STEPS = 3
PHASES = {"forward_ms": "forward", "backward_ms": "backward", "optimizer_ms": "optimizer"}
REGIONS = {"linear_ms": "gemm", "cast_ms": "cast", "norm_ms": "norm", "rope_ms": "rope",
           "gqa_copy_ms": "gqa_copy", "attention_ms": "attention", "swiglu_ms": "swiglu",
           "embed_ms": "embed", "loss_ms": "loss"}


def canned(steps=STEPS) -> dict:
    """A summary of `steps` steps: region i takes (i + 1) ms forward and
    2 (i + 1) ms backward a step; the phases hold them and 5 ms of their own."""
    out = {}
    for i, name in enumerate(REGIONS.values()):
        out[f"tdx.{name}"] = {"calls": 4 * steps, "forward_ms": (i + 1) * steps,
                              "backward_ms": 2 * (i + 1) * steps,
                              "inclusive_ms": 3 * (i + 1) * steps}
    for name, ms in (("forward", 100.0), ("backward", 200.0), ("optimizer", 30.0),
                     ("step", 340.0)):
        out[f"tdx.{name}"] = {"calls": steps, "forward_ms": 5.0 * steps, "backward_ms": 0.0,
                              "inclusive_ms": ms * steps}
    return {"steps": steps, "spans": out}


def run_of(steps=STEPS):
    window = trace.Window(steps=10, wall_s=1.0, host_step_s=[0.01], tokens_per_step=8)
    profile = trace.Profile(steps=steps, t0=0.0, t1=1e6, device_ops=[])
    return trace.Run(window, profile, 1e12, 1e14, None)


def read(name, run):
    return spec.metric_reader(name).read(run)


@pytest.fixture
def summary(monkeypatch):
    box = {"s": canned()}
    monkeypatch.setattr(spans, "summary", lambda: box["s"])
    return box


@pytest.mark.parametrize("metric", sorted(REGIONS))
def test_region_readers(summary, metric):
    i = list(REGIONS).index(metric)
    assert read(metric, run_of()) == pytest.approx(3.0 * (i + 1))


@pytest.mark.parametrize("metric,ms", [("forward_ms", 100.0), ("backward_ms", 200.0),
                                       ("optimizer_ms", 30.0)])
def test_phase_readers_are_inclusive(summary, metric, ms):
    assert read(metric, run_of()) == pytest.approx(ms)


@pytest.mark.parametrize("metric", sorted({**REGIONS, **PHASES}))
def test_nothing_unless_the_profiled_steps_were_recorded(summary, metric):
    summary["s"] = canned(steps=0)
    assert read(metric, run_of()) is None
    summary["s"] = canned(steps=STEPS + 1)  # steps outside the profile
    assert read(metric, run_of()) is None
    summary["s"] = canned()
    untraced = run_of()
    untraced.profile = None
    assert read(metric, untraced) is None


def test_a_region_not_entered_reads_nothing(summary):
    del summary["s"]["spans"]["tdx.gqa_copy"]  # MHA: no GQA copies
    assert read("gqa_copy_ms", run_of()) is None
    assert read("norm_ms", run_of()) is not None


def test_a_port_without_the_recorder_reads_nothing(monkeypatch):
    import sys

    from pytorch_distributed_example_tpu_torch import utils

    monkeypatch.delattr(utils, "spans")
    monkeypatch.setitem(sys.modules, spans.__name__, None)  # importing it raises
    for metric in {**REGIONS, **PHASES}:
        assert read(metric, run_of()) is None


def test_the_readers_load_no_jax():
    names = ", ".join(repr(n) for n in sorted({**REGIONS, **PHASES}))
    mods = top_level_modules(f"from perfbench import spec\nfor n in ({names},): "
                             "spec.metric_reader(n)\n")
    assert not mods & set(FORBIDDEN)
    assert PORT not in mods  # the recorder loads when a reader reads, not before
