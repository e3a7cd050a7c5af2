"""Device time by model region, from the port's span recorder
(`pytorch_distributed_example_tpu_torch/utils/spans.py`).

The recorder is on while the runner's profiler records, so its totals cover
the profiled steps: each region's forward and its backward bracket, and each
phase of `train_step`, in stream time between CUDA events at their
boundaries, charged to the innermost span. A reading belongs to the profiled
steps only when the recorder counted as many steps as the profile holds;
otherwise, and with a port that has no recorder, there is nothing to read.
"""


def summary(run):
    """The recorder's totals over the profiled steps, or None."""
    p = run.profile
    if p is None:
        return None
    try:
        from pytorch_distributed_example_tpu_torch.utils import spans
    except ImportError:
        return None
    s = spans.summary()
    return s if s["steps"] == p.steps and s["steps"] > 0 else None


def region_ms(run, name: str):
    """Device ms a step in the region `name`, forward and backward."""
    s = summary(run)
    r = s and s["spans"].get(f"tdx.{name}")
    if not r or r["calls"] == 0:
        return None
    return (r["forward_ms"] + r["backward_ms"]) / s["steps"]


def phase_ms(run, name: str):
    """Device ms a step from the phase `name`'s opening to its closing."""
    s = summary(run)
    r = s and s["spans"].get(f"tdx.{name}")
    if not r or r["calls"] == 0:
        return None
    return r["inclusive_ms"] / s["steps"]
