"""Run one cell of `BENCHMARK.json` on the card and print its result.

    python3 -m perfbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. A run:

1. checks for the cards the cell asks for (exit 2 without them) and prints
   the card's name, clocks and power limit;
2. set-up: builds the port's model with the weights of `--seed`
   (through `perfbench/kinds/<kind>.py`), its optimizer, and drives that
   object through the traffic's
   first steps, which warm up every shape the window uses; the first step
   builds the flash library into the package's `build/` unless it is
   there. It reads the first step's gradients and the change of the
   weights over those steps for the check;
3. the window: a synchronise, then `train_step` on a fresh batch a step
   until `--seconds` have passed, then a synchronise. With `--trace 1` the
   profiler records a fixed run of steps inside it (`trace.py`);
4. frees the port's state, trains the plain reference
   (`perfbench/reference/<kind>.py`) over the same first steps from the
   same weights, and compares (`check.py`);
5. reads each metric of the cell (`perfbench/metrics/<name>.py`), prints
   each compared number beside its limit as the last lines of standard
   error, and the result as the last line of standard output.

It exits non-zero, and prints no result, when the cards are missing or when
`jax`, `jaxlib`, `flax` or the JAX package is loaded once the window has
closed.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import torch

from perfbench import check, flops, spec, trace

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "pytorch_distributed_example_tpu")
TRAFFIC_KINDS = ("train",)  # the traffic this runner drives: training steps


def process_age_s() -> float:
    """Seconds since this process started, from its start time in /proc:
    `setup_s` is defined from the start of the process."""
    with open("/proc/self/stat") as f:
        start = int(f.read().rsplit(")", 1)[1].split()[19]) / os.sysconf("SC_CLK_TCK")
    with open("/proc/uptime") as f:
        return float(f.read().split()[0]) - start


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def forbidden_modules() -> list:
    return sorted({name.split(".")[0] for name in sys.modules} & set(FORBIDDEN))


def card_lines() -> list:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=index,name,clocks.sm,clocks.max.sm,power.draw,"
             "power.limit,temperature.gpu", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True)
        lines = out.stdout.strip().splitlines()
    except (OSError, subprocess.SubprocessError) as e:
        lines = [f"nvidia-smi: {e}"]
    return lines + [f"{i}, total_memory {torch.cuda.get_device_properties(i).total_memory} bytes"
                    for i in range(torch.cuda.device_count())]


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _steps(kind, model, opt, tokens, device, count=None, until=None):
    """Steps through the window's call and feed: `count` of them, or until
    the host clock passes `until`. Returns (host seconds a call, losses)."""
    host, losses = [], []
    while (count is not None and len(losses) < count) or (until is not None and (
            not losses or time.perf_counter() < until)):
        x = torch.from_numpy(tokens.next()).to(device)
        t = time.perf_counter()
        losses.append(kind.step(model, opt, x))
        host.append(time.perf_counter() - t)
    return host, losses


def setup_program(cell: spec.Cell, seed: int, device):
    """The port's step object, driven through the traffic's first steps (the
    warm-up), and its readings of them for the check: (model, optimizer,
    feed, readings)."""
    kind = spec.kind_module(cell.config["kind"])
    t = cell.traffic
    marks = [("start", time.perf_counter())]
    model, opt = kind.build(cell.config, t, seed, device)
    tokens = kind.feed(cell.config, t, seed)
    _sync(device)
    marks.append(("model and optimizer", time.perf_counter()))
    _, first = _steps(kind, model, opt, tokens, device, count=1)
    grads = kind.grad_norms(model, opt, t)
    marks.append(("first step", time.perf_counter()))
    _, rest = _steps(kind, model, opt, tokens, device, count=t["checked_steps"] - 1)
    losses = [float(x) for x in first + rest]
    marks.append((f"{len(rest)} more", time.perf_counter()))
    readings = {"losses": losses, "grad_norms": grads,
                "change_norms": kind.change_norms(model, cell.config, seed, device)}
    marks.append(("readings", time.perf_counter()))
    print("perfbench: set-up of the port: " + ", ".join(
        f"{label} {b - a:.2f} s" for (_, a), (label, b) in zip(marks, marks[1:])),
        file=sys.stderr, flush=True)
    return model, opt, tokens, readings


def reference_readings(cell: spec.Cell, seed: int, device, precision="float32", fault=None):
    """The reference's readings of the first steps from the same weights and
    batches."""
    ref = spec.reference_module(cell.config["kind"])
    return ref.readings(cell.config, cell.traffic, seed, device, precision, fault)


def _window(kind, model, opt, tokens, device, seconds, traffic, traced):
    """(Window, Profile or None, losses) of the timed steps."""
    tps = traffic["batch"] * traffic["seq"]
    _sync(device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    if not traced:
        host, losses = _steps(kind, model, opt, tokens, device, until=t0 + seconds)
        _sync(device)
        return trace.Window(len(losses), time.perf_counter() - t0, host, tps), None, losses
    lead, n = traffic["trace"]["lead_steps"], traffic["trace"]["profiled_steps"]
    host, losses = _steps(kind, model, opt, tokens, device, count=lead)
    _sync(device)
    wall = time.perf_counter() - t0
    acts = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with tempfile.TemporaryDirectory(prefix="perfbench-") as tmp:
        path = os.path.join(tmp, "trace.json")
        with torch.profiler.profile(activities=acts) as prof:
            with torch.profiler.record_function(trace.MARKER):
                _, profiled = _steps(kind, model, opt, tokens, device, count=n)
                _sync(device)
        prof.export_chrome_trace(path)
        profile = trace.load_profile(path, n)
    t1 = time.perf_counter()
    host2, rest = _steps(kind, model, opt, tokens, device, until=t1 + max(
        0.0, seconds - (t1 - t0)))
    _sync(device)
    wall += time.perf_counter() - t1
    window = trace.Window(lead + len(rest), wall, host + host2, tps)
    return window, profile, losses + profiled + rest


def run_cell(cell: spec.Cell, seed: int, seconds: float, traced: bool, device) -> tuple:
    """(result, checks) of one run on `device`; the caller checked for cards."""
    if cell.traffic["kind"] not in TRAFFIC_KINDS:
        raise ValueError(f"{cell.name}: traffic of kind {cell.traffic['kind']!r}; this runner "
                         f"drives {TRAFFIC_KINDS}")
    device = torch.device(device)
    kind = spec.kind_module(cell.config["kind"])
    name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    t_build = process_age_s()
    model, opt, tokens, got = setup_program(cell, seed, device)
    _sync(device)
    setup_s = process_age_s()
    print(f"perfbench: set-up {setup_s:.2f} s: imports and card {t_build:.2f} s, the port's "
          f"model, optimizer, {cell.traffic['checked_steps']} first steps and their readings "
          f"{setup_s - t_build:.2f} s", file=sys.stderr, flush=True)
    window, profile, losses = _window(kind, model, opt, tokens, device, seconds,
                                      cell.traffic, traced)
    peak_bytes = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    failed = int((~torch.isfinite(torch.stack(losses).float())).sum())

    pk = flops.peaks(name)
    counts = kind.counts(cell.config, cell.traffic, pk)
    run = trace.Run(window, profile, counts["step_flops"], pk[0] if pk else None,
                    counts["kernel_bound_ms"], setup_s=setup_s, peak_bytes=peak_bytes)
    metrics = {}
    for m in cell.per_layer if traced else cell.end_to_end:
        value = spec.metric_reader(m["name"]).read(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        elif not traced:
            raise RuntimeError(f"end-to-end metric {m['name']} read nothing")
    dev = {"platform": "gpu" if device.type == "cuda" else device.type, "kind": name,
           "count": cell.chips, "memory_peak_bytes": int(peak_bytes)}
    result = {"correct": False, "attempted": len(losses), "failed": failed,
              "metrics": metrics, "device": dev}
    if traced:
        dev["busy_s"], dev["window_s"] = profile.busy_s(), profile.span_s
        result["breakdown"] = trace.breakdown(profile)

    del model, opt, losses
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    want = reference_readings(cell, seed, device)
    print(f"perfbench: reference {time.perf_counter() - t_ref:.2f} s, peak "
          f"{torch.cuda.max_memory_allocated(device) if device.type == 'cuda' else 0} bytes",
          file=sys.stderr, flush=True)
    values = check.numbers(got, want)
    for n in sorted(set(values) - set(cell.limits)):
        print(f"perfbench: reading {n} {values[n]!r}, not compared", file=sys.stderr, flush=True)
    correct, checks = check.judge(values, cell.limits)
    result["correct"] = correct and failed == 0
    result["checks"] = checks
    return result, checks


def main(argv=None) -> int:
    args = parse_args(argv)
    cell = spec.load_cell(args.workload, ROOT)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"perfbench: {cell.name} needs {cell.chips} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    for line in card_lines():
        print(f"perfbench: card {line}", flush=True)
    result, checks = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                              torch.device("cuda", 0))
    found = forbidden_modules()
    if found:
        print(f"perfbench: modules loaded that the benchmark may not load: {found}",
              file=sys.stderr)
        return 3
    print(f"perfbench: {cell.name} seed {args.seed} attempted {result['attempted']} "
          f"metrics {json.dumps(result['metrics'])}", flush=True)
    for n, c in checks.items():
        print(f"check {n} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
