"""The span recorder (`utils/spans.py`) at a benchmark cell's size, on the card.

    PYTHONPATH=. python3 tests/_chip_spans.py traced CELL SEED
        one `python3 -m perfbench.run --trace 1` run of CELL (its result line
        as the benchmark prints it), then `SPANS {...}`: the recorder's
        summary of the profiled steps, every span's forward, backward and
        inclusive ms a step; and `GC {...}`: the run's longest garbage
        collections (generation, ms).
    PYTHONPATH=. python3 tests/_chip_spans.py cost CELL [STEPS]
        the recorder's cost: the cell's model and AdamW from seed 0, three
        warm-up steps, then STEPS (default 20) steps with the recorder off
        and STEPS inside `spans.recording()`, interleaved (off/on, then
        on/off), each step timed alone, a synchronise before and after;
        prints `COST {...}`: wall ms a step and host ms a call, both ways;
        then `HOST` lines: cProfile's costliest calls over 3 steps each way.
    PYTHONPATH=. python3 tests/_chip_spans.py kernels CELL
        the outside view of the same spans: 2 steps under `torch.profiler`,
        each kernel charged to the innermost `tdx.*` range open on the
        thread that launched it (by the trace's correlation ids); prints
        `KERNELS {...}`: kernel ms a step by range beside the recorder's
        own ms a step (stream time, gaps included) for the same steps. The
        autograd thread opens no phase range: what it launches between two
        brackets counts as outside any range (the recorder's `tdx.backward`).

Run from the root of a tree, on a machine with a card. To compare two trees,
unpack one under a gitignored directory and run the script from each root.
"""

import contextlib
import cProfile
import gc
import io
import json
import os
import pstats
import statistics
import subprocess
import sys
import tempfile
import time

import torch

from perfbench import run, spec
from pytorch_distributed_example_tpu_torch.utils import spans


def traced(cell: str, seed: int) -> None:
    pauses, started = [], {}

    def on_gc(phase, info):
        if phase == "start":
            started["t"] = time.perf_counter()
        else:
            pauses.append((info["generation"], (time.perf_counter() - started["t"]) * 1e3))

    gc.callbacks.append(on_gc)
    rc = run.main(["--workload", cell, "--seed", str(seed), "--seconds", "20", "--trace", "1"])
    gc.callbacks.remove(on_gc)
    print("GC " + json.dumps({"collections": len(pauses),
                              "longest": sorted(pauses, key=lambda p: -p[1])[:6]}), flush=True)
    s = spans.summary()
    steps = max(s["steps"], 1)
    per_step = {k: {f: v[f] / steps for f in ("forward_ms", "backward_ms", "inclusive_ms")}
                | {"calls": v["calls"] / steps} for k, v in s["spans"].items()}
    print("SPANS " + json.dumps({"cell": cell, "seed": seed, "steps": s["steps"],
                                 "spans": per_step}), flush=True)
    sys.exit(rc)


def _built(cell: str):
    """(step(), the cell's model and AdamW from seed 0 after 3 warm-up
    steps): step() runs one step on the next batch."""
    c = spec.load_cell(cell, run.ROOT)
    kind = spec.kind_module(c.config["kind"])
    dev = torch.device("cuda", 0)
    model, opt = kind.build(c.config, c.traffic, 0, dev)
    tokens = kind.feed(c.config, c.traffic, 0)

    def step():
        return kind.step(model, opt, torch.from_numpy(tokens.next()).to(dev))

    for _ in range(3):
        step()
    torch.cuda.synchronize(dev)
    return step


def cost(cell: str, steps: int) -> None:
    one = _built(cell)
    dev = torch.device("cuda", 0)
    times = {"off": ([], []), "on": ([], [])}

    def step(on: bool):
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        if on:
            with spans.recording():
                one()
        else:
            one()
        t1 = time.perf_counter()
        torch.cuda.synchronize(dev)
        t2 = time.perf_counter()
        wall, host = times["on" if on else "off"]
        wall.append((t2 - t0) * 1e3)
        host.append((t1 - t0) * 1e3)

    spans.reset()
    for i in range(steps):
        for on in ((False, True) if i % 2 == 0 else (True, False)):
            step(on)
    s = spans.summary()
    out = {"cell": cell, "steps": steps, "recorded_steps": s["steps"]}
    for way, (wall, host) in times.items():
        out[way] = {"wall_ms_median": statistics.median(wall), "wall_ms_mean": statistics.fmean(wall),
                    "host_ms_median": statistics.median(host), "host_ms_mean": statistics.fmean(host)}
    out["wall_cost_pct"] = 100 * (out["on"]["wall_ms_median"] / out["off"]["wall_ms_median"] - 1)
    out["host_cost_ms"] = out["on"]["host_ms_median"] - out["off"]["host_ms_median"]
    print("COST " + json.dumps(out), flush=True)
    for on in (False, True):
        prof = cProfile.Profile()
        with spans.recording() if on else contextlib.nullcontext():
            prof.enable()
            for _ in range(3):
                one()
            prof.disable()
        torch.cuda.synchronize(dev)
        text = io.StringIO()
        pstats.Stats(prof, stream=text).sort_stats("tottime").print_stats(14)
        for line in text.getvalue().splitlines():
            if line.strip():
                print(f"HOST {'on' if on else 'off'} {line}", flush=True)


def kernels(cell: str) -> None:
    one = _built(cell)
    steps = 2
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    spans.reset()
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(steps):
            one()
        torch.cuda.synchronize()
    own = spans.summary()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]
    ranges, launches = {}, {}
    for e in events:
        if e.get("cat") == "user_annotation" and e["name"].startswith("tdx."):
            ranges.setdefault(e["tid"], []).append((e["ts"], e["ts"] + e["dur"], e["name"]))
        elif e.get("cat") in ("cuda_runtime", "cuda_driver") and "correlation" in e.get("args", {}):
            launches[e["args"]["correlation"]] = (e["tid"], e["ts"])
    by = {}
    for e in events:
        if e.get("cat") not in ("kernel", "gpu_memcpy", "gpu_memset"):
            continue
        tid, ts = launches.get(e.get("args", {}).get("correlation"), (None, None))
        inner = None if ts is None else max(
            (r for r in ranges.get(tid, ()) if r[0] <= ts < r[1]), default=None)
        name = "outside any tdx range" if inner is None else inner[2]
        if name.endswith(".backward") and name != "tdx.backward":  # a region's bracket
            name = name.removesuffix(".backward")
        by[name] = by.get(name, 0.0) + e["dur"] * 1e-3 / steps
    mine = {k: (v["forward_ms"] + v["backward_ms"]) / max(own["steps"], 1)
            for k, v in own["spans"].items()}
    print("KERNELS " + json.dumps({"cell": cell, "steps": own["steps"], "kernel_ms": by,
                                   "recorder_own_ms": mine}), flush=True)


if __name__ == "__main__":
    print("card " + subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip(), flush=True)
    if sys.argv[1] == "traced":
        traced(sys.argv[2], int(sys.argv[3]))
    elif sys.argv[1] == "kernels":
        kernels(sys.argv[2])
    else:
        cost(sys.argv[2], int(sys.argv[3]) if len(sys.argv) > 3 else 20)
