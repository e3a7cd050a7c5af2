"""The readings the check's limits are set from, on the card at the cell's
own size. The benchmark's runs do not run this.

    python3 -m perfbench.calibrate --workload <cell> --seeds 1,2,... [--fault-seeds 1,2,3]

For each of `--seeds`: the port's first steps (the same set-up as a run)
against the float32 reference, the numbers of `check.py`. For each of
`--fault-seeds`: the same numbers of the reference put in the port's place
in the control's precision (fp8) and with half of the batch left out. A
state left unchanged reads 1 on `change_gap` and needs no run. One JSON line
a reading on standard output.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time

import torch

from perfbench import check, run, spec

FAULTS = (("control_fp8", "fp8", None), ("half_batch", "float32", "half_batch"))


def _free(device) -> None:
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)


def _numbers(got, want) -> dict:
    """`check.numbers` and, to see which step moves the loss, each step's gap."""
    gaps = [abs(a - b) for a, b in zip(got["losses"], want["losses"])]
    return {**check.numbers(got, want), "loss_gaps": gaps}


def readings(cell: spec.Cell, seeds, fault_seeds, device):
    """Yield one record a reading: {"seed", "side", numbers...}."""
    device = torch.device(device)
    for seed in dict.fromkeys(list(seeds) + list(fault_seeds)):
        t = time.perf_counter()
        want = run.reference_readings(cell, seed, device)
        ref_s = time.perf_counter() - t
        ref_peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
        _free(device)
        if seed in seeds:
            model, opt, _, got = run.setup_program(cell, seed, device)
            del model, opt
            _free(device)
            yield {"seed": seed, "side": "program", "reference_s": ref_s,
                   "reference_peak_bytes": ref_peak, **_numbers(got, want)}
        if seed in fault_seeds:
            for side, precision, fault in FAULTS:
                got = run.reference_readings(cell, seed, device, precision, fault)
                peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
                _free(device)
                yield {"seed": seed, "side": side, "reference_peak_bytes": peak,
                       **_numbers(got, want)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--fault-seeds", default="")
    args = ap.parse_args(argv)
    cell = spec.load_cell(args.workload, run.ROOT)
    if not torch.cuda.is_available():
        print("perfbench.calibrate: no CUDA device", file=sys.stderr)
        return 2
    seeds = [int(s) for s in args.seeds.split(",") if s]
    fault_seeds = [int(s) for s in args.fault_seeds.split(",") if s]
    for rec in readings(cell, seeds, fault_seeds, torch.device("cuda", 0)):
        print(json.dumps({"cell": cell.name, **rec}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
