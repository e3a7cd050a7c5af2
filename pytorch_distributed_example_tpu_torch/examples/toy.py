"""Toy collective example — the port of the reference's `examples/toy/main.py`.

Each rank makes a one-element tensor holding its rank plus the step,
all_reduce(SUM) runs over a group of all ranks, and every step prints the
reduced value and whether every rank agrees.

The flags are the reference's (`--backend`, `--init-method`, `--rank`,
`--world-size`, `--steps`, `--schedule-check`) plus `--cpu`. Without
`--init-method` one process drives every rank (driver mode): the W ranks
are stacked on `cuda:0`, or on the CPU with `--cpu`. With it, each process
is one rank of a gang that meets at that URL (multiproc mode). It runs on
the card unless `--cpu` is given, and raises without one.

Run:  python -m pytorch_distributed_example_tpu_torch.examples.toy --world-size 8 --steps 5
"""

from __future__ import annotations

import argparse
import os
from typing import List, Optional

import torch

import pytorch_distributed_example_tpu_torch as tdx
from pytorch_distributed_example_tpu_torch.types import ReduceOp

CPU_RANKS = 8  # the reference's `--cpu` mesh: 8 virtual CPU devices


def run(world_size: int, steps: int) -> List[float]:
    """`steps` all_reduce(SUM) steps over the first `world_size` ranks;
    prints one line a step and returns the reduced values."""
    group = tdx.new_group(range(world_size)) if world_size < tdx.get_world_size() else None
    out = []
    for step in range(steps):
        t = tdx.DistTensor.from_rank_fn(
            lambda r: torch.tensor([float(r + step)], dtype=torch.float32), group
        )
        tdx.all_reduce(t, ReduceOp.SUM, group)
        vals = [v.item() for v in t.unstack()]
        expect = sum(r + step for r in range(world_size))
        print(f"step {step}: all_reduce(SUM) -> {vals[0]} (every rank agrees: "
              f"{all(v == vals[0] for v in vals)}, expect {expect})")
        out.append(vals[0])
    return out


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser()
    p.add_argument("--backend", type=str, default="xla")
    p.add_argument("--init-method", type=str, default=None,
                   help="multiproc mode: this process is rank --rank of a gang of "
                        "--world-size that meets here (tcp://, env://, file://); "
                        "omit it to drive every rank from this process")
    p.add_argument("--rank", type=int, default=0)
    p.add_argument("--world-size", type=int, default=-1)
    p.add_argument("--steps", type=int, default=5)
    p.add_argument("--cpu", action="store_true",
                   help="run the ranks on the CPU instead of the card (8 ranks "
                        "unless --world-size says otherwise, as the reference's "
                        "virtual CPU mesh)")
    p.add_argument("--schedule-check", action="store_true",
                   help="arm the cross-rank collective-schedule verifier "
                        "(TDX_SCHEDULE_CHECK=1): every collective is "
                        "fingerprinted and divergent schedules raise a "
                        "diagnostic naming the offending op instead of "
                        "hanging")
    return p.parse_args(argv)


def main(argv: Optional[List[str]] = None) -> None:
    args = parse_args(argv)
    if args.schedule_check:
        # must be set before init_process_group: the verifier is armed at
        # group creation
        os.environ["TDX_SCHEDULE_CHECK"] = "1"
    if not args.cpu and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass --cpu to run the ranks on the CPU")
    world_size = args.world_size
    if args.cpu and world_size == -1 and args.init_method is None:
        world_size = CPU_RANKS
    tdx.init_process_group(
        backend=args.backend,
        init_method=args.init_method,
        world_size=world_size,
        rank=args.rank,
        device="cpu" if args.cpu else None,
    )
    ws = tdx.get_world_size()
    print(f"initialized: backend={tdx.get_backend()} world_size={ws}")
    try:
        run(ws if args.world_size == -1 else args.world_size, args.steps)
    finally:
        tdx.destroy_process_group()


if __name__ == "__main__":
    main()
