"""Repeat `DistributedDataParallel.profile_breakdown` on the DDP-MNIST
ConvNet at world 1 and 8 on the card, and print one JSON line a repeat
(`PROBE {...}`: the five times and the raw clocks, in ms).

Run from the root of a tree, on a machine with a card:
    PYTHONPATH=. python3 tests/_chip_breakdown_probe.py TAG [REPEATS]
To compare two trees, unpack one under a gitignored directory and run the
script from each root in one call, in the order A, B, B, A.
"""

import json
import sys

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

import chip_smoke as cs  # noqa: E402
import pytorch_distributed_example_tpu_torch as tdx  # noqa: E402
from pytorch_distributed_example_tpu_torch import optim  # noqa: E402
from pytorch_distributed_example_tpu_torch.examples import mnist  # noqa: E402


def main(tag: str, repeats: int = 5) -> None:
    for world in (1, cs.MNIST_WORLD):
        tdx.init_process_group(world_size=world)
        try:
            ddp = tdx.DistributedDataParallel(cs.mnist_model("cuda"))
            opt = optim.sgd(0.01, momentum=0.5)
            x, y = cs.mnist_batch(world, "cuda")
            for rep in range(repeats):
                t = ddp.profile_breakdown(opt, mnist.loss_fn, x, y,
                                          iters=cs.MNIST_BREAKDOWN_ITERS)
                c = getattr(ddp, "breakdown_clocks_s", {})
                print("PROBE " + json.dumps({
                    "tree": tag, "world": world, "rep": rep,
                    "times_ms": {k: v * 1e3 for k, v in t.items()},
                    "clocks_ms": {k: v * 1e3 for k, v in c.items()}}), flush=True)
        finally:
            tdx.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]) if len(sys.argv) > 2 else 5)
