"""Elastic DDP training — resume across dynamic world sizes; the port of
the reference's `examples/elastic/main.py`.

The torchelastic workflow (workers must tolerate restarts and
re-rendezvous at a different world size): every generation, workers
load the latest checkpoint (`checkpoint.py`), train to the target step
count, and checkpoint periodically; a worker loss re-forms the gang
(fewer ranks) and training CONTINUES from the last checkpoint instead of
restarting. The per-rank batch is fixed, so the global batch scales with
the surviving world, as torch DDP under torchelastic behaves.

Launch (single node, gang elastic between 2 and 4 workers):

    python -m pytorch_distributed_example_tpu_torch.elastic.run \\
        --standalone --nproc-per-node 2:4 \\
        -m pytorch_distributed_example_tpu_torch.examples.elastic \\
        --steps 200 --ckpt /tmp/elastic_ckpt

While it runs, `pytorch_distributed_example_tpu_torch.elastic.request_join`
against the agent's join endpoint grows the gang at the next boundary.

Each worker takes ``cuda:{LOCAL_RANK % device_count}``: on one card every
worker shares cuda:0, and the gang meets over ``"cuda:gloo"`` (nccl
refuses two ranks on one GPU); ``--cpu`` (or ``TDX_ELASTIC_CPU=1``) runs
it on the CPU over gloo. On the card TF32 is off and cuDNN deterministic,
so a run resumed at another width repeats a replay of the same steps bit
for bit. Like the reference, only the params are checkpointed: the
optimizer's momentum starts again at each resume.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch
import torch.nn.functional as F


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser()
    p.add_argument("--steps", type=int, default=120, help="TOTAL step target")
    p.add_argument("--ckpt-every", type=int, default=20)
    p.add_argument("--ckpt", default="/tmp/tdx_elastic_ckpt")
    p.add_argument("--batch-size", type=int, default=32, help="per rank")
    p.add_argument("--lr", type=float, default=0.05)
    p.add_argument("--cpu", action="store_true", help="run on the CPU over gloo")
    return p.parse_args(argv)


def rank_batch(rank: int, batch: int, device):
    """Rank `rank`'s fixed synthetic batch: NCHW images, int64 labels."""
    gen = np.random.default_rng(1234 + rank)
    x = gen.standard_normal((batch, 1, 28, 28)).astype(np.float32)
    y = gen.integers(0, 10, batch)
    return torch.from_numpy(x).to(device), torch.from_numpy(y).to(device)


def loss_fn(logits, y):
    return F.cross_entropy(logits, y)


def initial_params(device):
    """The ConvNet's params from seed 0, the same on every rank."""
    from ..models import ConvNet

    model = ConvNet(device=device, generator=torch.Generator(device).manual_seed(0))
    return model, {n: p.detach() for n, p in model.named_parameters()}


def main(argv=None) -> int:
    args = parse_args(argv)
    import pytorch_distributed_example_tpu_torch as tdx
    from .. import checkpoint, optim

    cpu = args.cpu or bool(os.environ.get("TDX_ELASTIC_CPU"))
    if cpu:
        dev, backend = torch.device("cpu"), "gloo"
    else:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: pass --cpu to train on the CPU")
        local = int(os.environ.get("LOCAL_RANK", "0"))
        dev, backend = torch.device("cuda", local % torch.cuda.device_count()), "cuda:gloo"
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cudnn.deterministic = True
    tdx.init_process_group(backend=backend, init_method="env://", device=dev)
    rank, world = tdx.get_rank(), tdx.get_world_size()
    gen = os.environ.get("TDX_RESTART_COUNT", "0")

    model, params = initial_params(dev)
    start_step = 0
    if os.path.isdir(args.ckpt):
        try:
            params, _, start_step, _ = checkpoint.load_checkpoint(args.ckpt, params)
        except Exception as e:  # fresh run or torn write: start over
            print(f"[rank {rank}] checkpoint ignored: {e}", flush=True)

    # DDP wrap AFTER the load: its broadcast makes every rank identical
    # even if only some ranks saw the checkpoint files
    ddp = tdx.DistributedDataParallel(model, params)
    opt = optim.sgd(args.lr, momentum=0.9)
    step_fn = ddp.make_train_step(opt, loss_fn)
    opt_state = opt.init(ddp.params)
    x, y = rank_batch(rank, args.batch_size, dev)

    print(f"[gen {gen}] rank {rank}/{world}: resuming at step {start_step}", flush=True)
    params_t, loss = ddp.params, None
    for step in range(start_step, args.steps):
        params_t, opt_state, loss = step_fn(params_t, opt_state, x, y)
        done = step + 1
        if done % args.ckpt_every == 0 or done == args.steps:
            if rank == 0:
                checkpoint.save_checkpoint(args.ckpt, params_t, step=done)
            tdx.barrier()  # nobody races past a torn checkpoint
    # a restart can land AFTER the final checkpoint: the resumed
    # generation then has nothing left to run — exit 0, not a crash
    loss_txt = f"{float(loss):.4f}" if loss is not None else "n/a (already complete at resume)"
    print(f"[gen {gen}] rank {rank}/{world}: reached step {args.steps}, final loss {loss_txt}",
          flush=True)
    tdx.destroy_process_group()
    return 0


if __name__ == "__main__":
    main()
