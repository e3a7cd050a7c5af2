"""ResNet-18 / CIFAR-10 DDP training: the port of the reference's
`examples/cifar/main.py` (`BASELINE.json` config #3).

ResNet-18 (NHWC in, SyncBatchNorm) on synthetic CIFAR made from the
reference's numpy seeds, one `DistributedSampler` a rank with the ranks'
microbatches packed rank-major into the global batch, SGD with momentum,
and a summed-correct eval. The train step is the reference's `local_step`:
each rank's loss and gradients come from `vmap` over the ranks of
`grad_and_value` of the functional forward, the norms' statistics
averaged over the ranks inside it (`models/resnet.py`), the gradients and
the loss reduced by the port's c10d AVG all-reduce, the running statistics
taken from the synced forward.

Driver mode: one process drives every rank, on `cuda:0`, or on the CPU
with `--cpu`; `--world-size -1` means 8 ranks on the card and 2 with
`--cpu`. Multiproc mode (`--init-method`, with `--rank` and
`--world-size`): one process a rank, each loading its own rank's
batches; the norms' statistics are all-reduced over the gang inside the
forward (`models/resnet.py`). Processes that share one card pass
`--backend cuda:gloo` (nccl refuses two ranks on one GPU). It runs on the
card unless `--cpu` is given, and raises without one.

Run:  python -m pytorch_distributed_example_tpu_torch.examples.cifar --epochs 2 --batch-size 128
      python -m pytorch_distributed_example_tpu_torch.examples.cifar --cpu \
          --init-method tcp://127.0.0.1:29512 --rank R --world-size 2   (each R)
"""

from __future__ import annotations

import argparse
import time
from typing import List, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch.func import functional_call, grad_and_value, vmap

import pytorch_distributed_example_tpu_torch as tdx
from pytorch_distributed_example_tpu_torch import distributed as dist
from pytorch_distributed_example_tpu_torch import optim
from pytorch_distributed_example_tpu_torch.data import DistributedSampler
from pytorch_distributed_example_tpu_torch.mesh import DeviceMesh
from pytorch_distributed_example_tpu_torch.models import ResNet18, convert_sync_batchnorm
from pytorch_distributed_example_tpu_torch.nn.functional import RANKS
from pytorch_distributed_example_tpu_torch.tensor import DistTensor
from pytorch_distributed_example_tpu_torch.types import ReduceOp

CARD_RANKS = 8
CPU_RANKS = 2


def synthetic_cifar(n: int, seed: int):
    """The reference's synthetic CIFAR: NHWC float32 images, labels from a
    fixed random linear map."""
    gen = np.random.default_rng(seed)
    x = gen.standard_normal((n, 32, 32, 3)).astype(np.float32)
    w = gen.standard_normal((32 * 32 * 3, 10)).astype(np.float32)
    y = (x.reshape(n, -1) @ w).argmax(1).astype(np.int32)
    return x, y


def make_train_step(model, optimizer, group=None):
    """`step(params, stats, opt_state, x, y) -> (params, stats, opt_state,
    loss)`: params and stats (the running buffers) dicts of tensors on the
    group's device; x (global batch, 32, 32, 3) NHWC and y int64 labels,
    rank-major; loss the mean over ranks."""
    g = dist._resolve(group)
    n_local = len(dist._local_rows(g))
    ranks_mesh = DeviceMesh.from_group(g, RANKS)  # SyncBN's ranks (multiproc: the group)

    def objective(params, stats, x, y):
        logits, new = functional_call(model, {**params, **stats}, (x,), {"train": True})
        return F.cross_entropy(logits, y), new

    per_rank = vmap(grad_and_value(objective, has_aux=True), in_dims=(None, None, 0, 0))

    def step(params, stats, opt_state, x, y):
        xs = x.reshape((n_local, -1) + tuple(x.shape[1:]))
        ys = y.reshape(n_local, -1)
        with ranks_mesh:
            grads, (losses, new) = per_rank(params, stats, xs, ys)
        names = list(params)
        flat = DistTensor.wrap(torch.cat([grads[n].reshape(n_local, -1) for n in names], 1), g)
        dist.all_reduce(flat, ReduceOp.AVG, g)
        row, red, off = flat.tensor[0], {}, 0
        for n in names:
            k = params[n].numel()
            red[n] = row[off:off + k].reshape(params[n].shape)
            off += k
        loss = DistTensor.wrap(losses, g)
        dist.all_reduce(loss, ReduceOp.AVG, g)
        updates, opt_state = optimizer.update(red, opt_state, params)
        params = optim.apply_updates(params, updates)
        return params, {n: v[0] for n, v in new.items()}, opt_state, loss.tensor[0]

    return step


def make_eval_step(model, group=None):
    """`evaluate(params, stats, x, y) -> correct`: the ranks' correct
    counts summed by the c10d SUM all-reduce (the reference's psum)."""
    g = dist._resolve(group)
    n_local = len(dist._local_rows(g))

    def local(params, stats, x, y):
        logits = functional_call(model, {**params, **stats}, (x,))
        return (logits.argmax(-1) == y).sum()

    per_rank = vmap(local, in_dims=(None, None, 0, 0))

    def evaluate(params, stats, x, y):
        with torch.no_grad():
            correct = per_rank(params, stats, x.reshape((n_local, -1) + tuple(x.shape[1:])),
                               y.reshape(n_local, -1))
        c = DistTensor.wrap(correct, g)
        dist.all_reduce(c, ReduceOp.SUM, g)
        return c.tensor[0]

    return evaluate


def build(device, dtype=torch.float32, seed: int = 0):
    """ResNet-18 (10 classes) with SyncBatchNorm, initialized on the CPU
    from `seed` (the same params on every device) and moved to `device`."""
    model = ResNet18(num_classes=10, dtype=dtype, device="cpu",
                     generator=torch.Generator().manual_seed(seed)).to(device)
    return convert_sync_batchnorm(model, axis_name="_ranks")


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser()
    p.add_argument("--backend", default="xla")
    p.add_argument("--init-method", default=None,
                   help="multiproc mode: this process is rank --rank of a gang of "
                        "--world-size that meets at this URL")
    p.add_argument("--world-size", type=int, default=-1)
    p.add_argument("--rank", type=int, default=-1)
    p.add_argument("--epochs", type=int, default=2)
    p.add_argument("--batch-size", type=int, default=128, help="per-rank batch")
    p.add_argument("--lr", type=float, default=0.1)
    p.add_argument("--momentum", type=float, default=0.9)
    p.add_argument("--train-size", type=int, default=4096)
    p.add_argument("--test-size", type=int, default=1024)
    p.add_argument("--bf16", action="store_true")
    p.add_argument("--cpu", action="store_true",
                   help="run the ranks on the CPU instead of the card")
    return p.parse_args(argv)


def main(argv: Optional[List[str]] = None) -> dict:
    args = parse_args(argv)
    if not args.cpu and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass --cpu to run the ranks on the CPU")
    if not args.cpu:
        # float32 as the reference computes it: no TF32 in the convolutions or matmuls
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    device = "cpu" if args.cpu else None
    if args.init_method is not None:  # multiproc: the gang's world size and this rank
        pg = tdx.init_process_group(backend=args.backend, init_method=args.init_method,
                                    world_size=args.world_size, rank=args.rank, device=device)
    else:
        world = args.world_size if args.world_size != -1 else (
            CPU_RANKS if args.cpu else CARD_RANKS)
        pg = tdx.init_process_group(backend=args.backend, world_size=world, device=device)
    try:
        W, device = tdx.get_world_size(), pg.device
        local = dist._local_rows(pg)  # the ranks whose batches this process loads
        print(f"backend={tdx.get_backend()} world_size={W} device={device}")
        dtype = torch.bfloat16 if args.bf16 else torch.float32
        model = build(device, dtype)
        params, stats = model.params_and_stats()
        opt = optim.sgd(args.lr, momentum=args.momentum)
        opt_state = opt.init(params)
        step = make_train_step(model, opt, pg)
        evaluate = make_eval_step(model, pg)

        xtr, ytr = synthetic_cifar(args.train_size, 0)
        xte, yte = synthetic_cifar(args.test_size, 1)
        samplers = [DistributedSampler(range(len(xtr)), num_replicas=W, rank=r, shuffle=True)
                    for r in local]
        losses, epochs = [], []
        for epoch in range(1, args.epochs + 1):
            for s in samplers:
                s.set_epoch(epoch)
            idx = [list(iter(s)) for s in samplers]
            steps = min(len(ix) for ix in idx) // args.batch_size
            t0 = time.perf_counter()
            train_loss = 0.0
            for b in range(steps):
                rows = np.concatenate([ix[b * args.batch_size:(b + 1) * args.batch_size]
                                       for ix in idx])
                x = torch.from_numpy(xtr[rows]).to(device, dtype)
                y = torch.from_numpy(ytr[rows]).to(device).long()
                params, stats, opt_state, loss = step(params, stats, opt_state, x, y)
                losses.append(float(loss))
                train_loss += losses[-1]
            dt = time.perf_counter() - t0
            n_eval = len(xte) // W * W
            per = n_eval // W
            rows = np.concatenate([np.arange(r * per, (r + 1) * per) for r in local])
            correct = evaluate(params, stats, torch.from_numpy(xte[rows]).to(device, dtype),
                               torch.from_numpy(yte[rows]).to(device).long())
            acc = float(correct) / n_eval
            sps = steps * args.batch_size * W / dt
            where = ("every rank on one device" if len(local) == W
                     else "one rank a process")
            print(f"Epoch: {epoch}/{args.epochs}, train loss: {train_loss / max(steps, 1):.4f}, "
                  f"test acc: {acc * 100:.2f}%, {sps:.0f} samples/s "
                  f"({sps * len(local) / W:.0f}/device: {where})")
            epochs.append({"train_loss": train_loss / max(steps, 1), "test_acc": acc,
                           "samples_per_s": sps})
        return {"losses": losses, "epochs": epochs, "params": params, "stats": stats}
    finally:
        tdx.destroy_process_group()


if __name__ == "__main__":
    main()
