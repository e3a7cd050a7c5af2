"""MNIST DDP training — the port of the reference's `examples/mnist/main.py`.

The ConvNet on MNIST (synthetic unless `--root` names a directory of local
IDX files; nothing is downloaded), one `DistributedSampler` + `DataLoader`
per rank, the model wrapped in `DistributedDataParallel` (ZeRO
weight-update sharding at world > 1), SGD with momentum, then train and
evaluate each epoch with metrics averaged across ranks (`Average`,
`Accuracy`, `Trainer.fit`).

The flags are the reference's (`--backend`, `--init-method`, `--rank`,
`--world-size`, `--epochs`, `--lr`, `--momentum`, `--batch-size`,
`--root`, `--num-workers`, `--worker-mode`, `--steps-per-call`) plus
`--cpu`. Without `--init-method` one process drives every rank (driver
mode): the ranks' microbatches are packed rank-major into one global batch
a step, on `cuda:0`, or on the CPU with `--cpu`; `--world-size -1` means 8
ranks on the card (the reference's 8-device host) and 2 with `--cpu` (its
`--cpu` mesh). With `--init-method` each process is one rank of a gang that
meets at that URL (multiproc mode) and loads its own rank's batches. It
runs on the card unless `--cpu` is given, and raises without one.

The images stay NHWC float32 numpy through the loaders, as the reference's
are; each global batch is moved to the device once, where it is
transposed to NCHW and its int32 labels widened to int64.

Run:  python -m pytorch_distributed_example_tpu_torch.examples.mnist --epochs 1
"""

from __future__ import annotations

import argparse
import time
from typing import List, Optional

import numpy as np
import torch
import torch.nn.functional as F

import pytorch_distributed_example_tpu_torch as tdx
from pytorch_distributed_example_tpu_torch import optim
from pytorch_distributed_example_tpu_torch.data import DataLoader, DistributedSampler, load_mnist
from pytorch_distributed_example_tpu_torch.models import ConvNet

CARD_RANKS = 8  # --world-size -1 in driver mode on the card
CPU_RANKS = 2  # ... and with --cpu


class Average:
    """Running average — the reference's metric helper."""

    def __init__(self):
        self.sum = 0.0
        self.count = 0

    def update(self, value: float, number: int = 1):
        self.sum += value * number
        self.count += number

    @property
    def average(self) -> float:
        return self.sum / max(self.count, 1)

    def __str__(self):
        return f"{self.average:.6f}"


class Accuracy:
    def __init__(self):
        self.correct = 0
        self.count = 0

    def update(self, correct: int, number: int):
        self.correct += correct
        self.count += number

    @property
    def accuracy(self) -> float:
        return self.correct / max(self.count, 1)

    def __str__(self):
        return f"{self.accuracy * 100:.2f}%"


def loss_fn(logits, y):
    return F.cross_entropy(logits, y)


def metric_fn(logits, y, w):
    """Weighted sums of the loss, the correct count and the weight."""
    ce = F.cross_entropy(logits, y, reduction="none")
    correct = (logits.argmax(-1) == y).float()
    return torch.stack([(ce * w).sum(), (correct * w).sum(), w.sum()])


def to_device(xs: np.ndarray, ys: np.ndarray, device) -> tuple:
    """One global batch to the device: NHWC -> NCHW, int32 labels -> int64."""
    x = torch.from_numpy(xs).to(device).permute(0, 3, 1, 2).contiguous()
    return x, torch.from_numpy(ys).to(device).long()


class Trainer:
    """fit/train/evaluate — the reference's Trainer."""

    def __init__(self, ddp, optimizer, train_data, test_data, batch_size, world_size,
                 seed=0, num_workers=0, worker_mode="thread", steps_per_call=1):
        self.ddp = ddp
        self.world_size = world_size
        self.batch_size = batch_size
        self.device = ddp.process_group.device
        self.seed = seed
        self.steps = 0  # seeds each step's dropout streams
        self.losses: List[float] = []  # every step's loss, in order

        self.train_step = ddp.make_train_step(optimizer, loss_fn, has_rng=True)
        # --steps-per-call K: K full optimizer steps a call; the single
        # step still takes the epoch's ragged tail
        self.steps_per_call = steps_per_call
        if steps_per_call > 1:
            self.train_step_k = ddp.make_train_step(
                optimizer, loss_fn, has_rng=True, steps_per_call=steps_per_call,
                unroll_steps=True)
        self.eval_step = ddp.make_eval_step(metric_fn)
        self.opt_state = optimizer.init(ddp.params)
        self.params = ddp.params

        # one sampler+loader per rank this process holds; microbatches
        # packed rank-major
        self.ranks = tdx.distributed._local_rows(ddp.process_group)
        # driver mode stacks every rank on one device; multiproc has one a rank
        self.devices = world_size // len(self.ranks)
        self.samplers = [DistributedSampler(train_data, num_replicas=world_size, rank=r)
                         for r in self.ranks]
        self.loaders = [DataLoader(train_data, batch_size, sampler=s, num_workers=num_workers,
                                   worker_mode=worker_mode)
                        for s in self.samplers]
        self.test_data = test_data

    def fit(self, epochs: int):
        results = []
        for epoch in range(1, epochs + 1):
            t0 = time.perf_counter()
            train_loss, seen = self.train(epoch)
            test_loss, test_acc = self.evaluate()
            dt = time.perf_counter() - t0
            ips = seen * self.world_size / len(self.ranks) / dt
            print(
                f"Epoch: {epoch}/{epochs}, "
                f"train loss: {train_loss:.6f}, "
                f"test loss: {test_loss:.6f}, test acc: {test_acc*100:.2f}%, "
                f"{ips:,.0f} samples/s ({ips/self.devices:,.0f}/device)"
            )
            results.append((train_loss, test_loss, test_acc))
        return results

    def _next_seed(self) -> int:
        self.steps += 1
        return self.seed * 1_000_000 + self.steps

    def train(self, epoch: int):
        for s in self.samplers:
            s.set_epoch(epoch)
        avg = Average()
        seen = 0
        pending = []  # buffered global batches for the K-step call
        for microbatches in zip(*[iter(l) for l in self.loaders]):
            xs = np.concatenate([x for x, _ in microbatches])
            ys = np.concatenate([y for _, y in microbatches])
            if xs.shape[0] % len(self.ranks) != 0:
                continue  # ragged tail microbatch set
            if self.steps_per_call > 1:
                pending.append((xs, ys))
                if len(pending) == self.steps_per_call:
                    seen += self._run_fused(pending, avg)
                    pending = []
                continue
            loss = self._run_single(xs, ys)
            avg.update(loss, xs.shape[0])
            seen += xs.shape[0]
        for xs, ys in pending:  # ragged tail: single steps
            loss = self._run_single(xs, ys)
            avg.update(loss, xs.shape[0])
            seen += xs.shape[0]
        return avg.average, seen

    def _run_single(self, xs, ys) -> float:
        x, y = to_device(xs, ys, self.device)
        self.params, self.opt_state, loss = self.train_step(
            self.params, self.opt_state, x, y, self._next_seed())
        self.losses.append(float(loss))
        return self.losses[-1]

    def _run_fused(self, pending, avg) -> int:
        x, y = to_device(np.concatenate([x for x, _ in pending]),
                         np.concatenate([y for _, y in pending]), self.device)
        x = x.reshape((len(pending), -1) + tuple(x.shape[1:]))  # (K, batch, 1, 28, 28)
        y = y.reshape(len(pending), -1)
        seeds = [self._next_seed() for _ in pending]
        self.params, self.opt_state, losses = self.train_step_k(
            self.params, self.opt_state, x, y, seeds)
        self.losses.extend(float(v) for v in losses)
        n = sum(x.shape[0] for x, _ in pending)
        avg.update(float(losses.mean()), n)
        return n

    def evaluate(self):
        n = len(self.test_data)
        eb = self.batch_size * self.world_size
        # pad with wraparound indices + zero weights so every sample counts
        # exactly once regardless of n % eb
        n_pad = ((n + eb - 1) // eb) * eb
        idx_all = np.arange(n_pad) % n
        w_all = (np.arange(n_pad) < n).astype(np.float32)
        loss_sum = correct = count = 0.0
        for start in range(0, n_pad, eb):
            # this process's ranks' shares of the global batch
            sel = np.arange(start, start + eb).reshape(self.world_size, -1)[self.ranks].ravel()
            x, y = to_device(*self.test_data[idx_all[sel]], self.device)
            w = torch.from_numpy(w_all[sel]).to(self.device)
            m = self.eval_step(self.params, x, y, w).tolist()
            loss_sum += m[0]
            correct += m[1]
            count += m[2]
        return loss_sum / max(count, 1), correct / max(count, 1)


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser()
    p.add_argument("--backend", type=str, default="xla")
    p.add_argument("--init-method", type=str, default=None,
                   help="multiproc mode: this process is rank --rank of a gang of "
                        "--world-size that meets here (tcp://, env://, file://); "
                        "omit it to drive every rank from this process")
    p.add_argument("--rank", type=int, default=0)
    p.add_argument("--world-size", type=int, default=-1)
    p.add_argument("--epochs", type=int, default=2)
    p.add_argument("--lr", type=float, default=0.01)
    p.add_argument("--momentum", type=float, default=0.5)
    p.add_argument("--batch-size", type=int, default=64)
    p.add_argument("--root", type=str, default=None, help="MNIST IDX data dir")
    p.add_argument("--num-workers", type=int, default=0,
                   help="loader workers per rank (the reference CLI's flag)")
    p.add_argument("--worker-mode", choices=["thread", "process"], default="thread",
                   help="process = torch-style worker processes with a "
                        "shared-memory return path (GIL-bound decode)")
    p.add_argument("--steps-per-call", type=int, default=1,
                   help="K full optimizer steps a call (the same values as K calls)")
    p.add_argument("--cpu", action="store_true",
                   help="run the ranks on the CPU instead of the card")
    return p.parse_args(argv)


def main(argv: Optional[List[str]] = None) -> Trainer:
    args = parse_args(argv)
    if not args.cpu and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass --cpu to run the ranks on the CPU")
    if not args.cpu:
        # float32, as the reference computes: no TF32 in cuDNN's convolutions or the matmuls
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    world_size = args.world_size
    if world_size == -1 and args.init_method is None:
        world_size = CPU_RANKS if args.cpu else CARD_RANKS
    pg = tdx.init_process_group(
        backend=args.backend, init_method=args.init_method, world_size=world_size,
        rank=args.rank, device="cpu" if args.cpu else None,
    )
    try:
        world = tdx.get_world_size()
        print(f"backend={tdx.get_backend()} world_size={world} device={pg.device}")
        train_data = load_mnist(args.root, train=True)
        test_data = load_mnist(args.root, train=False)
        model = ConvNet(device=pg.device,
                        generator=torch.Generator(device=pg.device).manual_seed(0))
        ddp = tdx.DistributedDataParallel(model)
        trainer = Trainer(ddp, optim.sgd(args.lr, momentum=args.momentum), train_data,
                          test_data, args.batch_size, world, num_workers=args.num_workers,
                          worker_mode=args.worker_mode, steps_per_call=args.steps_per_call)
        trainer.fit(args.epochs)
        return trainer
    finally:
        tdx.destroy_process_group()


if __name__ == "__main__":
    main()
