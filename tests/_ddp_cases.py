"""The DDP run the port's tests make in driver mode and in a gloo gang.

`run` trains the port's ConvNet (seed 0) under `DistributedDataParallel`
for a few steps of SGD with momentum 0.5 on the synthetic batch of the
reference `bench.py:437-439` at 16 a rank, on the group in force; each
process feeds its ranks' rows of that global batch. Imports only the port,
so gang workers do not load JAX.
"""

import numpy as np
import torch
import torch.nn.functional as F

BATCH = 16  # a rank


def global_batch(world):
    gen = np.random.default_rng(0)
    x = gen.standard_normal((BATCH * world, 28, 28, 1)).astype(np.float32)
    y = gen.integers(0, 10, BATCH * world).astype(np.int32)
    return x, y


def run(tdx, steps=3, shard="auto", has_rng=True, params=None):
    """(per-step losses, final params as numpy) of `steps` DDP steps."""
    from pytorch_distributed_example_tpu_torch import optim
    from pytorch_distributed_example_tpu_torch.models import ConvNet

    g = tdx.distributed._get_default_group()
    ranks = tdx.distributed._local_rows(g)
    x, y = global_batch(g.size())
    rows = slice(ranks[0] * BATCH, (ranks[-1] + 1) * BATCH)
    x = torch.from_numpy(x[rows].transpose(0, 3, 1, 2).copy()).to(g.device)
    y = torch.from_numpy(y[rows]).long().to(g.device)
    # initialized on the CPU, so that every device starts from the same params
    model = ConvNet(device="cpu", generator=torch.Generator().manual_seed(0)).to(g.device)
    ddp = tdx.DistributedDataParallel(model, params)
    opt = optim.sgd(0.01, momentum=0.5)
    step = ddp.make_train_step(opt, F.cross_entropy, has_rng=has_rng, shard_weight_update=shard)
    p, s = ddp.params, opt.init(ddp.params)
    losses = []
    for i in range(steps):
        p, s, loss = step(p, s, x, y, i) if has_rng else step(p, s, x, y)
        losses.append(float(loss))
    return losses, {n: t.detach().cpu().numpy() for n, t in p.items()}
