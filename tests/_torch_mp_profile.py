"""Gang cases for `DistributedDataParallel.profile_breakdown` and the ZeRO
coupling guard in multiproc mode (one process a rank, gloo on the CPU).

Each rank feeds its rows of `_ddp_cases.global_batch`. Imports only the
port, so gang workers do not load JAX.
"""

import warnings

import torch
import torch.nn.functional as F

from tests import _ddp_cases as cases


def _ddp(tdx):
    from pytorch_distributed_example_tpu_torch.models import ConvNet

    g = tdx.distributed._get_default_group()
    ranks = tdx.distributed._local_rows(g)
    x, y = cases.global_batch(g.size())
    rows = slice(ranks[0] * cases.BATCH, (ranks[-1] + 1) * cases.BATCH)
    x = torch.from_numpy(x[rows].transpose(0, 3, 1, 2).copy())
    y = torch.from_numpy(y[rows]).long()
    model = ConvNet(device="cpu", generator=torch.Generator().manual_seed(0))
    return tdx.DistributedDataParallel(model), x, y


def gang(rank, world):
    import pytorch_distributed_example_tpu_torch as tdx
    from pytorch_distributed_example_tpu_torch import optim

    ddp, x, y = _ddp(tdx)
    before = {n: p.clone() for n, p in ddp.params.items()}
    times = ddp.profile_breakdown(optim.sgd(0.05), F.cross_entropy, x, y, iters=2)
    unchanged = all(torch.equal(before[n], ddp.params[n]) for n in before)

    opt = optim.adafactor(1e-3)
    finals = {}
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        for mode in ("auto", "off"):
            step = ddp.make_train_step(opt, F.cross_entropy, shard_weight_update=mode)
            p, s = ddp.params, opt.init(ddp.params)
            for _ in range(2):
                p, s, loss = step(p, s, x, y)
            finals[mode] = (p, float(loss), step.weight_update_sharded)
    auto, off = finals["auto"], finals["off"]
    return {
        "times": times,
        "logging": ddp.get_ddp_logging_data(),
        "unchanged": unchanged,
        "fallback_warned": sum("does not commute" in str(w.message) for w in caught),
        "sharded": auto[2],
        "bitwise": auto[1] == off[1] and all(torch.equal(auto[0][n], off[0][n]) for n in auto[0]),
    }
