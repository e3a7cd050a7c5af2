"""The reference's driver entry points in the port: `entry()` and
`dryrun_multichip(n)` (the reference's `__graft_entry__.py`).

`dryrun_multichip(n)` runs the reference's five parts at its shapes and
seeds, in its order of numpy draws (`draw_inputs`), every rank in driver
mode on one device (cuda:0 by default; it raises without a card, and
`device="cpu"` runs it on the CPU):

1. the flagship LM's full train step over a ("dp", "fsdp", "tp") mesh
   (`_factor_mesh`), `fully_shard` by the transformer rules with the batch
   over ("dp", "fsdp"), AdamW;
2. ring attention over an ("sp", n) mesh;
3. the expert-parallel MoE over an ("ep", n) mesh;
4. a GPipe pipeline of n tanh stages over a ("pp", n) mesh;
5. the c10d path: the DDP train step of the ConvNet with dropout
   (`has_rng`) and an eager all_reduce of every rank's index.

Weights come from seeded torch generators; the reference's flax inits do
not carry across bit for bit, so `lm_params` and `convnet_params` (state
dicts, e.g. `models.convert.from_flax` / `convnet_from_flax` of the
reference's) replace them. Returns the parts' values and prints the
reference's summary line.

Run:  python -m pytorch_distributed_example_tpu_torch.dryrun [--cpu] [-n 8]
"""

from __future__ import annotations

import argparse
import math
from typing import Dict, Optional

import numpy as np
import torch
from torch.func import functional_call

from . import distributed as dist
from .examples import lm, mnist
from .mesh import DeviceMesh
from .models import ConvNet, TransformerConfig, TransformerLM, transformer_sharding_rules
from .models.transformer import resolve_device
from .optim import sgd
from .parallel import (DistributedDataParallel, fully_shard, make_cp_attention, make_ep_moe,
                       make_pipeline_fn, stack_stage_params)
from .tensor import DistTensor

# part 1's model: the reference's tiny flagship LM (dense attention)
LM_KW = dict(vocab_size=128, d_model=64, n_layers=2, n_heads=4, max_seq_len=32, use_flash=False)


def _factor_mesh(n: int):
    """n -> (dp, fsdp, tp), preferring 3 non-trivial axes."""
    tp = 2 if n % 2 == 0 else 1
    rem = n // tp
    fsdp = 2 if rem % 2 == 0 else 1
    dp = rem // fsdp
    return dp, fsdp, tp


def entry(device=None):
    """(fn, example_args): the flagship model's forward and its inputs
    (vocab 256, d 128, 2 layers, 4 heads, dense attention; tokens (2, 64)
    zeros): `fn(params, tokens)` runs the model on `params`."""
    device = resolve_device(device)
    cfg = TransformerConfig(vocab_size=256, d_model=128, n_layers=2, n_heads=4, use_flash=False)
    model = TransformerLM(cfg, device=device,
                          generator=torch.Generator(device=device).manual_seed(0))
    toks = torch.zeros((2, 64), dtype=torch.int64, device=device)
    params = {k: v.detach() for k, v in model.state_dict().items()}

    def fwd(params, toks):
        return functional_call(model, params, (toks,))

    return fwd, (params, toks)


def draw_inputs(n: int) -> Dict[str, np.ndarray]:
    """Every part's data, drawn from `np.random.default_rng(0)` in the
    reference's order."""
    dp, fsdp, _ = _factor_mesh(n)
    gen = np.random.default_rng(0)
    out = {"toks": gen.integers(0, 128, (2 * max(dp * fsdp, 1), 32))}
    L = 8 * n
    out["q"] = gen.standard_normal((1, L, 2, 8)).astype(np.float32)
    E, D, F = n, 16, 32
    out["xt"] = gen.standard_normal((8 * n, D)).astype(np.float32)
    out["wu"] = (gen.standard_normal((E, D, F)) * 0.1).astype(np.float32)
    out["wd"] = (gen.standard_normal((E, F, D)) * 0.1).astype(np.float32)
    out["rw"] = (gen.standard_normal((D, E)) * 0.5).astype(np.float32)
    out["ws"] = np.stack([(gen.standard_normal((16, 16)) * 0.1).astype(np.float32)
                          for _ in range(n)])
    out["px"] = gen.standard_normal((4, 2, 16)).astype(np.float32)
    out["cx"] = gen.standard_normal((2 * n, 28, 28, 1)).astype(np.float32)
    out["cy"] = gen.integers(0, 10, 2 * n)
    return out


def _mesh(device, shape, names):
    return DeviceMesh([device] * math.prod(shape), shape, names)


def lm_step(n: int, toks, device, lm_params=None):
    """Part 1: one train step of the LM over the (dp, fsdp, tp) mesh;
    returns the loss."""
    dims = _factor_mesh(n)
    model = TransformerLM(TransformerConfig(**LM_KW), device=device,
                          generator=torch.Generator(device=device).manual_seed(0))
    if lm_params is not None:
        model.load_state_dict(lm_params)
    mesh = _mesh(device, dims, ("dp", "fsdp", "tp"))
    mod = fully_shard(model, None, mesh, axis="fsdp",
                      rules=transformer_sharding_rules("tp", "fsdp"), data_axes=("dp", "fsdp"))
    model.to("meta")  # the shards are the weights from here on
    step = mod.make_train_step(lm.adamw(1e-3), lm.loss_fn)
    t = torch.as_tensor(toks, dtype=torch.int64, device=device)
    _, _, loss = step(mod.params, step.init_opt_state(mod.params), t, t)
    return loss


def ring(n: int, q, device):
    """Part 2: causal ring attention over n sequence shards."""
    attn = make_cp_attention(_mesh(device, (n,), ("sp",)), axis_name="sp", mode="ring",
                             causal=True)
    qt = torch.as_tensor(q, device=device)
    return attn(qt, qt, qt)


def moe(n: int, xt, wu, wd, rw, device):
    """Part 3: the ep-sharded MoE, E = n experts, capacity factor E."""
    fn = make_ep_moe(_mesh(device, (n,), ("ep",)), "ep", capacity_factor=float(n))
    return fn(*(torch.as_tensor(a, device=device) for a in (xt, wu, wd, rw)))


def pipeline(n: int, ws, px, device):
    """Part 4: GPipe over n stages of tanh(x @ w)."""
    pipe = make_pipeline_fn(lambda p, x: torch.tanh(x @ p["w"]),
                            _mesh(device, (n,), ("pp",)), "pp")
    stacked = stack_stage_params([{"w": torch.as_tensor(w, device=device)} for w in ws])
    return pipe(stacked, torch.as_tensor(px, device=device))


def ddp_step(n: int, cx, cy, device, convnet_params=None, has_rng: bool = True):
    """Part 5's train step: the ConvNet's DDP step at world n (SGD 0.01,
    momentum 0.5; dropout masks drawn from seed 1 with `has_rng`), inside
    a driver-mode world the caller has initialised; returns the loss."""
    cmodel = ConvNet(device=device, generator=torch.Generator(device=device).manual_seed(0))
    if convnet_params is not None:
        cmodel.load_state_dict(convnet_params)
    ddp = DistributedDataParallel(cmodel)
    opt = sgd(0.01, momentum=0.5)
    step = ddp.make_train_step(opt, mnist.loss_fn, has_rng=has_rng)
    x, y = mnist.to_device(cx, cy.astype(np.int32), device)
    args = (ddp.params, opt.init(ddp.params), x, y) + ((1,) if has_rng else ())
    return step(*args)[-1]


def all_reduce_ranks(n: int) -> float:
    """Part 5's eager collective: all_reduce(SUM) of each rank's index, as
    rank 0 reads it."""
    t = DistTensor.from_rank_fn(lambda r: np.array([float(r)], np.float32))
    dist.all_reduce(t)
    return float(t.tensor[0, 0])


def _finite(x, what):
    if not bool(torch.isfinite(x).all()):
        raise RuntimeError(f"{what} produced non-finite output")


def dryrun_multichip(n_devices: int, device=None, lm_params=None,
                     convnet_params=None) -> Dict[str, object]:
    """The five parts over n ranks in driver mode on `device` (see the
    module docstring). Returns {"loss", "ring", "moe_y", "moe_aux",
    "pipe", "ddp_loss", "all_reduce"}; raises on a non-finite part or a
    wrong all_reduce."""
    n = n_devices
    device = resolve_device(device)
    data = draw_inputs(n)
    dp, fsdp, tp = _factor_mesh(n)

    loss = lm_step(n, data["toks"], device, lm_params)
    _finite(loss, "the sharded train step")
    o = ring(n, data["q"], device)
    _finite(o, "ring attention")
    ymoe, aux = moe(n, data["xt"], data["wu"], data["wd"], data["rw"], device)
    _finite(ymoe, "the expert-parallel MoE")
    ypipe = pipeline(n, data["ws"], data["px"], device)
    _finite(ypipe, "the pipeline")

    if dist.is_initialized():
        dist.destroy_process_group()
    dist.init_process_group(backend="xla", world_size=n, device=device)
    try:
        dloss = ddp_step(n, data["cx"], data["cy"], device, convnet_params)
        _finite(dloss, "the DDP train step")
        got = all_reduce_ranks(n)
    finally:
        dist.destroy_process_group()
    expected = float(sum(range(n)))
    if got != expected:
        raise RuntimeError(f"all_reduce mismatch: {got} != {expected}")
    print(f"dryrun_multichip({n}): ok — mesh dp={dp} fsdp={fsdp} tp={tp}, "
          f"loss={float(loss):.4f}, ring-attn L={8 * n}, ep-moe aux={float(aux):.3f}, "
          f"pp stages={n}, allreduce={got}")
    return {"loss": loss, "ring": o, "moe_y": ymoe, "moe_aux": aux, "pipe": ypipe,
            "ddp_loss": dloss, "all_reduce": got}


def main(argv=None) -> Dict[str, object]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("-n", "--n-devices", type=int, default=8)
    ap.add_argument("--cpu", action="store_true", help="run on the CPU")
    args = ap.parse_args(argv)
    return dryrun_multichip(args.n_devices, device="cpu" if args.cpu else None)


if __name__ == "__main__":
    main()
