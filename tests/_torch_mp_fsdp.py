"""Cases of `tests/test_torch_multiproc_fsdp.py`: the sharded trainer over
a world-4 mesh, each a function that runs in driver mode (a driver-mode
mesh over the CPU) and as a rank of a multiproc gang (the gang's mesh).

* the TransformerLM's FSDP step over ("fsdp", "tp") (2, 2), dense and
  with the MoE (4 experts, top-1), and over ("dp", "fsdp", "tp") (2, 2,
  1): `stacked_forward` under `fully_shard`, 8 rows a step, two AdamW
  steps (SGD for the MoE, see MESHES): losses and gathered params;
* ZeRO-2 over ("fsdp", 4) with `blockwise_quant_hook(error_feedback=
  False)`: losses and params;
* a module with no mesh-aware forward (an MLP on its gathered params);
* DTensor's `full_tensor`, `redistribute` and arithmetic.

The initial params come from the reference's init (a flax tree, pickled by
the test) through `models/convert.py`. No JAX here.
"""

import functools
import pickle

import numpy as np
import torch

from pytorch_distributed_example_tpu_torch.dtensor import (Replicate, Shard,
                                                           distribute_tensor)
from pytorch_distributed_example_tpu_torch.examples import lm
from pytorch_distributed_example_tpu_torch.mesh import DeviceMesh, init_device_mesh
from pytorch_distributed_example_tpu_torch.models import convert, transformer as ttr
from pytorch_distributed_example_tpu_torch.parallel import fsdp as tfsdp
from pytorch_distributed_example_tpu_torch.parallel.comm_hooks import blockwise_quant_hook

W = 4
LR = 1e-3
STEPS = 2
KW = dict(vocab_size=128, d_model=64, n_layers=2, n_heads=4, max_seq_len=32, use_flash=False)
# name: (mesh shape, axis names, experts); the MoE routes the global batch
# and steps with SGD (MOE_LR): AdamW's first update g / (|g| + 1e-8) turns
# float32 rounding in the experts' near-zero gradients into lr-sized
# differences (`test_torch_fsdp.py`), which SGD keeps proportional
MOE_LR = 0.1
MESHES = {"fsdp2_tp2": ((2, 2), ("fsdp", "tp"), 0),
          "dp2_fsdp2_tp1": ((2, 2, 1), ("dp", "fsdp", "tp"), 0),
          "fsdp2_tp2_moe": ((2, 2), ("fsdp", "tp"), 4)}
HOOK_DIMS = (16, 32, 4)  # the ZeRO-2 MLP: in, hidden, classes
HOOK_LR = 0.05


def tokens(step):
    """8 rows of 32 tokens: two rows a data rank at 4 data ranks (the
    reference's 3-D step is wrong at one row a data rank)."""
    return np.random.default_rng(20 + step).integers(0, 128, (8, 32)).astype(np.int32)


def hook_apply(p, x):
    """flax's Dense_0 -> relu -> Dense_1 on the reference's (in, out) kernels."""
    h = torch.relu(x @ p["Dense_0.kernel"] + p["Dense_0.bias"])
    return h @ p["Dense_1.kernel"] + p["Dense_1.bias"]


def hook_batch():
    gen = np.random.default_rng(0)
    x = gen.standard_normal((8, HOOK_DIMS[0])).astype(np.float32)
    y = gen.integers(0, HOOK_DIMS[2], 8).astype(np.int32)
    return x, y


def _mesh(shape, names, multiproc):
    if multiproc:
        return init_device_mesh(names, shape)
    return DeviceMesh(["cpu"] * int(np.prod(shape)), shape, names)


def lm_case(init, key, multiproc):
    shape, names, experts = MESHES[key]
    model = ttr.TransformerLM(ttr.TransformerConfig(n_experts=experts, **KW), device="cpu")
    model.load_state_dict(convert.from_flax(init))
    mesh = _mesh(shape, names, multiproc)
    data = tuple(a for a in ("dp", "fsdp") if a in names)
    mod = tfsdp.fully_shard(model, None, mesh, axis="fsdp",
                            rules=ttr.sharding_rules("tp", "fsdp"), data_axes=data)
    optimizer = functools.partial(torch.optim.SGD, lr=MOE_LR) if experts else lm.adamw(LR)
    step = mod.make_train_step(optimizer, lm.loss_fn)
    opt = step.init_opt_state(mod.params)
    losses = []
    for i in range(STEPS):
        t = torch.from_numpy(tokens(i)).long()
        losses.append(float(step(mod.params, opt, t, t)[2]))
    local = {k: tuple(v._local.shape) for k, v in mod.params.items()}
    return {"losses": np.array(losses),
            "params": {k: v.numpy() for k, v in mod.gather_params().items()},
            "local_shapes": local}


def zero2_case(init, multiproc):
    params = {k: torch.tensor(v) for k, v in init.items()}
    mesh = _mesh((W,), ("fsdp",), multiproc)
    step = tfsdp.make_zero2_train_step(
        hook_apply, lambda lg, yy: torch.nn.functional.cross_entropy(lg, yy),
        functools.partial(torch.optim.SGD, lr=HOOK_LR), mesh, axis="fsdp",
        data_axes=("fsdp",), comm_hook=blockwise_quant_hook(error_feedback=False))
    opt = step.init_opt_state(params)
    x, y = hook_batch()
    losses = []
    for _ in range(STEPS):
        params, opt, loss = step(params, opt, torch.tensor(x), torch.tensor(y).long())
        losses.append(float(loss))
    return {"losses": np.array(losses), "params": {k: v.numpy() for k, v in params.items()},
            "shard_rows": opt.shards["Dense_0.kernel"].shape[0]}


def generic_case(multiproc):
    """A plain MLP fully sharded over ("fsdp", 4): it runs on its gathered
    params, three SGD steps."""
    torch.manual_seed(0)
    net = torch.nn.Sequential(torch.nn.Linear(8, 16), torch.nn.Tanh(), torch.nn.Linear(16, 4))
    mesh = _mesh((W,), ("fsdp",), multiproc)
    mod = tfsdp.fully_shard(net, None, mesh, axis="fsdp", data_axes=("fsdp",))
    loss_fn = lambda out, y: torch.nn.functional.mse_loss(out, y)  # noqa: E731
    step = mod.make_train_step(functools.partial(torch.optim.SGD, lr=0.1), loss_fn)
    opt = step.init_opt_state(mod.params)
    gen = torch.Generator().manual_seed(1)
    losses = []
    for _ in range(3):
        x, y = torch.randn(8, 8, generator=gen), torch.randn(8, 4, generator=gen)
        losses.append(float(step(mod.params, opt, x, y)[2]))
    return {"losses": np.array(losses),
            "params": {k: v.numpy() for k, v in mod.gather_params().items()}}


def dtensor_case(multiproc):
    mesh = _mesh((2, 2), ("fsdp", "tp"), multiproc)
    full = torch.arange(48, dtype=torch.float32).reshape(8, 6)
    a = distribute_tensor(full, mesh, [Shard(0), Shard(1)])
    b = a.redistribute([Replicate(), Shard(0)])
    c = a + a
    return {"full": a.full_tensor().numpy(), "redistributed": b.full_tensor().numpy(),
            "sum": c.full_tensor().numpy(), "placements": str(b.placements),
            "shape": a.shape}


def run_all(inputs, multiproc):
    out = {key: lm_case(inputs["lm_moe" if MESHES[key][2] else "lm"], key, multiproc)
           for key in MESHES}
    out["zero2_hook"] = zero2_case(inputs["hook"], multiproc)
    out["generic"] = generic_case(multiproc)
    out["dtensor"] = dtensor_case(multiproc)
    return out


def gang(rank, world, path):
    with open(path, "rb") as f:
        inputs = pickle.load(f)
    return run_all(inputs, True)
