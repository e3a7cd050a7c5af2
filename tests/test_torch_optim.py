"""The port's optimizers (`optim.py`) against optax, and their ZeRO contracts.

`adam` and `adamw` run 5 steps against `optax.adam` / `optax.adamw` on the
same params and gradients (numpy seed), float32: updates, moments and
params within rtol 1e-6, atol 1e-9 (optax computes `b^count` with XLA's
pow, the port with torch's; the two may differ in the last bit), and the
count exactly. Within the port the contract is bitwise: the DDP step's
ZeRO "auto" update with adamw gives the replicated update's params, bit
for bit, at world 4 (`ZeroRedundancyOptimizer` unwrapped), and its state
consolidates back to the unsharded one.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F

import pytorch_distributed_example_tpu_torch as tdx
from pytorch_distributed_example_tpu_torch import optim
from pytorch_distributed_example_tpu_torch.models import ConvNet
from tests import _ddp_cases as cases

TOL = dict(rtol=1e-6, atol=1e-9)
SHAPES = {"w": (7, 5), "b": (5,), "k": (3, 3, 2, 4)}


def _tree(seed):
    gen = np.random.default_rng(seed)
    return {n: gen.standard_normal(s).astype(np.float32) for n, s in SHAPES.items()}


@pytest.mark.parametrize("name,kw", [
    ("adam", {}), ("adamw", {}), ("adamw", dict(weight_decay=0.1, b1=0.8, eps=1e-6)),
    ("adam", dict(eps_root=1e-8)),
])
def test_matches_optax_over_five_steps(name, kw):
    jopt = getattr(optax, name)(1e-2, **kw)
    topt = getattr(optim, name)(1e-2, **kw)
    params = _tree(0)
    jp, tp = jax.tree_util.tree_map(jnp.asarray, params), {n: torch.from_numpy(a.copy())
                                                           for n, a in params.items()}
    js, ts = jopt.init(jp), topt.init(tp)
    assert ts["count"].dtype == torch.int32 and ts["count"].dim() == 0
    for i in range(5):
        grads = _tree(10 + i)
        ju, js = jopt.update(jax.tree_util.tree_map(jnp.asarray, grads), js, jp)
        tu, ts = topt.update({n: torch.from_numpy(g) for n, g in grads.items()}, ts, tp)
        jp, tp = optax.apply_updates(jp, ju), optim.apply_updates(tp, tu)
        for n in SHAPES:
            np.testing.assert_allclose(tu[n].numpy(), np.asarray(ju[n]), **TOL, err_msg=n)
    adam_state = js[0]
    assert int(ts["count"]) == int(adam_state.count) == 5
    for n in SHAPES:
        np.testing.assert_allclose(ts["mu"][n].numpy(), np.asarray(adam_state.mu[n]), **TOL)
        np.testing.assert_allclose(ts["nu"][n].numpy(), np.asarray(adam_state.nu[n]), **TOL)
        np.testing.assert_allclose(tp[n].numpy(), np.asarray(jp[n]), **TOL)


def test_adamw_weight_decay_default_is_optax_s():
    assert optim.adamw(1e-3).weight_decay == 1e-4
    assert optim.adam(1e-3).weight_decay is None


def _run(mode, steps=3, world=4, zopt=False):
    pg = tdx.init_process_group(world_size=world, device="cpu")
    try:
        model = ConvNet(device="cpu", generator=torch.Generator().manual_seed(0))
        ddp = tdx.DistributedDataParallel(model)
        opt = optim.adamw(1e-3)
        wrapped = optim.ZeroRedundancyOptimizer(opt, pg) if zopt else opt
        step = ddp.make_train_step(wrapped, F.cross_entropy, has_rng=True,
                                   shard_weight_update=mode)
        x, y = cases.global_batch(world)
        x = torch.from_numpy(x.transpose(0, 3, 1, 2).copy())
        y = torch.from_numpy(y).long()
        p = ddp.params
        s = wrapped.init(p) if zopt else opt.init(p)
        losses = []
        for i in range(steps):
            p, s, loss = step(p, s, x, y, i)
            losses.append(loss)
        full = (wrapped.consolidate_state_dict(s, p) if zopt
                else step.unshard_opt_state(p, s))
        return torch.stack(losses), p, full, s
    finally:
        tdx.destroy_process_group()


def test_zero_auto_matches_off_bitwise_with_adamw():
    """The port's contract: adamw is elementwise, so the sharded update is
    the replicated one bit for bit, and adam's scalar count stays whole."""
    aloss, ap, afull, ashard = _run("auto")
    oloss, op, ofull, _ = _run("off")
    assert torch.equal(aloss, oloss)
    for n in ap:
        assert torch.equal(ap[n], op[n]), n
    assert ashard["count"].dim() == 0 and int(ashard["count"]) == 3
    assert ashard["mu"]["conv1.weight"].shape == (4, 63)  # 250 elements, padded to 4 x 63
    for n in ofull["mu"]:
        assert torch.equal(afull["mu"][n], ofull["mu"][n]), n
        assert torch.equal(afull["nu"][n], ofull["nu"][n]), n


def test_zero_redundancy_optimizer_is_unwrapped_and_consolidates():
    zloss, zp, zfull, zshard = _run("auto", zopt=True)
    aloss, ap, afull, _ = _run("auto")
    assert torch.equal(zloss, aloss)
    assert zshard["mu"]["fc1.weight"].shape == (4, 4000)
    for n in ap:
        assert torch.equal(zp[n], ap[n])
        assert torch.equal(zfull["nu"][n], afull["nu"][n].cpu())
