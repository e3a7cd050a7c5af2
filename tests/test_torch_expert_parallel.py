"""The port's MoE routing and ep-sharded MoE against the reference's, on the CPU.

`moe_mlp` (axis-free: all tokens over all experts) for top-1 and top-2
with a capacity factor that drops tokens, and with a router whose
probabilities tie; `make_ep_moe` at 4 ep ranks (driver mode) against the
reference's `shard_map` form on the conftest's mesh. Float32 inputs from
numpy seeds: y, aux and the gradients of sum(y * C) + aux agree to rtol
1e-5 / atol 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from pytorch_distributed_example_tpu.parallel import expert_parallel as JEP
from pytorch_distributed_example_tpu_torch.mesh import DeviceMesh
from pytorch_distributed_example_tpu_torch.parallel import expert_parallel as TEP

TOL = dict(rtol=1e-5, atol=1e-5)
T_, D, F, E = 32, 8, 12, 4


def _inputs(seed, tie=False):
    gen = np.random.default_rng(seed)
    x = gen.standard_normal((T_, D)).astype(np.float32)
    up = (gen.standard_normal((E, D, F)) / np.sqrt(D)).astype(np.float32)
    down = (gen.standard_normal((E, F, D)) / np.sqrt(F)).astype(np.float32)
    router = gen.standard_normal((D, E)).astype(np.float32)
    if tie:  # experts 1 and 2 score every token alike, as do 0 and 3
        router[:, 2] = router[:, 1]
        router[:, 3] = router[:, 0]
    ct = gen.standard_normal((T_, D)).astype(np.float32)
    return x, up, down, router, ct


def _check(jfn, tfn, args, ct):
    def objective(*a):
        y, aux = jfn(*a)
        return (y * jnp.asarray(ct)).sum() + aux, (y, aux)

    (_, (y, aux)), grads = jax.value_and_grad(objective, argnums=(0, 1, 2, 3), has_aux=True)(
        *[jnp.asarray(a) for a in args])
    leaves = [torch.tensor(a, requires_grad=True) for a in args]
    ty, taux = tfn(*leaves)
    ((ty * torch.from_numpy(ct)).sum() + taux).backward()
    np.testing.assert_allclose(ty.detach().numpy(), np.asarray(y), **TOL)
    np.testing.assert_allclose(float(taux), float(aux), **TOL)
    for g, t in zip(grads, leaves):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g), **TOL)


CASES = [(1, 1.25, False), (1, 0.5, False), (2, 1.25, False), (2, 0.5, False), (1, 1.25, True),
         (2, 0.75, True)]


@pytest.mark.parametrize("k,cf,tie", CASES,
                         ids=[f"k{k}-cf{cf}{'-tie' if t else ''}" for k, cf, t in CASES])
def test_moe_mlp_matches_reference(k, cf, tie):
    x, up, down, router, ct = _inputs(k * 10 + int(cf * 4), tie)
    if cf < 1:  # the capacity drops tokens here
        cap = TEP.capacity_for(T_, E, cf, k)
        logits = torch.from_numpy(x) @ torch.from_numpy(router)
        _, _, _, keep, _ = TEP._topk_routing(logits, E, cap, k)
        assert not keep.all()
    _check(lambda *a: JEP.moe_mlp(*a, axis_name=None, capacity_factor=cf, k=k),
           lambda *a: TEP.moe_mlp(*a, capacity_factor=cf, k=k), (x, up, down, router), ct)


def test_ties_go_to_the_lower_expert():
    logits = torch.zeros(3, 4)
    logits[1, 2] = logits[1, 3] = 1.0
    expert, gate, pos, keep, _ = TEP._topk_routing(logits, 4, 8, k=2)
    assert expert.tolist() == [[0, 1], [2, 3], [0, 1]]
    assert pos.tolist() == [[0, 0], [0, 0], [1, 1]]


@pytest.mark.parametrize("k", [1, 2])
def test_make_ep_moe_matches_reference(k):
    x, up, down, router, ct = _inputs(40 + k)
    ep = 4
    jmesh = Mesh(np.array(jax.devices()[:ep]), ("ep",))
    jfn = JEP.make_ep_moe(jmesh, "ep", capacity_factor=1.0, k=k)
    tfn = TEP.make_ep_moe(DeviceMesh(["cpu"] * ep, (ep,), ("ep",)), "ep",
                          capacity_factor=1.0, k=k)
    _check(jfn, tfn, (x, up, down, router), ct)


def test_make_ep_moe_routes_each_rank_alone():
    """Per-rank routing differs from routing all tokens at once (capacity
    and positions are each rank's own)."""
    x, up, down, router, _ = _inputs(7)
    tfn = TEP.make_ep_moe(DeviceMesh(["cpu"] * 4, (4,), ("ep",)), "ep", capacity_factor=0.5)
    args = [torch.from_numpy(a) for a in (x, up, down, router)]
    y_ep, _ = tfn(*args)
    y_all, _ = TEP.moe_mlp(*args, capacity_factor=0.5)
    assert not torch.allclose(y_ep, y_all)
    with pytest.raises(ValueError, match="make_ep_moe"):
        TEP.moe_mlp(*args, axis_name="ep")
