"""The port's differentiable collectives against the reference's, on the CPU.

Each case runs the reference's `nn.functional` op under `shard_map` on the
conftest's CPU mesh and the port's op on the same blocks stacked over the
ranks (driver mode). The values and the gradients of `sum(y * C)` for a
random cotangent C must agree: float32, sums in another order, so rtol
1e-6 (PRODUCT's log-abs-exp form 2e-5).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

from pytorch_distributed_example_tpu._compat import shard_map_fn
from pytorch_distributed_example_tpu.nn import functional as JF
from pytorch_distributed_example_tpu.types import ReduceOp as JOp
from pytorch_distributed_example_tpu.types import _PremulSum as JPremul
from pytorch_distributed_example_tpu_torch.nn import functional as TF
from pytorch_distributed_example_tpu_torch.types import ReduceOp as TOp
from pytorch_distributed_example_tpu_torch.types import _PremulSum as TPremul

W = 8
TOL = dict(rtol=1e-6, atol=1e-6)

# name: (reference fn of a rank's block, port fn of the stacked blocks,
#        local shape of a block, has a gradient)
CASES = {
    "all_reduce-SUM": (lambda x: JF.all_reduce(x, JOp.SUM, "dp"),
                       lambda x: TF.all_reduce(x, TOp.SUM, "dp"), (4, 3), True),
    "all_reduce-AVG": (lambda x: JF.all_reduce(x, JOp.AVG, "dp"),
                       lambda x: TF.all_reduce(x, TOp.AVG, "dp"), (4, 3), True),
    "all_reduce-PREMUL_SUM": (lambda x: JF.all_reduce(x, JPremul(0.25), "dp"),
                              lambda x: TF.all_reduce(x, TPremul(0.25), "dp"), (4, 3), True),
    "all_reduce-PRODUCT": (lambda x: JF.all_reduce(x, JOp.PRODUCT, "dp"),
                           lambda x: TF.all_reduce(x, TOp.PRODUCT, "dp"), (4, 3), True),
    "all_reduce-MAX": (lambda x: JF.all_reduce(x, JOp.MAX, "dp"),
                       lambda x: TF.all_reduce(x, TOp.MAX, "dp"), (4, 3), False),
    "all_gather-0": (lambda x: JF.all_gather(x, "dp", 0),
                     lambda x: TF.all_gather(x, "dp", 0), (4, 3), True),
    "all_gather-1": (lambda x: JF.all_gather(x, "dp", 1),
                     lambda x: TF.all_gather(x, "dp", 1), (4, 3), True),
    "all_gather-untiled": (lambda x: JF.all_gather(x, "dp", 1, tiled=False),
                           lambda x: TF.all_gather(x, "dp", 1, tiled=False), (4, 3), True),
    "reduce_scatter-0": (lambda x: JF.reduce_scatter(x, "dp", 0),
                         lambda x: TF.reduce_scatter(x, "dp", 0), (16, 3), True),
    "reduce_scatter-1": (lambda x: JF.reduce_scatter(x, "dp", 1),
                         lambda x: TF.reduce_scatter(x, "dp", 1), (2, 8), True),
    "all_to_all-0-1": (lambda x: JF.all_to_all(x, "dp", 0, 1),
                       lambda x: TF.all_to_all(x, "dp", 0, 1), (16, 3), True),
    "all_to_all-1-0": (lambda x: JF.all_to_all(x, "dp", 1, 0),
                       lambda x: TF.all_to_all(x, "dp", 1, 0), (2, 8), True),
    "all_to_all_single": (lambda x: JF.all_to_all_single(x, "dp"),
                          lambda x: TF.all_to_all_single(x, "dp"), (8, 3), True),
    "broadcast": (lambda x: JF.broadcast(x, 3, "dp"),
                  lambda x: TF.broadcast(x, 3, "dp"), (4, 3), True),
    "gather": (lambda x: JF.gather(x, 2, "dp", 0),
               lambda x: TF.gather(x, 2, "dp", 0), (4, 3), True),
    "scatter": (lambda x: JF.scatter(x, 1, "dp", 0),
                lambda x: TF.scatter(x, 1, "dp", 0), (16, 3), True),
    "reduce": (lambda x: JF.reduce(x, 2, JOp.SUM, "dp"),
               lambda x: TF.reduce(x, 2, TOp.SUM, "dp"), (4, 3), True),
}


def _mesh(shape, names):
    return Mesh(np.array(jax.devices()[:int(np.prod(shape))]).reshape(shape), names)


def _reference(fn, X, C, mesh, spec, grad=True):
    """(value, gradient of sum(value * C)) of the shard-mapped fn."""
    f = shard_map_fn(fn, mesh=mesh, in_specs=(spec,), out_specs=spec)
    if not grad:
        return np.asarray(f(jnp.asarray(X))), None
    y, vjp = jax.vjp(f, jnp.asarray(X))
    return np.asarray(y), np.asarray(vjp(jnp.asarray(C, y.dtype))[0])


def _port(fn, x_stacked, C_stacked, grad):
    x = torch.tensor(x_stacked, requires_grad=grad)
    y = fn(x)
    if grad:
        y.backward(torch.tensor(C_stacked))
    return y.detach().numpy(), (x.grad.numpy() if grad else None)


@pytest.mark.parametrize("name", list(CASES))
def test_matches_reference_on_one_axis(name):
    jfn, tfn, local, grad = CASES[name]
    gen = np.random.default_rng(abs(hash(name)) % 1000)
    X = gen.standard_normal((W * local[0],) + local[1:]).astype(np.float32)
    if name.endswith("PRODUCT"):
        X[3, 1] = 0.0  # a zero factor: value and gradient 0 there
    mesh = _mesh((W,), ("dp",))
    y_shape = jax.eval_shape(shard_map_fn(jfn, mesh=mesh, in_specs=(P("dp"),),
                                          out_specs=P("dp")), X).shape
    C = gen.standard_normal(y_shape).astype(np.float32)
    want_y, want_g = _reference(jfn, X, C, mesh, P("dp"), grad)
    stack = lambda a: a.reshape((W, a.shape[0] // W) + a.shape[1:])
    got_y, got_g = _port(tfn, stack(X), stack(C), grad)
    tol = dict(rtol=2e-5, atol=2e-5) if name.endswith("PRODUCT") else TOL
    np.testing.assert_allclose(got_y, stack(want_y), **tol)
    if grad:
        np.testing.assert_allclose(got_g, stack(want_g), **tol)


@pytest.mark.parametrize("op", ["all_reduce", "all_gather", "reduce_scatter", "all_to_all"])
def test_matches_reference_on_one_axis_of_a_2d_mesh(op):
    """Rank (f, t) of a (2, 4) ("fsdp", "tp") mesh holds block 4f + t; the
    op folds over "tp" only."""
    axes = ("fsdp", "tp")
    jfn = {"all_reduce": lambda x: JF.all_reduce(x, JOp.SUM, "tp"),
           "all_gather": lambda x: JF.all_gather(x, "tp", 1),
           "reduce_scatter": lambda x: JF.reduce_scatter(x, "tp", 0),
           "all_to_all": lambda x: JF.all_to_all(x, "tp", 0, 1)}[op]
    tfn = {"all_reduce": lambda x: TF.all_reduce(x, TOp.SUM, "tp", axes=axes),
           "all_gather": lambda x: TF.all_gather(x, "tp", 1, axes=axes),
           "reduce_scatter": lambda x: TF.reduce_scatter(x, "tp", 0, axes=axes),
           "all_to_all": lambda x: TF.all_to_all(x, "tp", 0, 1, axes=axes)}[op]
    gen = np.random.default_rng(7)
    X = gen.standard_normal((8 * 8, 3)).astype(np.float32)
    mesh = _mesh((2, 4), axes)
    spec = P(("fsdp", "tp"))
    y_shape = jax.eval_shape(shard_map_fn(jfn, mesh=mesh, in_specs=(spec,), out_specs=spec),
                             X).shape
    C = gen.standard_normal(y_shape).astype(np.float32)
    want_y, want_g = _reference(jfn, X, C, mesh, spec)
    stack = lambda a: a.reshape((2, 4, a.shape[0] // 8) + a.shape[1:])
    got_y, got_g = _port(tfn, stack(X), stack(C), True)
    np.testing.assert_allclose(got_y, stack(want_y), **TOL)
    np.testing.assert_allclose(got_g, stack(want_g), **TOL)


def test_replica_forms_are_megatrons_f_and_g():
    """replicate (f: copy, backward all_reduce) then all_reduce(replica=True)
    (g: all_reduce, backward copy) equal the full forms' values and give
    the replica the gradient of every rank's use."""
    gen = np.random.default_rng(3)
    x = torch.tensor(gen.standard_normal((5, 3)), requires_grad=True)
    w = torch.tensor(gen.standard_normal((4, 3, 3)))
    y = TF.all_reduce(torch.bmm(TF.replicate(x, "tp", 4).contiguous(), w), TOp.SUM, "tp",
                      replica=True)
    y.pow(2).sum().backward()
    x2 = x.detach().clone().requires_grad_()
    want = x2 @ w.sum(0)
    want.pow(2).sum().backward()
    torch.testing.assert_close(y, want)
    torch.testing.assert_close(x.grad, x2.grad)
    # all_gather(replica=True): the value every rank holds, and each rank
    # the slice of the gradient
    s = torch.tensor(gen.standard_normal((4, 2, 3)), requires_grad=True)
    g = TF.all_gather(s, "tp", 0, replica=True)
    assert g.shape == (8, 3)
    g.backward(torch.arange(24.0, dtype=g.dtype).reshape(8, 3))
    torch.testing.assert_close(s.grad, torch.arange(24.0, dtype=g.dtype).reshape(4, 2, 3))


def test_rank_dims_are_checked():
    with pytest.raises(ValueError, match="not one of the rank dims"):
        TF.all_reduce(torch.zeros(2, 3), axis_name="tp", axes=("fsdp",))
    with pytest.raises(ValueError, match="not divisible"):
        TF.all_to_all_single(torch.zeros(4, 3, 2), "dp")
