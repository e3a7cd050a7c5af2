"""The port's DTensor against the reference's, on the CPU.

The same arrays (numpy seeds) go through both packages: placements,
`from_local` (Shard and Partial stacks), `to_local`'s per-rank shards in
rank order, `full_tensor`, `redistribute` between layouts, arithmetic and
`distribute_module`. The reference lays them out over the conftest's CPU
mesh, the port stacks the ranks' locals on the CPU (driver mode); values
agree exactly (float32 sums within 1e-6).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_distributed_example_tpu import dtensor as J
from pytorch_distributed_example_tpu.mesh import init_device_mesh
from pytorch_distributed_example_tpu.types import ReduceOp as JOp
from pytorch_distributed_example_tpu_torch import dtensor as T
from pytorch_distributed_example_tpu_torch.mesh import DeviceMesh
from pytorch_distributed_example_tpu_torch.types import ReduceOp as TOp

MESHES = {"1d": (("dp",), (8,)), "2d": (("dp", "tp"), (4, 2))}


def _meshes(kind):
    names, shape = MESHES[kind]
    n = int(np.prod(shape))
    return (init_device_mesh(names, shape, devices=jax.devices()[:n]),
            DeviceMesh(["cpu"] * n, shape, names))


def _x(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _place(pkg, spec):
    """Placements named like "S0", "S1", "R", "P" in either package."""
    out = []
    for p in spec:
        if p == "R":
            out.append(pkg.Replicate())
        elif p == "P":
            out.append(pkg.Partial())
        else:
            out.append(pkg.Shard(int(p[1:])))
    return out


LAYOUTS = [("1d", ("S0",)), ("1d", ("S1",)), ("1d", ("R",)), ("1d", ("S-1",)),
           ("2d", ("S0", "S1")), ("2d", ("R", "S1")), ("2d", ("S1", "R")),
           ("2d", ("S1", "S0"))]


@pytest.mark.parametrize("kind,spec", LAYOUTS, ids=[f"{k}-{'-'.join(s)}" for k, s in LAYOUTS])
def test_distribute_and_to_local_match(kind, spec):
    jm, tm = _meshes(kind)
    x = _x(1, (8, 16))
    jd = J.distribute_tensor(jnp.asarray(x), jm, _place(J, spec))
    td = T.distribute_tensor(torch.from_numpy(x), tm, _place(T, spec))
    assert td.shape == jd.shape == (8, 16)
    assert tuple(map(repr, td.placements)) == tuple(map(repr, jd.placements))
    jl, tl = jd.to_local(), td.to_local()
    if isinstance(jl, list):
        assert len(jl) == len(tl)
        for a, b in zip(jl, tl):
            np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    else:
        np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    np.testing.assert_array_equal(td.full_tensor().numpy(), x)


@pytest.mark.parametrize("src,dst", [(("S0",), ("S1",)), (("S1",), ("R",)), (("R",), ("S0",))])
def test_redistribute_matches(src, dst):
    jm, tm = _meshes("1d")
    x = _x(2, (16, 8))
    jd = J.distribute_tensor(jnp.asarray(x), jm, _place(J, src)).redistribute(_place(J, dst))
    td = T.distribute_tensor(torch.from_numpy(x), tm, _place(T, src)).redistribute(
        _place(T, dst))
    assert tuple(map(repr, td.placements)) == tuple(map(repr, jd.placements))
    for a, b in zip(jd.to_local(), td.to_local()):
        np.testing.assert_array_equal(np.asarray(b), np.asarray(a))


@pytest.mark.parametrize("kind,spec", [("1d", ("S0",)), ("2d", ("S0", "S1")),
                                       ("2d", ("R", "S0"))])
def test_from_local_matches(kind, spec):
    """One leading stack dim per non-Replicate placement, in mesh order."""
    jm, tm = _meshes(kind)
    names, shape = MESHES[kind]
    stacks = tuple(n for n, p in zip(shape, spec) if p != "R")
    local = _x(3, stacks + (2, 3))
    jd = J.DTensor.from_local(jnp.asarray(local), jm, _place(J, spec))
    td = T.DTensor.from_local(torch.from_numpy(local), tm, _place(T, spec))
    assert td.shape == jd.shape
    np.testing.assert_array_equal(td.full_tensor().numpy(), np.asarray(jd.full_tensor()))


@pytest.mark.parametrize("op", ["SUM", "AVG", "MAX"])
def test_partial_reduces_like_the_reference(op):
    jm, tm = _meshes("1d")
    local = _x(4, (8, 16))
    jd = J.DTensor.from_local(jnp.asarray(local), jm, [J.Partial(JOp[op])])
    td = T.DTensor.from_local(torch.from_numpy(local), tm, [T.Partial(TOp[op])])
    assert td.shape == jd.shape == (16,)
    np.testing.assert_array_equal(td.to_local().numpy(), np.asarray(jd.to_local()))
    for place in ("R", "S0"):
        a = jd.redistribute(_place(J, (place,)))
        b = td.redistribute(_place(T, (place,)))
        np.testing.assert_allclose(b.full_tensor().numpy(), np.asarray(a.full_tensor()),
                                   rtol=1e-6, atol=1e-6)
    with pytest.raises(ValueError):
        td.to_global()


def test_arithmetic_matches():
    jm, tm = _meshes("2d")
    x, y = _x(5, (8, 6)), _x(6, (8, 6))
    w = _x(7, (6, 4))
    ja = J.distribute_tensor(jnp.asarray(x), jm, [J.Shard(0), J.Replicate()])
    jb = J.distribute_tensor(jnp.asarray(y), jm, [J.Replicate(), J.Shard(1)])
    ta = T.distribute_tensor(torch.from_numpy(x), tm, [T.Shard(0), T.Replicate()])
    tb = T.distribute_tensor(torch.from_numpy(y), tm, [T.Replicate(), T.Shard(1)])
    for jr, tr in ((ja + jb, ta + tb), (ja - jb, ta - tb), (ja * jb, ta * tb),
                   (ja * 2.0, ta * 2.0), (ja @ jnp.asarray(w), ta @ torch.from_numpy(w)),
                   (ja.sum(0), ta.sum(0))):
        np.testing.assert_allclose(tr.full_tensor().numpy(), np.asarray(jr.full_tensor()),
                                   rtol=1e-6, atol=1e-6)


def test_distribute_module_matches():
    jm, tm = _meshes("1d")
    params = {"w": _x(8, (16, 4)), "b": _x(9, (4,))}

    def jfn(name, leaf):
        return [J.Shard(0)] if name == "w" else [J.Replicate()]

    def tfn(name, leaf):
        return [T.Shard(0)] if name == "w" else [T.Replicate()]

    jtree = J.distribute_module({k: jnp.asarray(v) for k, v in params.items()}, jm, jfn)
    ttree = T.distribute_module({k: torch.from_numpy(v) for k, v in params.items()}, tm, tfn)
    for k in params:
        assert tuple(map(repr, ttree[k].placements)) == tuple(map(repr, jtree[k].placements))
    got = T.unwrap_module(ttree)
    for k, v in J.unwrap_module(jtree).items():
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(v))


def test_full_tensor_is_differentiable():
    _, tm = _meshes("2d")
    x = torch.from_numpy(_x(10, (8, 6)))
    td = T.distribute_tensor(x, tm, [T.Shard(0), T.Shard(1)])
    td._local.requires_grad_()
    (td.full_tensor() * torch.arange(48.0).reshape(8, 6)).sum().backward()
    grad = T.DTensor(td._local.grad, tm, td.placements).full_tensor()
    torch.testing.assert_close(grad, torch.arange(48.0).reshape(8, 6))


def test_errors_match_the_reference():
    _, tm = _meshes("2d")
    x = torch.zeros(8, 6)
    with pytest.raises(NotImplementedError):
        T.distribute_tensor(x, tm, [T.Shard(0), T.Shard(0)])
    with pytest.raises(ValueError):
        T.distribute_tensor(torch.zeros(9, 2), tm, [T.Shard(0), T.Replicate()])
    with pytest.raises(ValueError):
        T.distribute_tensor(x, tm, [T.Partial(), T.Replicate()])
    with pytest.raises(NotImplementedError):
        T.distribute_tensor(x, tm, [T.Shard(0), T.Replicate()]).redistribute(
            [T.Partial(), T.Replicate()])
    with pytest.raises(ValueError, match="one placement per mesh axis"):
        T.distribute_tensor(x, tm, [T.Shard(0)])


def test_distribute_tensor_copies():
    """Every layout gets storage of its own: updating the DTensor leaves
    the source alone (a replicated layout used to alias it)."""
    _, tm = _meshes("2d")
    for placements in ([T.Replicate(), T.Replicate()], [T.Shard(0), T.Replicate()]):
        x = torch.zeros(8, 16)
        td = T.distribute_tensor(x, tm, placements)
        td._local.add_(1.0)
        assert float(x.abs().sum()) == 0.0, placements
