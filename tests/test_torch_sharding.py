"""The port's sharding rules and TP seams against the reference's, on the CPU.

* `spec_for` / `make_param_specs` on both packages' trees of the repo's
  ~1B configuration (CFG_1B's shapes, dense and MoE) and of a small one
  whose dims some axes do not divide: each port leaf's spec, read in the
  reference's layout (the port's (out, in) weights transposed), names the
  same mesh axis on the same dim as the reference's.
* The Megatron seams (`column_parallel_matmul`, `row_parallel_matmul`,
  `mlp_block_tp`, `vocab_parallel_logits`, `gathered_matmul`) and
  `vocab_parallel_cross_entropy`, value and gradient, against the
  reference's under `shard_map` over 4 tp ranks of the conftest's mesh:
  float32, rtol 1e-5.
* `parallelize_module` lays a module out as the plan says.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

from pytorch_distributed_example_tpu._compat import shard_map_fn
from pytorch_distributed_example_tpu.models import transformer as jtr
from pytorch_distributed_example_tpu.parallel import sharding as jshd
from pytorch_distributed_example_tpu.parallel import tensor_parallel as JTP
from pytorch_distributed_example_tpu_torch.dtensor import Replicate, Shard
from pytorch_distributed_example_tpu_torch.mesh import DeviceMesh
from pytorch_distributed_example_tpu_torch.models import transformer as ttr
from pytorch_distributed_example_tpu_torch.parallel import sharding as tshd
from pytorch_distributed_example_tpu_torch.parallel import tensor_parallel as TTP

TOL = dict(rtol=1e-5, atol=1e-5)
T = 4
CFG_1B = dict(vocab_size=32000, d_model=2048, n_layers=2, n_heads=16, d_ff=5504)
SMALL = dict(vocab_size=100, d_model=64, n_layers=1, n_heads=4, d_ff=96)


def _ref_path(name):
    """The port's state_dict key -> (the reference's param path, transposed)."""
    parts = name.split(".")
    if parts[0] == "layers":
        parts = [f"layers_{parts[1]}"] + parts[2:]
    *mods, leaf = parts
    if leaf in ("router", "experts_up", "experts_down"):
        return "/".join(mods + [leaf]), False
    if mods == ["tok_embed"]:
        return "tok_embed/embedding", False
    if mods[-1].endswith("_norm"):
        return "/".join(mods + ["scale"]), False
    return "/".join(mods + ["kernel"]), True


def _padded(spec, ndim):
    spec = tuple(spec)
    return spec + (None,) * (ndim - len(spec))


@pytest.mark.parametrize("kw", [CFG_1B, SMALL], ids=["cfg_1b", "small"])
@pytest.mark.parametrize("n_experts", [0, 8], ids=["dense", "moe"])
@pytest.mark.parametrize("mesh_shape", [(2, 2), (4, 2), (8, 1)])
def test_param_specs_match_reference(kw, n_experts, mesh_shape):
    jcfg = jtr.TransformerConfig(n_experts=n_experts, **kw)
    shapes = jax.eval_shape(jtr.TransformerLM(jcfg).init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 8), jnp.int32))["params"]
    jmesh = Mesh(np.array(jax.devices()[:int(np.prod(mesh_shape))]).reshape(mesh_shape),
                 ("fsdp", "tp"))
    want = {jshd.path_of(p): (s, leaf.shape) for (p, leaf), s in zip(
        jax.tree_util.tree_leaves_with_path(shapes),
        jax.tree_util.tree_leaves(jshd.make_param_specs(shapes, jtr.sharding_rules(), jmesh)))}
    model = ttr.TransformerLM(ttr.TransformerConfig(n_experts=n_experts, **kw), device="meta")
    tmesh = DeviceMesh(["cpu"] * int(np.prod(mesh_shape)), mesh_shape, ("fsdp", "tp"))
    got = tshd.make_param_specs(model, ttr.sharding_rules(), tmesh)
    assert len(got) == len(want)
    for name, spec in got.items():
        path, transposed = _ref_path(name)
        wspec, wshape = want[path]
        ndim = len(wshape)
        mine = _padded(spec, ndim)
        assert (mine[::-1] if transposed else mine) == _padded(wspec, ndim), name


def test_spec_for_drops_an_axis_that_does_not_divide():
    mesh = DeviceMesh(["cpu"] * 4, (4,), ("fsdp",))
    rules = tshd.fsdp_rules("fsdp")
    assert tshd.spec_for("w", (8, 3), rules, mesh) == ("fsdp",)
    assert tshd.spec_for("w", (6, 3), rules, mesh) == ()
    assert tshd.spec_for("w", (), rules, mesh) == ()
    with pytest.raises(ValueError, match="names mesh axis 'tp'"):
        tshd.spec_for("w", (8,), [(r".*", ("tp",))], mesh)
    assert tshd.data_spec(mesh, ("dp", "fsdp")) == ("fsdp",)
    assert tshd.replicated_specs({"a": torch.zeros(2)}) == {"a": ()}


def _tp_mesh():
    return Mesh(np.array(jax.devices()[:T]), ("tp",))


def _ref(fn, in_specs, out_spec, args, ct):
    f = shard_map_fn(fn, mesh=_tp_mesh(), in_specs=in_specs, out_specs=out_spec)
    y, vjp = jax.vjp(f, *[jnp.asarray(a) for a in args])
    return np.asarray(y), [np.asarray(g) for g in vjp(jnp.asarray(ct, y.dtype))]


def _cols(w):  # (in, out) -> (T, in, out/T): the ranks' column blocks
    return w.reshape(w.shape[0], T, -1).transpose(1, 0, 2)


def _rows(w):  # (in, out) -> (T, in/T, out)
    return w.reshape(T, -1, w.shape[1])


def _leaves(*arrays):
    return [torch.tensor(np.ascontiguousarray(a), requires_grad=True) for a in arrays]


def test_column_parallel_matmul_matches():
    gen = np.random.default_rng(0)
    x, w = gen.standard_normal((6, 8), np.float32), gen.standard_normal((8, 12), np.float32)
    ct = gen.standard_normal((6, 12), np.float32)
    y, (dx, dw) = _ref(lambda a, b: JTP.column_parallel_matmul(a, b, "tp"),
                       (P(), P(None, "tp")), P(None, "tp"), (x, w), ct)
    tx, tw = _leaves(x, _cols(w))
    ty = TTP.column_parallel_matmul(tx, tw, "tp")  # (T, 6, 3)
    ty.backward(torch.from_numpy(ct.reshape(6, T, 3).transpose(1, 0, 2).copy()))
    np.testing.assert_allclose(ty.detach().permute(1, 0, 2).reshape(6, 12).numpy(), y, **TOL)
    np.testing.assert_allclose(tx.grad.numpy(), dx, **TOL)
    np.testing.assert_allclose(tw.grad.numpy(), _cols(dw), **TOL)


def test_row_parallel_matmul_and_mlp_block_match():
    gen = np.random.default_rng(1)
    x, w = gen.standard_normal((6, 8), np.float32), gen.standard_normal((8, 5), np.float32)
    ct = gen.standard_normal((6, 5), np.float32)
    y, (dx, dw) = _ref(lambda a, b: JTP.row_parallel_matmul(a, b, "tp"),
                       (P(None, "tp"), P("tp", None)), P(), (x, w), ct)
    tx, tw = _leaves(x.reshape(6, T, 2).transpose(1, 0, 2), _rows(w))
    ty = TTP.row_parallel_matmul(tx, tw, "tp")
    ty.backward(torch.from_numpy(ct))
    np.testing.assert_allclose(ty.detach().numpy(), y, **TOL)
    np.testing.assert_allclose(tx.grad.numpy(), dx.reshape(6, T, 2).transpose(1, 0, 2), **TOL)
    np.testing.assert_allclose(tw.grad.numpy(), _rows(dw), **TOL)

    up, down = gen.standard_normal((8, 16), np.float32), gen.standard_normal((16, 8),
                                                                             np.float32)
    ct = gen.standard_normal((6, 8), np.float32)
    y, (dx, dup, ddown) = _ref(lambda a, b, c: JTP.mlp_block_tp(a, b, c, "tp"),
                               (P(), P(None, "tp"), P("tp", None)), P(), (x, up, down), ct)
    tx, tup, tdown = _leaves(x, _cols(up), _rows(down))
    ty = TTP.mlp_block_tp(tx, tup, tdown, "tp")
    ty.backward(torch.from_numpy(ct))
    np.testing.assert_allclose(ty.detach().numpy(), y, **TOL)
    np.testing.assert_allclose(tx.grad.numpy(), dx, **TOL)
    np.testing.assert_allclose(tup.grad.numpy(), _cols(dup), **TOL)
    np.testing.assert_allclose(tdown.grad.numpy(), _rows(ddown), **TOL)


def test_vocab_parallel_logits_and_gathered_matmul_match():
    gen = np.random.default_rng(2)
    h, emb = gen.standard_normal((6, 8), np.float32), gen.standard_normal((8, 20), np.float32)
    ct = gen.standard_normal((6, 20), np.float32)
    y, (dh, demb) = _ref(lambda a, b: JTP.vocab_parallel_logits(a, b, "tp"),
                         (P(), P(None, "tp")), P(), (h, emb), ct)
    th, temb = _leaves(h, _cols(emb))
    ty = TTP.vocab_parallel_logits(th, temb, "tp")
    ty.backward(torch.from_numpy(ct))
    np.testing.assert_allclose(ty.detach().numpy(), y, **TOL)
    np.testing.assert_allclose(th.grad.numpy(), dh, **TOL)
    np.testing.assert_allclose(temb.grad.numpy(), _cols(demb), **TOL)

    x, w = gen.standard_normal((8, 6), np.float32), gen.standard_normal((6, 3), np.float32)
    ct = gen.standard_normal((8, 3), np.float32)
    y, (dx, dw) = _ref(lambda a, b: JTP.gathered_matmul(a, b, "tp"), (P("tp"), P()), P(),
                       (x, w), ct)
    tx, tw = _leaves(x.reshape(T, 2, 6), w)
    ty = TTP.gathered_matmul(tx, tw, "tp")
    ty.backward(torch.from_numpy(ct))
    np.testing.assert_allclose(ty.detach().numpy(), y, **TOL)
    np.testing.assert_allclose(tx.grad.numpy(), dx.reshape(T, 2, 6), **TOL)
    np.testing.assert_allclose(tw.grad.numpy(), dw, **TOL)


def test_vocab_parallel_cross_entropy_matches():
    gen = np.random.default_rng(3)
    logits = gen.standard_normal((2, 5, 16), np.float32) * 3
    targets = gen.integers(0, 16, (2, 5)).astype(np.int32)
    targets[0, 1] = -100  # ignored
    ct = gen.standard_normal((2, 5), np.float32)
    f = shard_map_fn(lambda a, t: JTP.vocab_parallel_cross_entropy(a, t, "tp"),
                     mesh=_tp_mesh(), in_specs=(P(None, None, "tp"), P()), out_specs=P())
    y, vjp = jax.vjp(lambda a: f(a, jnp.asarray(targets)), jnp.asarray(logits))
    (dl,) = vjp(jnp.asarray(ct))
    tl = torch.tensor(logits.reshape(2, 5, T, 4).transpose(2, 0, 1, 3).copy(),
                      requires_grad=True)
    ty = TTP.vocab_parallel_cross_entropy(tl, torch.from_numpy(targets).long(), "tp")
    ty.backward(torch.from_numpy(ct))
    np.testing.assert_allclose(ty.detach().numpy(), np.asarray(y), **TOL)
    np.testing.assert_allclose(tl.grad.numpy(),
                               np.asarray(dl).reshape(2, 5, T, 4).transpose(2, 0, 1, 3), **TOL)
    # and it is the gathered form's cross-entropy
    full = torch.nn.functional.cross_entropy(torch.from_numpy(logits).reshape(10, 16),
                                             torch.from_numpy(targets).long().reshape(10),
                                             reduction="none").reshape(2, 5)
    np.testing.assert_allclose(ty.detach().numpy(), full.numpy(), **TOL)


def test_parallelize_module_lays_out_by_the_plan():
    net = torch.nn.ModuleDict({"emb": torch.nn.Embedding(10, 8), "up": torch.nn.Linear(8, 16),
                               "down": torch.nn.Linear(16, 8), "norm": torch.nn.LayerNorm(8)})
    mesh = DeviceMesh(["cpu"] * 2, (2,), ("tp",))
    params, specs = TTP.parallelize_module(net, mesh, {
        "emb": TTP.ColwiseParallel(), "up": TTP.ColwiseParallel(),
        "down": TTP.RowwiseParallel()})
    assert specs["emb.weight"] == (None, "tp")
    assert specs["up.weight"] == ("tp",) and specs["up.bias"] == ("tp",)
    assert specs["down.weight"] == (None, "tp") and specs["down.bias"] == ()
    assert specs["norm.weight"] == ()
    assert params["up.weight"].placements == (Shard(0),)
    assert params["norm.bias"].placements == (Replicate(),)
    for k, v in net.state_dict().items():
        torch.testing.assert_close(params[k].full_tensor(), v)
    with pytest.raises(TypeError):
        TTP.tp_rules_for_plan({"x": object()})
