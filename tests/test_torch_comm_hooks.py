"""The port's comm hooks (`parallel/comm_hooks.py`) and codec (`ops/quant.py`)
against the reference's, at world 2 and 4.

Every rank gets its own gradients, a dict of leaves from a numpy seed in
the reference's layout: a dense kernel, a conv kernel (HWIO), a bias and a
vector too small for the quantized path's blocks. The reference's hook runs
under `shard_map` over that many of the conftest's CPU devices; the port's
runs in driver mode on the same rank-stacked values, the flat hooks on the
leaves packed into one buffer, the per-leaf hooks on the leaves in the same
order.

Tolerances, all float32 unless named:
  * bf16 / fp16 compression: the reference's pmean adds the half-width
    values in the wire dtype where the port's fold adds them in float32
    and rounds once, so the two agree within one ulp of the wire dtype
    (rtol 2^-7 for bf16, 2^-10 for fp16, relative to the mean's scale);
  * the block codec: payload and scales bit for bit (round half to even,
    float32 division on both sides), dequant bit for bit;
  * the quantized all-reduce: the float32 combine within 1e-6 (XLA and
    torch add the W rows in other orders), so the requantized result may
    move by one step of the wire's grid where a partial sum sits on a
    rounding boundary (1/127 of the block's amax for int8, 2^-3 of the
    value for fp8's e4m3); at least 99% of elements are held within 1e-6
    and the rest within that step;
  * PowerSGD: reduced gradients and error feedback over 3 steps within
    rtol 1e-4, atol 1e-5 of the largest entry (LAPACK's Householder QR on
    both sides, in other orders; the column signs cancel in P Q^T).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from jax.sharding import Mesh, PartitionSpec as P

import pytorch_distributed_example_tpu_torch as tdx
from pytorch_distributed_example_tpu._compat import shard_map_fn
from pytorch_distributed_example_tpu.ops import quant as jquant
from pytorch_distributed_example_tpu.parallel import comm_hooks as jhooks
from pytorch_distributed_example_tpu_torch import optim
from pytorch_distributed_example_tpu_torch.data import SyntheticMNIST
from pytorch_distributed_example_tpu_torch.examples import mnist
from pytorch_distributed_example_tpu_torch.models import ConvNet
from pytorch_distributed_example_tpu_torch.ops import quant
from pytorch_distributed_example_tpu_torch.parallel import comm_hooks
from pytorch_distributed_example_tpu_torch.tensor import DistTensor
from pytorch_distributed_example_tpu_torch.utils.flight_recorder import global_recorder

# in sorted order: the order in which jax flattens a dict, so the per-leaf
# lists of both packages line up
SHAPES = {"bias": (40,), "conv": (3, 3, 8, 16), "dense": (48, 40), "tiny": (7,)}
WORLDS = [2, 4]


def _grads(world, seed=0, scale=1.0):
    gen = np.random.default_rng(seed)
    return {n: (gen.standard_normal((world,) + s) * scale).astype(np.float32)
            for n, s in SHAPES.items()}


def _shard_map(fn, world, n_in=1):
    mesh = Mesh(np.array(jax.devices()[:world]), ("r",))
    return jax.jit(shard_map_fn(fn, mesh=mesh, in_specs=(P("r"),) * n_in,
                                out_specs=P("r")))


def _jax_stateless(hook, grads, world):
    def body(g):
        local = jax.tree_util.tree_map(lambda l: l[0], g)
        return jax.tree_util.tree_map(lambda l: l[None], hook(local, "r"))
    return jax.device_get(_shard_map(body, world)(grads))


def _jax_stateful(hook, state, grads, world):
    def body(s, g):
        s0 = jax.tree_util.tree_map(lambda l: l[0], s)
        g0 = jax.tree_util.tree_map(lambda l: l[0], g)
        out, ns = hook.apply(s0, g0, "r")
        return jax.tree_util.tree_map(lambda l: l[None], (out, ns))
    return jax.device_get(_shard_map(body, world, n_in=2)(state, grads))


def _stack_state(state, world):
    return jax.tree_util.tree_map(
        lambda l: np.broadcast_to(np.asarray(l)[None], (world,) + l.shape).copy(), state)


@pytest.fixture(params=WORLDS)
def group(request):
    pg = tdx.init_process_group(world_size=request.param, device="cpu")
    yield pg
    tdx.destroy_process_group()


def _port_flat(hook, grads, pg):
    W = pg.size()
    flat = torch.cat([torch.from_numpy(g).reshape(W, -1) for g in grads.values()], 1)
    out = hook(DistTensor.wrap(flat, pg), pg).tensor
    res, off = {}, 0
    for n, g in grads.items():
        k = g[0].size
        res[n] = out[:, off:off + k].reshape(g.shape).numpy()
        off += k
    return res


def _port_leaves(grads, pg):
    return [DistTensor.wrap(torch.from_numpy(g.copy()), pg) for g in grads.values()]


@pytest.mark.parametrize("name,ulp", [("bf16_compress_hook", 2.0 ** -7),
                                      ("fp16_compress_hook", 2.0 ** -10)])
def test_compress_hooks_match_the_reference(group, name, ulp):
    W = group.size()
    grads = _grads(W)
    want = _jax_stateless(getattr(jhooks, name), grads, W)
    got = _port_flat(getattr(comm_hooks, name), grads, group)
    for n in grads:
        scale = np.abs(want[n]).max()
        np.testing.assert_allclose(got[n], want[n], rtol=ulp, atol=ulp * scale, err_msg=n)
        assert not np.array_equal(got[n], grads[n].mean(0, keepdims=True).repeat(W, 0))


def test_codec_is_bitwise_the_reference():
    x = np.random.default_rng(3).standard_normal((6, 1024)).astype(np.float32)
    x[2, :256] = 0.0  # a zero block
    x[3, 5] = 0.5 * np.abs(x[3, :256]).max() / 127 * 127  # a tie on the grid's scale
    for bits in (8, 4):
        jq, js = jquant.quantize_blockwise(jnp.asarray(x), 256, bits=bits)
        tq, ts = quant.quantize_blockwise(torch.from_numpy(x), 256, bits=bits)
        assert tq.dtype == torch.int8 and ts.dtype == torch.float32
        np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
        np.testing.assert_array_equal(quant.dequantize_blockwise(tq, ts, 256).numpy(),
                                      np.asarray(jquant.dequantize_blockwise(jq, js, 256)))
    jq, js = jquant.quantize_blockwise_fp8(jnp.asarray(x), 256)
    tq, ts = quant.quantize_blockwise_fp8(torch.from_numpy(x), 256)
    assert tq.dtype == torch.bfloat16
    np.testing.assert_array_equal(tq.float().numpy(), np.asarray(jq, np.float32))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    for wire in (None, "bf16", "int8", "fp8"):
        assert quant.allreduce_wire_bytes(10_000, 8, wire) == \
            jquant.allreduce_wire_bytes(10_000, 8, wire)
    with pytest.raises(ValueError, match="divisible"):
        quant.quantize_blockwise(torch.zeros(300))


def _close_within_a_quantum(got, want, n, wire="int8"):
    """Within 1e-6 (99% of elements at least), else one phase-2 quantum
    where a partial sum sat on a rounding boundary: 1/127 of the block's
    amax on the int8 grid, an e4m3 step (2^-3 of the value) on fp8's."""
    exact = np.isclose(got, want, rtol=1e-6, atol=1e-6)
    assert exact.mean() >= 0.99, (n, exact.mean())
    if wire == "int8":
        quantum = np.abs(want).max() / 127 * 1.01
    else:
        quantum = np.abs(want) * 2.0 ** -3 * 1.01 + 1e-6
    assert (np.abs(got - want) <= np.maximum(quantum, 1e-6 + 1e-6 * np.abs(want))).all(), n


@pytest.mark.parametrize("wire", ["int8", "fp8"])
def test_stateless_quant_hook_matches_the_reference(group, wire):
    W = group.size()
    grads = _grads(W, seed=1)
    want = _jax_stateless(jhooks.blockwise_quant_hook(error_feedback=False, wire=wire),
                          grads, W)
    hook = comm_hooks.blockwise_quant_hook(error_feedback=False, wire=wire)
    assert hook.per_leaf
    rec = global_recorder()
    out = hook(_port_leaves(grads, group), group)
    for (n, w), o in zip(want.items(), out):
        _close_within_a_quantum(o.tensor.numpy(), w, n, wire)
        np.testing.assert_array_equal(o.tensor.numpy()[0], o.tensor.numpy()[-1])
    # the wire: the payload in its wire dtype in both phases, scales in f32
    wire_dtype = "int8" if wire == "int8" else "bfloat16"
    ops = [(e.op, e.dtype) for e in rec.entries()[-5:]]
    assert ops == [("all_reduce", "float32"),  # the bias and the tiny leaf, exact
                   ("all_to_all", wire_dtype), ("all_to_all", "float32"),
                   ("all_gather", wire_dtype), ("all_gather", "float32")], ops


def test_quantize_hook_is_the_deprecated_alias(group):
    with pytest.warns(DeprecationWarning, match="deprecated"):
        hook = comm_hooks.quantize_hook(bits=8)
    assert hook.per_leaf and hook.__name__ == "blockwise_quant_hook_int8_stateless"


def test_stateful_quant_hook_and_error_feedback_match_the_reference(group):
    W = group.size()
    jhook = jhooks.blockwise_quant_hook(error_feedback=True)
    hook = comm_hooks.blockwise_quant_hook(error_feedback=True)
    params = {n: np.zeros(s, np.float32) for n, s in SHAPES.items()}
    jstate = _stack_state(jhook.init(params), W)
    tstate = {"error": [torch.from_numpy(e.copy()) for e in jstate["error"]]}
    assert [tuple(e.shape) for e in tstate["error"]] == \
        [tuple(e.shape) for e in jax.tree_util.tree_leaves(
            _stack_state(hook.init({n: torch.zeros(s) for n, s in SHAPES.items()}), W))]
    for step in range(3):
        grads = _grads(W, seed=10 + step)
        want, jstate = _jax_stateful(jhook, jstate, grads, W)
        out, tstate = hook.apply(tstate, _port_leaves(grads, group), group)
        for (n, w), o in zip(want.items(), out):
            _close_within_a_quantum(o.tensor.numpy(), w, n)
        for n, je, te in zip(SHAPES, jstate["error"], tstate["error"]):
            np.testing.assert_allclose(te.numpy(), je, rtol=1e-6, atol=1e-6, err_msg=n)
        dense = tstate["error"][2]
        assert dense.abs().sum() > 0 and not torch.equal(dense[0], dense[1])  # per rank


@pytest.mark.parametrize("ef,warm", [(True, True), (False, False)])
def test_powersgd_matches_the_reference_over_three_steps(group, ef, warm):
    W = group.size()
    kw = dict(use_error_feedback=ef, warm_start=warm, seed=3)
    jhook, hook = jhooks.powerSGD_hook(rank=2, **kw), comm_hooks.powerSGD_hook(rank=2, **kw)
    params = {n: np.zeros(s, np.float32) for n, s in SHAPES.items()}
    jstate = _stack_state(jhook.init(params), W)
    local = hook.init({n: torch.zeros(s) for n, s in SHAPES.items()})
    jlocal = jhook.init(params)
    for k in ("q", "error"):  # the same draws, in order; zero errors
        for a, b in zip(local[k], jlocal[k]):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    tstate = {k: [torch.from_numpy(np.asarray(v).copy()) for v in jstate[k]]
              for k in ("error", "q")}
    assert hook.compression_ratio(params) == jhook.compression_ratio(params)
    for step in range(3):
        grads = _grads(W, seed=20 + step)
        want, jstate = _jax_stateful(jhook, jstate, grads, W)
        out, tstate = hook.apply(tstate, _port_leaves(grads, group), group)
        for (n, w), o in zip(want.items(), out):
            np.testing.assert_allclose(o.tensor.numpy(), w, rtol=1e-4,
                                       atol=1e-5 * np.abs(w).max(), err_msg=n)
        for n, je, te in zip(SHAPES, jstate["error"], tstate["error"]):
            np.testing.assert_allclose(te.numpy(), je, rtol=1e-4,
                                       atol=1e-5 * np.abs(je).max(initial=0.0), err_msg=n)


def test_quant_hook_with_error_feedback_under_zero_trains_mnist(port_world8):
    """The contract of the reference's `test_quant_hook_planner_composition`
    without its planner: the stateful int8 hook under ZeRO "auto" trains
    MNIST (12 steps of 64, SGD 0.05 momentum 0.9) to a final loss within
    1% (floor 1e-3) of the float32 unsharded run."""
    ds = SyntheticMNIST(512)

    def train(hook, mode):
        model = ConvNet(device="cpu", generator=torch.Generator().manual_seed(0))
        ddp = tdx.DistributedDataParallel(model)
        if hook is not None:
            ddp.register_comm_hook(None, hook)
        opt = optim.sgd(0.05, momentum=0.9)
        step = ddp.make_train_step(opt, F.cross_entropy, shard_weight_update=mode)
        p, o = ddp.params, step.init_opt_state(ddp.params)
        hs = step.init_hook_state(p) if hasattr(step, "init_hook_state") else None
        losses = []
        for i in range(12):
            x, y = mnist.to_device(*ds[np.arange(i * 64, (i + 1) * 64) % len(ds)], "cpu")
            if hs is not None:
                p, o, hs, loss = step(p, o, hs, x, y)
            else:
                p, o, loss = step(p, o, x, y)
            losses.append(float(loss))
        return losses, step

    quant_losses, qstep = train(comm_hooks.blockwise_quant_hook(bits=8, error_feedback=True),
                                "auto")
    ref, _ = train(None, "off")
    assert qstep.weight_update_sharded
    assert quant_losses[-1] < quant_losses[0] * 0.8
    assert abs(quant_losses[-1] - ref[-1]) <= max(0.01 * abs(ref[-1]), 1e-3)


@pytest.fixture
def port_world8():
    pg = tdx.init_process_group(world_size=8, device="cpu")
    yield pg
    tdx.destroy_process_group()


def test_hook_views_give_per_leaf_hooks_the_reference_layout(group):
    """A per-leaf hook sees each leaf permuted by its view and in the
    views' order; its output comes back in the port's layout."""
    from pytorch_distributed_example_tpu_torch.parallel.ddp import make_ddp_train_step

    seen = []

    def spy(grads, g):
        seen.extend(tuple(t.shape) for t in grads)
        return comm_hooks.blockwise_quant_hook(error_feedback=False)(grads, g)

    spy.per_leaf = True
    W = group.size()
    torch.manual_seed(0)
    params = {"w": torch.randn(5, 3), "b": torch.randn(5)}
    step = make_ddp_train_step(lambda p, x: x @ p["w"].T + p["b"], lambda o, y: o.square().mean(),
                               optim.sgd(0.1), comm_hook=spy,
                               hook_views={"b": None, "w": (1, 0)})
    step(params, {}, torch.randn(2 * W, 3), torch.zeros(2 * W))
    assert seen == [(5,), (3, 5)]  # each rank's leaf, permuted by its view
