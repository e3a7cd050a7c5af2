"""The port's DDP (driver mode at world 8 on the CPU) against the reference's.

Both packages start from the reference's ConvNet params (`PRNGKey(0)`,
carried over with `convnet_from_flax`), dropout off (`has_rng=False`: the
reference's threefry streams and torch's generator streams differ), and run
5 steps of SGD with momentum 0.5 on the synthetic batch of the reference
`bench.py:437-439` at 16 a rank, under `shard_weight_update` "auto" (ZeRO)
and "off". Per-step losses agree within rtol 1e-5 and the final params
within rtol 1e-4, atol 1e-6 (float32 in both; the convolutions and dots sum
in another order).

Within the port the contracts are bitwise: ZeRO "auto" against "off"
(dropout on), and `steps_per_call=3` against three calls; the optimizer
state round-trips the shard layout exactly. The step's reductions go
through the c10d core, which the flight recorder shows. A 2-process gloo
gang runs the same DDP steps in multiproc mode, the bench and the MNIST
example.
"""

import contextlib
import io
import os
import pickle
import subprocess
import sys
import textwrap
import time

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F
from torch.utils import _pytree as pytree

import pytorch_distributed_example_tpu as jtdx
import pytorch_distributed_example_tpu_torch as tdx
from pytorch_distributed_example_tpu.models import ConvNet as JConvNet
from pytorch_distributed_example_tpu.parallel.reducer import Reducer as JReducer
from pytorch_distributed_example_tpu_torch import optim
from pytorch_distributed_example_tpu_torch.bench import bench_ddp_mnist
from pytorch_distributed_example_tpu_torch.examples import mnist
from pytorch_distributed_example_tpu_torch.models import ConvNet, convnet_from_flax
from pytorch_distributed_example_tpu_torch.parallel import comm_hooks, zero
from pytorch_distributed_example_tpu_torch.parallel.ddp import (
    _sync_module_states,
    _verify_params_across_ranks,
    make_ddp_train_step,
)
from pytorch_distributed_example_tpu_torch.parallel.reducer import Reducer
from pytorch_distributed_example_tpu_torch.utils.flight_recorder import global_recorder
from tests import _ddp_cases as cases
from tests._mp_util import REPO
from tests._torch_gang import gang_env, gang_port

W = 8
STEPS = 5
LOSS_TOL = dict(rtol=1e-5, atol=0)
PARAM_TOL = dict(rtol=1e-4, atol=1e-6)
GANG_TIMEOUT_S = 120


@pytest.fixture
def port8():
    pg = tdx.init_process_group(world_size=W, device="cpu")
    yield pg
    tdx.destroy_process_group()


@pytest.fixture(scope="module")
def flax_params():
    return JConvNet().init(jax.random.PRNGKey(0), jnp.zeros((1, 28, 28, 1)))


@pytest.fixture(scope="module")
def reference(world, flax_params):
    """The reference's 5 steps at world 8, per `shard_weight_update`."""
    x, y = cases.global_batch(W)
    opt = optax.sgd(0.01, momentum=0.5)

    def loss_fn(logits, yy):
        return optax.softmax_cross_entropy_with_integer_labels(logits, yy).mean()

    out = {}
    for mode in ("auto", "off"):
        ddp = jtdx.DistributedDataParallel(JConvNet(), flax_params)
        step = ddp.make_train_step(opt, loss_fn, shard_weight_update=mode)
        p, s, losses = ddp.params, opt.init(ddp.params), []
        for _ in range(STEPS):
            p, s, loss = step(p, s, x, y)
            losses.append(float(loss))
        out[mode] = (losses, convnet_from_flax(jax.device_get(p)))
    return out


def _converted(flax_params):
    return {n: t for n, t in convnet_from_flax(flax_params).items()}


@pytest.mark.parametrize("mode", ["auto", "off"])
def test_driver_mode_matches_reference(port8, reference, flax_params, mode):
    losses, params = cases.run(tdx, STEPS, mode, has_rng=False, params=_converted(flax_params))
    want_losses, want_params = reference[mode]
    np.testing.assert_allclose(losses, want_losses, **LOSS_TOL)
    assert sorted(params) == sorted(want_params)
    for n, p in params.items():
        np.testing.assert_allclose(p, want_params[n].numpy(), **PARAM_TOL, err_msg=n)


def test_zero_auto_matches_off_bitwise(port8):
    """The reference's bitwise contract: the sharded update's params and
    losses are the replicated update's, bit for bit (dropout on)."""
    auto = cases.run(tdx, STEPS, "auto")
    off = cases.run(tdx, STEPS, "off")
    assert auto[0] == off[0]
    for n in auto[1]:
        np.testing.assert_array_equal(auto[1][n], off[1][n], err_msg=n)


def test_step_carries_the_references_bitwise_contract():
    from pytorch_distributed_example_tpu import numerics as jnumerics
    from pytorch_distributed_example_tpu.parallel.ddp import make_ddp_train_step as jstep
    from pytorch_distributed_example_tpu_torch import numerics

    assert numerics.contract_of(make_ddp_train_step)["tier"] == "bitwise"
    assert jnumerics.contract_of(jstep)["tier"] == "bitwise"
    assert "pytorch_distributed_example_tpu_torch.parallel.ddp:make_ddp_train_step" in (
        numerics.registered_contracts())
    with pytest.raises(ValueError, match="tier"):
        numerics.numerics_contract("exact")
    with pytest.raises(ValueError, match="tolerance"):
        numerics.numerics_contract("bitwise", rtol=1e-5)


def _setup(group, shard="auto", **kw):
    model = ConvNet(device="cpu", generator=torch.Generator().manual_seed(0))
    ddp = tdx.DistributedDataParallel(model)
    opt = optim.sgd(0.01, momentum=0.5)
    step = ddp.make_train_step(opt, F.cross_entropy, has_rng=True, shard_weight_update=shard,
                               **kw)
    x, y = cases.global_batch(W)
    x = torch.from_numpy(x.transpose(0, 3, 1, 2).copy())
    return ddp, opt, step, x, torch.from_numpy(y).long()


def test_steps_per_call_matches_sequential_bitwise(port8):
    K = 3
    ddp, opt, step, x, y = _setup(port8)
    p, s, seq = ddp.params, opt.init(ddp.params), []
    for i in range(K):
        p, s, loss = step(p, s, x + i, y, 10 + i)
        seq.append(loss)
    _, _, stepk, _, _ = _setup(port8, steps_per_call=K, unroll_steps=True)
    xs = torch.stack([x + i for i in range(K)])
    pk, sk, losses = stepk(ddp.params, opt.init(ddp.params), xs, y.expand(K, -1),
                           [10 + i for i in range(K)])
    assert torch.equal(losses, torch.stack(seq))
    for n in p:
        assert torch.equal(p[n], pk[n]), n
        assert torch.equal(s[n], sk[n]), n


def test_opt_state_shard_round_trip_is_exact(port8):
    ddp, opt, step, x, y = _setup(port8)
    assert step.weight_update_sharded
    state = {n: torch.randn(p.shape, generator=torch.Generator().manual_seed(i))
             for i, (n, p) in enumerate(ddp.params.items())}
    sharded = step.shard_opt_state(ddp.params, state)
    # (W, k) rows: rank r's shard of the padded leaf; conv1's 250 -> 8 x 32
    assert tuple(sharded["conv1.weight"].shape) == (W, 32)
    back = step.unshard_opt_state(ddp.params, sharded)
    for n in state:
        assert torch.equal(back[n], state[n]), n
    assert step.shard_opt_state(ddp.params, sharded) is sharded
    zeros = step.init_opt_state(ddp.params)
    assert all(torch.equal(zeros[n], torch.zeros_like(sharded[n])) for n in state)
    with pytest.raises(ValueError, match="neither"):
        step.shard_opt_state(ddp.params, {n: torch.zeros(3) for n in state})


def test_shard_layout_functions_match_reference():
    """The layout algebra on one tree: the padded flat leaves, each rank's
    shard and the way back, against the reference's functions."""
    from pytorch_distributed_example_tpu.parallel import zero as jzero

    rng = np.random.default_rng(0)
    tree = {"conv1.weight": rng.standard_normal((10, 1, 5, 5)).astype(np.float32),
            "fc2.bias": rng.standard_normal((10,)).astype(np.float32),
            "count": np.array(3, np.int32)}
    port = {n: torch.from_numpy(a) for n, a in tree.items()}
    got = zero.to_shard_layout(port, W)
    want = jzero.to_shard_layout({n: jnp.asarray(a) for n, a in tree.items()}, W)
    for n in tree:
        np.testing.assert_array_equal(got[n].numpy(), np.asarray(want[n]), err_msg=n)
    assert got["conv1.weight"].shape == (256,)  # 250 -> W * ceil(250 / W)
    for r in range(W):
        np.testing.assert_array_equal(zero.shard_of(port["fc2.bias"], r, W).numpy(),
                                      np.asarray(jzero.shard_of(jnp.asarray(tree["fc2.bias"]), r, W)))
    back = zero.from_shard_layout(got, port)
    assert all(torch.equal(back[n], port[n]) for n in tree)


def test_profiler_trace_writes_a_trace(port8, tmp_path):
    ddp, opt, step, x, y = _setup(port8)
    with ddp.logger.profiler_trace(str(tmp_path)):
        step(ddp.params, opt.init(ddp.params), x, y, 0)
    assert list(tmp_path.glob("*.pt.trace.json"))


def test_init_opt_state_and_plain_state_train_alike(port8):
    ddp, opt, step, x, y = _setup(port8)
    a = step(ddp.params, step.init_opt_state(ddp.params), x, y, 0)
    b = step(ddp.params, opt.init(ddp.params), x, y, 0)
    assert torch.equal(a[2], b[2])
    assert all(torch.equal(a[0][n], b[0][n]) for n in a[0])


def _ops_of_one_step(pg, step, ddp, opt, x, y):
    start, t0 = pg.status.last_enqueued_seq, time.time()
    step(ddp.params, opt.init(ddp.params), x, y, 0)
    entries = [e for e in global_recorder().entries()
               if e.group == pg.group_name and e.seq > start and e.time_created >= t0]
    return [(e.op, e.shape) for e in sorted(entries, key=lambda e: e.seq)]


def test_step_reduces_through_the_c10d_core(port8):
    """The flight recorder sees each step's collectives, in order, with the
    shapes of the flat shard buffer (K = 2734 columns for the ConvNet at
    world 8): under ZeRO the loss's all_reduce, the gradients'
    reduce_scatter and the params' all_gather; replicated, two
    all_reduces."""
    ddp, opt, step, x, y = _setup(port8)
    K = zero.ShardLayout([p.shape for p in ddp.params.values()], W).size
    assert K == 2734
    assert _ops_of_one_step(port8, step, ddp, opt, x, y) == [
        ("all_reduce", (W,)), ("reduce_scatter", (W, W, K)), ("all_gather", (W, K))]
    ddp, opt, step, x, y = _setup(port8, shard="off")
    assert _ops_of_one_step(port8, step, ddp, opt, x, y) == [
        ("all_reduce", (W,)), ("all_reduce", (W, W * K))]


def test_noop_hook_under_zero_takes_each_ranks_own_chunk(port8):
    """A hook other than the default keeps its reduction and each rank
    takes its shard of the output: the no-op hook at world 8 updates rank
    r's shard with rank r's own unreduced gradients."""
    ddp, opt, step, x, y = _setup(port8)
    ddp.register_comm_hook(None, comm_hooks.noop_hook)
    noop = ddp.make_train_step(opt, F.cross_entropy)
    p, _, _ = noop(ddp.params, opt.init(ddp.params), x, y)
    # by hand: each rank's own gradients, its own shard
    xs, ys = x.reshape(W, -1, 1, 28, 28), y.reshape(W, -1)
    grads = torch.func.vmap(torch.func.grad(
        lambda q, a, b: F.cross_entropy(torch.func.functional_call(ddp.module, q, (a,)), b)),
        in_dims=(None, 0, 0))(ddp.params, xs, ys)
    for n, q in ddp.params.items():
        mine = torch.stack([zero.shard_of(grads[n][r], r, W) for r in range(W)]).reshape(-1)
        want = zero.padded_flat(q, W) + mine * -0.01
        np.testing.assert_array_equal(p[n].reshape(-1).numpy(), want[:q.numel()].numpy(),
                                      err_msg=n)


def test_sync_module_states_multi_bucket(port8):
    rng = np.random.default_rng(0)
    params = {
        "a": torch.from_numpy(rng.standard_normal((64, 64)).astype(np.float32)),
        "b": torch.from_numpy(rng.standard_normal((1024,)).astype(np.float32)),
        "c": torch.from_numpy(rng.integers(0, 100, (17,)).astype(np.int32)),
        "d": torch.tensor(3.5),  # a scalar
    }
    start = port8.status.last_enqueued_seq
    out = _sync_module_states(params, port8, bucket_mb=0.008)  # 8 KB: several buckets
    assert port8.status.last_enqueued_seq - start >= 4
    for k in params:
        assert out[k].dtype == params[k].dtype and torch.equal(out[k], params[k]), k


def test_verify_params_across_ranks_names_the_param(port8, monkeypatch):
    """Consistent params verify clean. Driver mode cannot hold diverging
    ranks, so rank 5's hash row is corrupted at position 2: the error must
    name that param (the gang test makes a real mismatch)."""
    names = ["conv1.weight", "conv1.bias", "fc1.weight"]
    leaves = [torch.zeros(10, 1, 5, 5), torch.zeros(10), torch.zeros(50, 320)]
    _verify_params_across_ranks(names, leaves, port8)
    real = tdx.DistTensor.from_process_local

    def diverging(value, group=None):
        t = real(value, group)
        if t.tensor.shape[1] == len(names):
            t.tensor[5, 2] += 1
        return t

    monkeypatch.setattr(tdx.DistTensor, "from_process_local", diverging)
    with pytest.raises(RuntimeError, match=r"parameter fc1.weight \(index 2\)"):
        _verify_params_across_ranks(names, leaves, port8)


def test_no_sync_skips_the_reducers_collective(port8):
    ddp, _, _, _, _ = _setup(port8)
    grads = {"w": torch.stack([torch.full((3,), float(r)) for r in range(W)])}
    start = port8.status.last_enqueued_seq
    with ddp.no_sync():
        out = ddp.reduce_gradients(grads)
        assert out["w"] is grads["w"]
    assert port8.status.last_enqueued_seq == start
    out = ddp.reduce_gradients(grads)
    assert port8.status.last_enqueued_seq == start + 1  # one bucket
    np.testing.assert_array_equal(out["w"].numpy(), np.full((W, 3), 3.5, np.float32))


def test_reducer_matches_reference(port8, world):
    shapes = [(10, 1, 5, 5), (10,), (20, 10, 5, 5), (20,), (50, 320), (50,), (10, 50), (10,),
              (300, 300)]
    rng = np.random.default_rng(0)
    leaves = [rng.standard_normal((W,) + s).astype(np.float32) for s in shapes]
    want = JReducer(process_group=world, bucket_cap_mb=0.05, first_bucket_bytes=20000)
    got = Reducer(process_group=port8, bucket_cap_mb=0.05, first_bucket_bytes=20000)
    plan = got.build_buckets([torch.from_numpy(l) for l in leaves])
    assert plan == want.build_buckets(leaves) and len(plan) > 2
    assert got.stats["bucket_sizes"] == want.stats["bucket_sizes"]
    out = got.reduce([torch.from_numpy(l) for l in leaves])
    ref = want.reduce([jnp.asarray(l) for l in leaves])
    for o, r in zip(out, ref):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), rtol=1e-6, atol=1e-7)


def test_eval_step_matches_reference(port8, world, flax_params):
    x, y = cases.global_batch(W)
    w = (np.arange(len(y)) < len(y) - 5).astype(np.float32)  # 5 padding samples

    def jmetric(logits, yy, ww):
        ce = optax.softmax_cross_entropy_with_integer_labels(logits, yy)
        correct = (jnp.argmax(logits, -1) == yy).astype(jnp.float32)
        return jnp.stack([(ce * ww).sum(), (correct * ww).sum(), ww.sum()])

    jddp = jtdx.DistributedDataParallel(JConvNet(), flax_params)
    want = np.asarray(jddp.make_eval_step(jmetric)(jddp.params, x, y, w))
    model = ConvNet(device="cpu")
    ddp = tdx.DistributedDataParallel(model, _converted(flax_params))
    got = ddp.make_eval_step(mnist.metric_fn)(
        ddp.params, torch.from_numpy(x.transpose(0, 3, 1, 2).copy()),
        torch.from_numpy(y).long(), torch.from_numpy(w))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
    assert got[2] == len(y) - 5


OPTIONS = [dict(grad_accum_steps=2), dict(remat=True), dict(find_unused_parameters=True),
           dict(with_aux=True)]


def _jax_option_run(flax_params, option, x, y, steps=3):
    """The reference's `make_ddp_train_step` with `option` at world 2:
    (losses, auxes, unused names, params of the ConvNet)."""
    from pytorch_distributed_example_tpu.parallel.ddp import make_ddp_train_step as jstep

    g = jtdx.new_group(ranks=[0, 1])
    net = JConvNet()
    params = {"params": jax.tree_util.tree_map(jnp.array, flax_params["params"]),  # donated
              "extra": jnp.zeros((3,), jnp.float32)}

    def apply(p, xx):
        return net.apply({"params": p["params"]}, xx)

    def loss_fn(logits, yy):
        loss = optax.softmax_cross_entropy_with_integer_labels(logits, yy).mean()
        return (loss, logits.mean()) if option.get("with_aux") else loss

    unused = []
    opt = optax.sgd(0.01, momentum=0.5)
    step = jstep(apply, loss_fn, opt, group=g, on_unused=unused.extend,
                 **{**option, "find_unused_parameters": True})
    p, s, losses, auxes = params, opt.init(params), [], []
    for _ in range(steps):
        out = step(p, s, jnp.asarray(x), jnp.asarray(y))
        p, s, loss = out[:3]
        losses.append(float(loss))
        if option.get("with_aux"):
            auxes.append(float(out[3]))
    return losses, auxes, unused, convnet_from_flax(jax.device_get(p["params"]))


@pytest.mark.parametrize("option", OPTIONS)
def test_options_not_ported_raise(world, flax_params, option):
    """(These options raised NotImplementedError before the port took them;
    the name is kept.) Each option of the DDP step against the reference's
    at world 2, dropout off, 3 steps of SGD with momentum 0.5 on ZeRO
    "auto": gradient accumulation over 2 microbatches, remat, unused
    parameters reported through `on_unused` (the params carry an unused
    "extra" leaf), and `with_aux` (the mean logit; the reference returns
    rank 0's, the port every rank's). Losses and aux within rtol 1e-5,
    params within rtol 1e-4, atol 1e-6 (float32 in both)."""
    x, y = cases.global_batch(2)
    want_losses, want_aux, want_unused, want = _jax_option_run(flax_params, option, x, y)
    pg = tdx.init_process_group(world_size=2, device="cpu")
    try:
        model = ConvNet(device="cpu")
        params = {**_converted(flax_params), "extra": torch.zeros(3)}

        def apply(p, xx):
            return torch.func.functional_call(
                model, {n: t for n, t in p.items() if n != "extra"}, (xx,))

        def loss_fn(logits, yy):
            loss = F.cross_entropy(logits, yy)
            return (loss, logits.mean()) if option.get("with_aux") else loss

        unused = []
        opt = optim.sgd(0.01, momentum=0.5)
        step = make_ddp_train_step(apply, loss_fn, opt, on_unused=unused.extend, **option)
        p, s, losses, auxes = params, opt.init(params), [], []
        xt = torch.from_numpy(x.transpose(0, 3, 1, 2).copy())
        yt = torch.from_numpy(y).long()
        if not option.get("find_unused_parameters"):
            with pytest.raises(RuntimeError, match="never used"):
                step(p, s, xt, yt)
            option = {**option, "find_unused_parameters": True}
            step = make_ddp_train_step(apply, loss_fn, opt, on_unused=unused.extend, **option)
        for _ in range(3):
            out = step(p, s, xt, yt)
            p, s, loss = out[:3]
            losses.append(float(loss))
            if option.get("with_aux"):
                assert out[3].shape == (2,)  # every local rank's
                auxes.append(float(out[3][0]))
    finally:
        tdx.destroy_process_group()
    np.testing.assert_allclose(losses, want_losses, **LOSS_TOL)
    np.testing.assert_allclose(auxes, want_aux, **LOSS_TOL)
    assert unused == ["extra"] and want_unused == ["['extra']"]
    assert torch.equal(p["extra"], torch.zeros(3))
    for n, w in want.items():
        np.testing.assert_allclose(p[n].numpy(), w.numpy(), **PARAM_TOL, err_msg=n)


def test_stateful_hooks_and_bad_flags_raise(port8):
    """A stateful hook's state is per rank: `init_hook_state` stacks one
    rank's state W times, and each rank's error feedback then grows from
    its own gradients; `steps_per_call` carries it bit for bit as
    sequential calls do. The flags the reference refuses still raise."""
    hook = comm_hooks.blockwise_quant_hook(error_feedback=True)
    ddp, opt, _, x, y = _setup(port8)
    ddp.register_comm_hook(None, hook)
    step = ddp.make_train_step(opt, F.cross_entropy, has_rng=True)
    hs = step.init_hook_state(ddp.params)
    assert [tuple(e.shape) for e in hs["error"]] == [(W,) + tuple(p.shape)
                                                     for p in ddp.params.values()]
    p, s, hs1, loss = step(ddp.params, opt.init(ddp.params), hs, x, y, 0)
    big = max(hs1["error"], key=lambda e: e[0].numel())
    assert big.abs().sum() > 0 and not torch.equal(big[0], big[1])
    p2, s2, hs2, _ = step(p, s, hs1, x, y, 1)
    stepk = ddp.make_train_step(opt, F.cross_entropy, has_rng=True, steps_per_call=2,
                                unroll_steps=True)
    pk, sk, hsk, losses = stepk(ddp.params, opt.init(ddp.params), hs, torch.stack([x, x]),
                                torch.stack([y, y]), [0, 1])
    assert torch.equal(losses[0], loss)
    for a, b in zip(pytree.tree_leaves((p2, hs2)), pytree.tree_leaves((pk, hsk))):
        assert torch.equal(a, b)

    with pytest.raises(ValueError, match="shard_weight_update"):
        make_ddp_train_step(lambda p, x: x, F.cross_entropy, optim.sgd(0.1),
                            shard_weight_update="on")
    with pytest.raises(ValueError, match="grad_accum_steps"):
        make_ddp_train_step(lambda p, x: x, F.cross_entropy, optim.sgd(0.1), grad_accum_steps=0)
    with pytest.raises(NotImplementedError, match="aux"):
        make_ddp_train_step(lambda p, x: x, F.cross_entropy, optim.sgd(0.1), with_aux=True,
                            steps_per_call=2)


def test_memory_report_and_logging_data(port8):
    ddp, opt, step, x, y = _setup(port8)
    ddp.logger.enable_step_timing()
    p, s, _ = step(ddp.params, opt.init(ddp.params), x, y, 0)
    rep = step.memory_report(p, s)
    assert rep["param_bytes"] == 21840 * 4
    assert rep["opt_state_bytes_per_device"] == 2734 * 4  # one rank's shards
    assert rep["opt_state_reduction_x"] == 8.0
    off = _setup(port8, shard="off")
    rep = off[2].memory_report(off[0].params, off[1].init(off[0].params))
    assert rep["opt_state_reduction_x"] == 1.0 and rep["opt_state_bytes"] == 21840 * 4
    data = ddp.get_ddp_logging_data()
    assert (data["world_size"], data["rank"], data["num_steps"]) == (W, 0, 1)
    assert data["avg_step_time_s"] > 0 and not data["find_unused_parameters"]
    assert ddp.state_dict()["fc2.bias"].device.type == "cpu"


BENCH_SMALL = dict(batch_per_rank=4, warmup=2, steps=4, windows=2)


def _assert_rate_per_device(out, ranks_on_device):
    """Each window's rate is the samples of the ranks on this process's one
    device over the window's seconds."""
    assert out["ranks_on_device"] == ranks_on_device
    samples = out["steps"] * out["batch_per_rank"] * ranks_on_device
    np.testing.assert_allclose(np.multiply(out["windows"], out["window_s"]), samples, rtol=1e-12)


def test_bench_runs_on_a_cpu_group():
    tdx.init_process_group(world_size=2, device="cpu")
    try:
        out = bench_ddp_mnist(**BENCH_SMALL, steps_per_call=2)
    finally:
        tdx.destroy_process_group()
    assert out["steps_per_call"] == 2 and out["weight_update_sharded"]
    assert len(out["windows"]) == 2 and np.isfinite(out["final_loss"])
    assert out["memory"]["opt_state_reduction_x"] == 2.0 and out["device"] == "cpu"
    _assert_rate_per_device(out, 2)  # driver mode: both ranks on the one device


def test_example_trains_on_the_cpu_at_world_2():
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        trainer = mnist.main(["--cpu", "--epochs", "1"])
    out = buf.getvalue()
    assert "world_size=2" in out and "Epoch: 1/1, train loss:" in out and "test acc:" in out
    losses = trainer.losses
    assert len(losses) == 4096 // (2 * 64)
    assert np.mean(losses[-5:]) < 0.5 * np.mean(losses[:5])
    assert not tdx.is_initialized()


def test_example_needs_a_card_without_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mnist.main(["--epochs", "1"])


GANG_WORKER = textwrap.dedent(
    """
    import contextlib, io, pickle, sys
    rank, world, port, port2, out = (int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]),
                                     int(sys.argv[4]), sys.argv[5])
    import torch
    import pytorch_distributed_example_tpu_torch as tdx
    from pytorch_distributed_example_tpu_torch.bench import bench_ddp_mnist
    from pytorch_distributed_example_tpu_torch.examples import mnist
    from pytorch_distributed_example_tpu_torch.models import ConvNet
    from tests import _ddp_cases as cases

    tdx.init_process_group(backend="gloo", init_method=f"tcp://127.0.0.1:{port}",
                           rank=rank, world_size=world, device="cpu", timeout=60)
    res = {"run": cases.run(tdx, 3, "auto")}
    res["bench"] = bench_ddp_mnist(batch_per_rank=4, warmup=2, steps=4, windows=2)
    # a param of another shape on rank 1: both ranks must name it
    params = dict(ConvNet(device="cpu").named_parameters())
    if rank == 1:
        params["fc2.bias"] = torch.zeros(11)
    try:
        tdx.DistributedDataParallel(ConvNet(device="cpu"), params)
    except RuntimeError as e:
        res["verify"] = str(e)
    tdx.destroy_process_group()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        trainer = mnist.main(["--cpu", "--init-method", f"tcp://127.0.0.1:{port2}",
                              "--rank", str(rank), "--world-size", str(world), "--epochs", "1"])
    res["example"] = (buf.getvalue(), trainer.losses)
    with open(out, "wb") as f:
        pickle.dump(res, f)
    """
)


@pytest.fixture(scope="module")
def gang(tmp_path_factory):
    """A 2-process gloo gang's results, by rank."""
    tmp = tmp_path_factory.mktemp("ddp_gang")
    script = tmp / "worker.py"
    script.write_text(GANG_WORKER)
    ports = [gang_port(), gang_port()]
    procs = [subprocess.Popen([sys.executable, str(script), str(r), "2", str(ports[0]),
                               str(ports[1]), str(tmp / f"rank{r}.pkl")],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=gang_env(),
                              cwd=REPO)
             for r in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=GANG_TIMEOUT_S)[0].decode())
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} failed:\n{out}"
    results = []
    for r in range(2):
        with open(tmp / f"rank{r}.pkl", "rb") as f:
            results.append(pickle.load(f))
    return results


def test_gang_matches_driver_mode_at_world_2(gang):
    """Multiproc at world 2 against driver mode at world 2, ZeRO auto,
    dropout on (rank r draws the same masks in both modes). The forward is
    the same arithmetic, so the first loss is equal; the gradients of
    `vmap` over two ranks and over one sum the convolutions' weight
    gradients in another order, so later steps are held to the float32
    tolerance above."""
    tdx.init_process_group(world_size=2, device="cpu")
    try:
        want_losses, want_params = cases.run(tdx, 3, "auto")
    finally:
        tdx.destroy_process_group()
    for rank, res in enumerate(gang):
        losses, params = res["run"]
        assert losses[0] == want_losses[0], rank
        np.testing.assert_allclose(losses, want_losses, **LOSS_TOL)
        for n, p in params.items():
            np.testing.assert_allclose(p, want_params[n], **PARAM_TOL, err_msg=f"{rank} {n}")
    for n in gang[0]["run"][1]:  # the replicas agree exactly
        np.testing.assert_array_equal(gang[0]["run"][1][n], gang[1]["run"][1][n])


def test_gang_verify_names_the_mismatching_param(gang):
    for res in gang:
        assert "parameter fc2.bias (index 7) differs across ranks" in res["verify"]


def test_gang_bench_rate_is_per_rank(gang):
    """Multiproc mode: one rank a device, so the rate a device is that
    rank's own samples over the window's seconds."""
    for res in gang:
        out = res["bench"]
        assert out["weight_update_sharded"] and np.isfinite(out["final_loss"])
        _assert_rate_per_device(out, 1)


def test_gang_runs_the_example(gang):
    for rank, res in enumerate(gang):
        out, losses = res["example"]
        assert "world_size=2" in out and "Epoch: 1/1, train loss:" in out, out
        assert len(losses) == 4096 // (2 * 64)
        assert np.mean(losses[-5:]) < 0.5 * np.mean(losses[:5])
    assert gang[0]["example"][1] == gang[1]["example"][1]  # the mean loss, every rank
