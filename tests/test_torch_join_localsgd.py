"""The port's Join (`parallel/join.py`) and post-local SGD
(`parallel/localsgd.py`, `optim.PostLocalSGDOptimizer`) against the
reference's.

Join mirrors `TestJoin` of the reference's `tests/test_join_checkpoint.py`:
`join_batches` pads and masks (its streams equal the reference's array for
array), the `Join` context runs the post-hooks and refuses no joinables,
and a zero-weight shadow half-batch leaves the DDP step's params within the
reference's rtol 2e-4 / atol 2e-5 of the step without it. The weighted
loss's divisor is a sum over the ranks inside the step's rank `vmap`
(`nn.functional.rank_all_reduce`, the reference's `psum`); the port's
shadow step is held to the reference's on the same converted ConvNet
params within the same tolerance.

Local SGD runs an MLP at world 8, 8 steps of sgd at period 4 and warmup 2,
the port's `PostLocalSGDOptimizer` against the reference's `shard_map`
form: per-replica losses and params within rtol 1e-5 (params with atol
1e-5 of the leaf's largest entry: a bias's small entries are cancelling
sums, which XLA and torch add in other orders); the replicas are
bitwise equal right after each averaging and differ between averagings.
`HierarchicalModelAverager` takes a {2: 2, 4: 8} table at world 8 against
the reference's, step by step.
"""

import time

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F

import pytorch_distributed_example_tpu as jtdx
import pytorch_distributed_example_tpu_torch as tdx
from pytorch_distributed_example_tpu.models import ConvNet as JConvNet
from pytorch_distributed_example_tpu.parallel import join as jjoin
from pytorch_distributed_example_tpu.parallel import localsgd as jlocal
from pytorch_distributed_example_tpu import optim as joptim
from pytorch_distributed_example_tpu_torch import optim
from pytorch_distributed_example_tpu_torch.models import ConvNet, convnet_from_flax
from pytorch_distributed_example_tpu_torch.parallel import localsgd
from pytorch_distributed_example_tpu_torch.parallel.join import (
    Join,
    Joinable,
    JoinHook,
    join_batches,
    weighted_loss_fn,
)

W = 8
JOIN_TOL = dict(rtol=2e-4, atol=2e-5)
LOCAL_TOL = dict(rtol=1e-5, atol=0)


@pytest.fixture
def port8():
    pg = tdx.init_process_group(world_size=W, device="cpu")
    yield pg
    tdx.destroy_process_group()


class TestJoin:
    def test_join_batches_pads_and_masks_as_the_reference(self):
        def mk(n, tag):
            return [(np.full((2, 3), 10 * tag + i, np.float32), np.full((2,), tag, np.int32))
                    for i in range(n)]

        streams = [mk(3, 0), mk(1, 1), mk(2, 2)]
        steps = list(join_batches(streams))
        want = list(jjoin.join_batches(streams))
        assert len(steps) == len(want) == 3
        for got, ref in zip(steps, want):
            for a, b in zip(got, ref):
                assert a.dtype == b.dtype and np.array_equal(a, b)
        x, _, w = steps[2]
        assert x.shape == (6, 3) and w.tolist() == [1, 1, 0, 0, 0, 0]
        with pytest.raises(ValueError):
            list(join_batches([mk(1, 0), []]))

    def test_join_context_api(self):
        class J(Joinable):
            def __init__(self):
                self.post = []

            def join_hook(self, **kw):
                outer = self

                class H(JoinHook):
                    def post_hook(self, is_last_joiner):
                        outer.post.append(is_last_joiner)

                return H()

        j = J()
        with Join([j]):
            Join.notify_join_context(j)
        assert j.post == [True]
        with pytest.raises(ValueError):
            Join([])

    def test_local_weighted_loss_is_the_references(self):
        gen = np.random.default_rng(0)
        logits = gen.standard_normal((6, 10)).astype(np.float32)
        y = gen.integers(0, 10, 6).astype(np.int32)
        w = np.array([1, 1, 1, 0, 0, 1], np.float32)
        got = weighted_loss_fn(lambda lg, yy: F.cross_entropy(lg, yy, reduction="none"))(
            torch.from_numpy(logits), torch.from_numpy(y).long(), torch.from_numpy(w))
        want = jjoin.weighted_loss_fn(optax.softmax_cross_entropy_with_integer_labels)(
            jnp.asarray(logits), jnp.asarray(y), jnp.asarray(w))
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6)

    def test_weighted_training_ignores_shadow(self, world, port8):
        """A zero-weight shadow half-batch changes no gradient: the port's
        step with and without it, and the reference's with it."""
        flax_params = JConvNet().init(jax.random.PRNGKey(0), jnp.zeros((1, 28, 28, 1)))
        from pytorch_distributed_example_tpu.data import SyntheticMNIST

        x, y = SyntheticMNIST(256)[np.arange(64)]
        w_full = np.ones((64,), np.float32)
        x2, y2 = np.concatenate([x, x]), np.concatenate([y, y])
        w2 = np.concatenate([w_full, np.zeros_like(w_full)])

        # the reference's shadow step (tests/test_join_checkpoint.py:53)
        jddp = jtdx.DistributedDataParallel(JConvNet(), flax_params)
        jopt = optax.sgd(0.1)

        def jwloss(logits, yw):
            yy, ww = yw
            ce = optax.softmax_cross_entropy_with_integer_labels(logits, yy)
            return (ce * ww).sum() / jnp.maximum(jax.lax.psum(ww.sum(), "_ranks"), 1.0) * W

        jstep = jddp.make_train_step(jopt, jwloss)
        jp, _, _ = jstep(jddp.params, jopt.init(jddp.params), x2, (y2, w2))
        want = convnet_from_flax(jax.device_get(jp))

        wl = weighted_loss_fn(lambda lg, yy: F.cross_entropy(lg, yy, reduction="none"), world=W)

        def run(xx, yy, ww):
            model = ConvNet(device="cpu")
            ddp = tdx.DistributedDataParallel(model, convnet_from_flax(flax_params))
            opt = optim.sgd(0.1)
            step = ddp.make_train_step(opt, lambda lg, yw: wl(lg, yw[0], yw[1]),
                                       shard_weight_update="off")
            xt = torch.from_numpy(xx.transpose(0, 3, 1, 2).copy())
            p, _, _ = step(ddp.params, opt.init(ddp.params), xt,
                           (torch.from_numpy(yy).long(), torch.from_numpy(ww)))
            return p

        p1, p2 = run(x, y, w_full), run(x2, y2, w2)
        for n in p1:
            np.testing.assert_allclose(p1[n].numpy(), p2[n].numpy(), **JOIN_TOL, err_msg=n)
            np.testing.assert_allclose(p2[n].numpy(), want[n].numpy(), **JOIN_TOL, err_msg=n)


# ---------------------------------------------------------------------------
# local SGD
# ---------------------------------------------------------------------------

D_IN, D_H, N_OUT, BATCH = 6, 16, 4, 8  # BATCH a rank


def _mlp_params(seed=0):
    gen = np.random.default_rng(seed)
    return {"w1": (gen.standard_normal((D_IN, D_H)) * 0.5).astype(np.float32),
            "b1": np.zeros(D_H, np.float32),
            "w2": (gen.standard_normal((D_H, N_OUT)) * 0.5).astype(np.float32),
            "b2": np.zeros(N_OUT, np.float32)}


def _data(steps, seed=1):
    gen = np.random.default_rng(seed)
    xs = gen.standard_normal((steps, W * BATCH, D_IN)).astype(np.float32)
    ys = gen.integers(0, N_OUT, (steps, W * BATCH)).astype(np.int32)
    return xs, ys


def _port_apply(p, x):
    return torch.tanh(x @ p["w1"] + p["b1"]) @ p["w2"] + p["b2"]


def _jax_apply(p, x):
    return jnp.tanh(x @ p["w1"] + p["b1"]) @ p["w2"] + p["b2"]


def _jax_loss(logits, y):
    return optax.softmax_cross_entropy_with_integer_labels(logits, y).mean()


@pytest.mark.parametrize("steps,period,warmup", [(8, 4, 2)])
def test_post_local_sgd_matches_the_reference(world, port8, steps, period, warmup):
    xs, ys = _data(steps)
    jopt = joptim.PostLocalSGDOptimizer(optax.sgd(0.1), _jax_apply, _jax_loss, period=period,
                                        warmup_steps=warmup)
    jp, jo = jopt.init({k: jnp.asarray(v) for k, v in _mlp_params().items()})
    opt = optim.PostLocalSGDOptimizer(optim.sgd(0.1), _port_apply, F.cross_entropy,
                                      period=period, warmup_steps=warmup)
    p, o = opt.init({k: torch.from_numpy(v) for k, v in _mlp_params().items()})
    assert p["w1"].shape == (W, D_IN, D_H)
    for i in range(steps):
        jp, jo, jloss = jopt.step(jp, jo, jnp.asarray(xs[i]), jnp.asarray(ys[i]))
        p, o, loss = opt.step(p, o, torch.from_numpy(xs[i]), torch.from_numpy(ys[i]).long())
        np.testing.assert_allclose(loss.numpy(), np.asarray(jloss), **LOCAL_TOL)
        for k in p:
            want = np.asarray(jp[k])
            np.testing.assert_allclose(p[k].numpy(), want, rtol=LOCAL_TOL["rtol"],
                                       atol=LOCAL_TOL["rtol"] * np.abs(want).max(), err_msg=k)
        averaged = (i + 1) > warmup and (i + 1) % period == 0
        for k in p:
            rows = p[k].numpy()
            same = all(rows[r].tobytes() == rows[0].tobytes() for r in range(W))
            assert same == averaged, (i, k)


def test_localsgd_step_is_collective_free_and_takes_rng(port8):
    """The local step makes no collective; with `has_rng` each replica
    draws its own stream, seeded as the DDP step's."""
    from pytorch_distributed_example_tpu_torch.utils.flight_recorder import global_recorder

    def apply(p, x, mask):
        return _port_apply(p, x * mask)

    step = localsgd.make_localsgd_train_step(
        apply, F.cross_entropy, optim.sgd(0.1), has_rng=True,
        rng_fn=lambda gen, b: (torch.rand((b, D_IN), generator=gen) > 0.5).float())
    stacked = localsgd.stack_replicas({k: torch.from_numpy(v)
                                       for k, v in _mlp_params().items()}, W)
    state = localsgd.init_stacked_opt_state(optim.sgd(0.1), stacked)
    xs, ys = _data(1)
    t0 = time.time()
    new, _, losses = step(stacked, state, torch.from_numpy(xs[0]),
                          torch.from_numpy(ys[0]).long(), 3)
    assert not [e for e in global_recorder().entries()
                if e.group == port8.group_name and e.time_created >= t0]
    again, _, losses2 = step(stacked, state, torch.from_numpy(xs[0]),
                             torch.from_numpy(ys[0]).long(), 3)
    assert losses.shape == (W,) and torch.equal(losses, losses2)
    assert not torch.equal(new["w1"][0], new["w1"][1])
    one = localsgd.unstack_replicas(new, 2)
    assert one["w1"].shape == (D_IN, D_H)


def test_hierarchical_averager_matches_the_reference(world, port8):
    gen = np.random.default_rng(3)
    stacked = {"a": gen.standard_normal((W, 5)).astype(np.float32),
               "b": gen.standard_normal((W, 2, 3)).astype(np.float32)}
    table = {2: 2, 4: 8}
    javg = jlocal.HierarchicalModelAverager(table, warmup_steps=1)
    avg = localsgd.HierarchicalModelAverager(table, warmup_steps=1)
    jp = {k: jnp.asarray(v) for k, v in stacked.items()}
    p = {k: torch.from_numpy(v) for k, v in stacked.items()}
    sizes = []
    for _ in range(8):
        jp = {k: v + 1.0 for k, v in jp.items()}
        p = {k: v + 1.0 for k, v in p.items()}
        jp, jsize = javg.average_parameters(jp)
        p, size = avg.average_parameters(p)
        assert size == jsize
        sizes.append(size)
        for k in p:
            np.testing.assert_allclose(p[k].numpy(), np.asarray(jp[k]), **LOCAL_TOL, err_msg=k)
    assert sizes == [0, 2, 0, 8, 0, 2, 0, 8]
    with pytest.raises(ValueError):
        localsgd.HierarchicalModelAverager({2: 4, 4: 2})
    with pytest.raises(ValueError):
        localsgd.HierarchicalModelAverager({2: 2, 4: 4})  # largest must be the world


def test_periodic_averager_is_the_group_mean(port8):
    avg = localsgd.PeriodicModelAverager(period=2, warmup_steps=0)
    p = {"a": torch.arange(W * 3, dtype=torch.float32).reshape(W, 3)}
    p1, did1 = avg.average_parameters(p)
    p2, did2 = avg.average_parameters(p)
    assert not did1 and p1 is p and did2
    assert torch.equal(p2["a"], p["a"].mean(0, keepdim=True).expand(W, 3))
