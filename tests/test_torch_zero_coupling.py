"""ZeRO's guards for optimizers that couple elements, and the optimizers
they name, against the reference and optax.

* `classify_update_coupling` gives the reference's `(kind, hits)` on the
  port's counterpart of each optax optimizer its tests name.
* `optim.chain`, `clip_by_global_norm`, `lamb` and `adafactor` run 3 steps
  against optax 0.2.6 on the same numpy-seeded params and gradients,
  float32 both: updates and states within rtol 1e-5, atol 1e-7 (the
  block rms, trust-ratio and global norms sum in another order; a
  whole-leaf norm then moves every element of the leaf by the same few
  ulps), params within rtol 1e-5, atol 1e-6 (params of order 1 after
  lamb's trust-ratio steps, of order 1e-2: two ulps of 2.4e-7 remain
  where a sum cancels). The params hold a 128 x 160 matrix and a (2, 128, 1, 136) conv
  kernel, which adafactor factors, and a (32, 16, 3, 3) conv kernel and a
  bias, which it does not.
* The DDP step at world 2 on the ConvNet: the build-time warning for
  norm-coupled chains, with the reference's text, and adafactor under
  ZeRO "auto" falling back (one warning, `weight_update_sharded` False,
  params bitwise an "off" run's, losses within rtol 1e-5 of the
  reference's fallback) while "force" raises, as the reference's step
  does. Where the reference reads only the state's shapes, the port also
  falls back on the classifier's "factored": adafactor over a (1,) param
  and leaves under 128 leaves no shape trace. Under `TDX_PROGLINT=1` a
  step that fell back registers as `ddp.train_step.replicated`.
"""

import warnings

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
from pytorch_distributed_example_tpu.parallel.ddp import (
    classify_update_coupling as jclassify,
    make_ddp_train_step as jstep,
)
from pytorch_distributed_example_tpu_torch import optim
from pytorch_distributed_example_tpu_torch.models import ConvNet, convnet_from_flax
from pytorch_distributed_example_tpu_torch.parallel.ddp import (
    classify_update_coupling,
    make_ddp_train_step,
)
from tests import _ddp_cases as cases

TOL = dict(rtol=1e-5, atol=1e-7)
PARAM_TOL = dict(rtol=1e-5, atol=1e-6)
LOSS_TOL = dict(rtol=1e-5, atol=0)
SHAPES = {"w": (128, 160), "kf": (2, 128, 1, 136), "k": (32, 16, 3, 3), "b": (16,)}
STEPS = 3
W = 2

# (name, the reference's optax optimizer, the port's)
PAIRS = {
    "adam": (lambda: optax.adam(1e-3), lambda: optim.adam(1e-3)),
    "adamw": (lambda: optax.adamw(1e-3), lambda: optim.adamw(1e-3)),
    "sgd_momentum": (lambda: optax.sgd(1e-2, momentum=0.9),
                     lambda: optim.sgd(1e-2, momentum=0.9)),
    "adafactor": (lambda: optax.adafactor(1e-3), lambda: optim.adafactor(1e-3)),
    "lamb": (lambda: optax.lamb(1e-3), lambda: optim.lamb(1e-3)),
    "chain_clip_adam": (lambda: optax.chain(optax.clip_by_global_norm(1.0), optax.adam(1e-3)),
                        lambda: optim.chain(optim.clip_by_global_norm(1.0), optim.adam(1e-3))),
}


@pytest.mark.parametrize("name", sorted(PAIRS))
def test_classifier_matches_reference(name):
    jmake, tmake = PAIRS[name]
    assert classify_update_coupling(tmake()) == jclassify(jmake())


def test_classifier_kinds_and_unknowns():
    assert classify_update_coupling(optim.adafactor(1e-3)) == (
        "factored", ["clip_by_block_rms", "scale_by_factored_rms"])
    assert classify_update_coupling(optim.lamb(1e-3)) == ("per_leaf_norm", ["scale_by_trust_ratio"])
    assert classify_update_coupling(
        optim.chain(optim.clip_by_global_norm(1.0), optim.adam(1e-3))) == (
        "global_norm", ["clip_by_global_norm"])
    for nothing in (object(), torch.optim.SGD, None):
        assert classify_update_coupling(nothing) == jclassify(object()) == ("unknown", [])


def _tree(seed, scale=1.0):
    gen = np.random.default_rng(seed)
    return {n: (scale * gen.standard_normal(s)).astype(np.float32) for n, s in SHAPES.items()}


def _close(got, want, what, tol=TOL):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **tol, err_msg=what)


OPTAX_CASES = {
    "adafactor": (lambda: optax.adafactor(1e-2), lambda: optim.adafactor(1e-2)),
    "adafactor_small_lr": (lambda: optax.adafactor(1e-4), lambda: optim.adafactor(1e-4)),
    "lamb": (lambda: optax.lamb(1e-2), lambda: optim.lamb(1e-2)),
    "lamb_decay": (lambda: optax.lamb(1e-2, b1=0.8, weight_decay=0.1),
                   lambda: optim.lamb(1e-2, b1=0.8, weight_decay=0.1)),
    "chain_clip_adamw": (
        lambda: optax.chain(optax.clip_by_global_norm(1.0), optax.adamw(1e-2)),
        lambda: optim.chain(optim.clip_by_global_norm(1.0), optim.adamw(1e-2))),
    "clip_by_global_norm_idle": (lambda: optax.clip_by_global_norm(1e3),
                                 lambda: optim.clip_by_global_norm(1e3)),
}


@pytest.mark.parametrize("name", sorted(OPTAX_CASES))
def test_matches_optax_over_three_steps(name):
    jmake, tmake = OPTAX_CASES[name]
    jopt, topt = jmake(), tmake()
    params = _tree(0)
    jp = {n: jnp.asarray(a) for n, a in params.items()}
    tp = {n: torch.from_numpy(a.copy()) for n, a in params.items()}
    js, ts = jopt.init(jp), topt.init(tp)
    for i in range(STEPS):
        grads = _tree(10 + i, 0.1)
        ju, js = jopt.update({n: jnp.asarray(g) for n, g in grads.items()}, js, jp)
        tu, ts = topt.update({n: torch.from_numpy(g) for n, g in grads.items()}, ts, tp)
        jp, tp = optax.apply_updates(jp, ju), optim.apply_updates(tp, tu)
        for n in SHAPES:
            _close(tu[n], ju[n], f"{name} step {i} update {n}")
    for n in SHAPES:
        _close(tp[n], jp[n], f"{name} params {n}", PARAM_TOL)
    if name.startswith("adafactor"):
        jf, tf = js[0], ts[0]
        assert int(tf["count"]) == int(jf.count) == STEPS and tf["count"].dtype == torch.int32
        for part in ("v_row", "v_col", "v"):
            for n in SHAPES:
                assert tuple(tf[part][n].shape) == tuple(getattr(jf, part)[n].shape), (part, n)
                _close(tf[part][n], getattr(jf, part)[n], f"{name} {part} {n}")
        # the 2-D leaf and the (2, 128, 1, 136) kernel are factored
        assert tuple(tf["v_row"]["w"].shape) == (128,) and tuple(tf["v_col"]["w"].shape) == (160,)
        assert tuple(tf["v_row"]["kf"].shape) == (2, 128, 1)
    elif name.startswith("lamb"):
        ja, ta = js[0], ts[0]
        assert int(ta["count"]) == int(ja.count) == STEPS
        for n in SHAPES:
            _close(ta["mu"][n], ja.mu[n], f"{name} mu {n}")
            _close(ta["nu"][n], ja.nu[n], f"{name} nu {n}")


def test_clip_by_global_norm_scales_to_the_limit():
    grads = {n: torch.from_numpy(g) for n, g in _tree(3).items()}
    out, _ = optim.clip_by_global_norm(1.0).update(grads, ())
    norm = torch.sqrt(sum((u * u).sum() for u in out.values()))
    assert abs(float(norm) - 1.0) < 1e-5
    assert optim.clip_by_global_norm(1.0).update({}, ())[0] == {}


def test_params_are_required_where_optax_requires_them():
    grads = {"w": torch.ones(3)}
    for opt in (optim.lamb(1e-3), optim.adafactor(1e-3)):
        with pytest.raises(ValueError, match="needs the params"):
            opt.update(grads, opt.init(grads))


def _warnings_of(build):
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        build()
    return [str(w.message) for w in caught if issubclass(w.category, RuntimeWarning)]


@pytest.mark.parametrize("coupled", ["chain_clip_adam", "lamb"])
def test_build_time_warning_fires_and_stays_quiet(world, coupled):
    """The reference's test at world 2: building a sharded step over a
    norm-coupled chain warns once, with the reference's text, naming the
    offending factory; the same build over adam stays silent, as does an
    "off" step over the coupled chain."""
    jmake, tmake = PAIRS[coupled]
    g = jtdx.new_group(ranks=[0, 1])
    want = _warnings_of(lambda: jstep(lambda p, x: x @ p["w"],
                                      lambda o, y: jnp.mean((o - y) ** 2), jmake(), group=g))
    tdx.init_process_group(world_size=W, device="cpu")
    try:
        def build(opt, **kw):
            return lambda: make_ddp_train_step(lambda p, x: x @ p["w"],
                                               lambda o, y: torch.mean((o - y) ** 2), opt, **kw)

        hit = {"chain_clip_adam": "clip_by_global_norm", "lamb": "scale_by_trust_ratio"}[coupled]
        with pytest.warns(RuntimeWarning, match=hit):
            build(tmake())()
        got = _warnings_of(build(tmake()))
        assert got == want and len(got) == 1
        assert _warnings_of(build(optim.adam(1e-3))) == []
        assert _warnings_of(build(tmake(), shard_weight_update="off")) == []
    finally:
        tdx.destroy_process_group()


def _reference_adafactor_losses(flax_params, x, y):
    """The reference's ConvNet step at world 2 under "auto" with
    optax.adafactor: its fallback warning, then STEPS losses."""
    g = jtdx.new_group(ranks=[0, 1])
    ddp = jtdx.DistributedDataParallel(
        JConvNet(), jax.tree_util.tree_map(jnp.array, flax_params), process_group=g)
    opt = optax.adafactor(1e-3)

    def loss_fn(logits, yy):
        return optax.softmax_cross_entropy_with_integer_labels(logits, yy).mean()

    step = ddp.make_train_step(opt, loss_fn)
    with pytest.warns(RuntimeWarning, match="does not commute"):
        s = step.init_opt_state(ddp.params)
    assert not step.weight_update_sharded
    p, losses = ddp.params, []
    for _ in range(STEPS):
        p, s, loss = step(p, s, jnp.asarray(x), jnp.asarray(y))
        losses.append(float(loss))
    return losses


def test_coupled_optimizer_auto_falls_back_force_raises(world):
    """Adafactor's state has leaves shaped unlike any param (its (1,)
    placeholders; on a leaf with two dims of 128 its factored moments), so
    slicing would change its math. "auto" warns once, takes the
    replicated update and trains: params bitwise an "off" run's, losses
    the reference's fallback's. "force" refuses, through every entry
    that builds a sharded state."""
    flax_params = JConvNet().init(jax.random.PRNGKey(0), jnp.zeros((1, 28, 28, 1)))
    x, y = cases.global_batch(W)
    want = _reference_adafactor_losses(flax_params, x, y)
    xt = torch.from_numpy(x.transpose(0, 3, 1, 2).copy())
    yt = torch.from_numpy(y).long()
    tdx.init_process_group(world_size=W, device="cpu")
    try:
        ddp = tdx.DistributedDataParallel(ConvNet(device="cpu"),
                                          convnet_from_flax(flax_params))
        opt = optim.adafactor(1e-3)
        step = ddp.make_train_step(opt, F.cross_entropy)
        assert step.weight_update_sharded
        with pytest.warns(RuntimeWarning, match="does not commute"):
            s = step.init_opt_state(ddp.params)
        assert not step.weight_update_sharded
        assert _warnings_of(lambda: step.init_opt_state(ddp.params)) == []  # once
        off = ddp.make_train_step(opt, F.cross_entropy, shard_weight_update="off")
        p, q, so = ddp.params, ddp.params, opt.init(ddp.params)
        losses = []
        for _ in range(STEPS):
            p, s, loss = step(p, s, xt, yt)
            q, so, loss_off = off(q, so, xt, yt)
            assert torch.equal(loss, loss_off)
            losses.append(float(loss))
        assert all(torch.equal(p[n], q[n]) for n in p)
        assert step.shard_opt_state(p, s) is s
        assert step.memory_report(p, s)["opt_state_reduction_x"] == 1.0
        np.testing.assert_allclose(losses, want, **LOSS_TOL)

        # a plain state handed straight to a fresh "auto" step falls back too
        fresh = ddp.make_train_step(opt, F.cross_entropy)
        with pytest.warns(RuntimeWarning, match="falling back"):
            fresh(ddp.params, opt.init(ddp.params), xt, yt)
        assert not fresh.weight_update_sharded

        forced = ddp.make_train_step(opt, F.cross_entropy, shard_weight_update="force")
        for entry in (lambda: forced.init_opt_state(ddp.params),
                      lambda: forced(ddp.params, opt.init(ddp.params), xt, yt),
                      lambda: forced.shard_opt_state(ddp.params, opt.init(ddp.params))):
            with pytest.raises(ValueError, match="does not commute"):
                entry()
        assert forced.weight_update_sharded

        # elementwise optimizers keep the sharded update
        adam = ddp.make_train_step(optim.adam(1e-3), F.cross_entropy)
        adam.init_opt_state(ddp.params)
        assert adam.weight_update_sharded
    finally:
        tdx.destroy_process_group()


def _tiny_case():
    """A (1,)-shaped param beside a 4 x 3 matrix, and a world-2 batch."""
    gen = np.random.default_rng(5)
    params = {"s": torch.from_numpy(gen.standard_normal((1,)).astype(np.float32)),
              "w": torch.from_numpy(gen.standard_normal((4, 3)).astype(np.float32))}
    x = torch.from_numpy(gen.standard_normal((2 * W, 4)).astype(np.float32))
    y = torch.from_numpy(gen.standard_normal((2 * W, 3)).astype(np.float32))
    return (params, x, y, lambda p, xx: xx @ p["w"] + p["s"],
            lambda o, yy: torch.mean((o - yy) ** 2))


def test_factored_optimizer_falls_back_without_a_shape_trace():
    """adafactor over a (1,) param and leaves under 128: its (1,)
    placeholders match a param's shape and nothing is factored, so no state
    leaf is shaped unlike a param. Its block-rms clip and scale still read
    whole leaves, which a 1/W shard would change: the classifier's
    "factored" makes "auto" fall back (params bitwise "off"'s) and "force"
    raise."""
    params, x, y, apply, loss = _tiny_case()
    opt = optim.adafactor(1e-2)
    shapes = {tuple(p.shape) for p in params.values()}
    assert all(l.dim() == 0 or tuple(l.shape) in shapes
               for l in torch.utils._pytree.tree_leaves(opt.init(params)))
    tdx.init_process_group(world_size=W, device="cpu")
    try:
        step = make_ddp_train_step(apply, loss, opt)
        off = make_ddp_train_step(apply, loss, opt, shard_weight_update="off")
        with pytest.warns(RuntimeWarning, match="does not commute"):
            s = step.init_opt_state(params)
        assert not step.weight_update_sharded
        p, q, so = params, params, opt.init(params)
        for _ in range(STEPS):
            p, s, _ = step(p, s, x, y)
            q, so, _ = off(q, so, x, y)
        assert all(torch.equal(p[n], q[n]) for n in p)
        forced = make_ddp_train_step(apply, loss, opt, shard_weight_update="force")
        with pytest.raises(ValueError, match="scale_by_factored_rms"):
            forced.init_opt_state(params)
        adam = make_ddp_train_step(apply, loss, optim.adam(1e-3))
        adam.init_opt_state(params)
        assert adam.weight_update_sharded
    finally:
        tdx.destroy_process_group()


def test_proglint_names_the_resolved_program(monkeypatch):
    """Under `TDX_PROGLINT=1` the step's program is named at its first
    call, after the mode is resolved: adafactor under "auto" registers as
    the replicated program, adam as the ZeRO one."""
    from pytorch_distributed_example_tpu_torch.tools import proglint as pl

    monkeypatch.setenv("TDX_PROGLINT", "1")
    params, x, y, apply, loss = _tiny_case()
    pl.registry().clear()
    tdx.init_process_group(world_size=W, device="cpu")
    try:
        steps = []
        for opt in (optim.adafactor(1e-2), optim.adam(1e-3)):
            step = make_ddp_train_step(apply, loss, opt)
            with warnings.catch_warnings():
                warnings.simplefilter("ignore", RuntimeWarning)
                p, s, _ = step(params, opt.init(params), x, y)
                step(p, s, x, y)
            steps.append(step)
        names = [(n, k) for n, k, _ in pl.registry().entries()]
        assert names == [("ddp.train_step.replicated", 0), ("ddp.train_step.zero", 0)]
        assert [st.weight_update_sharded for st in steps] == [False, True]
        assert hasattr(steps[0], "init_opt_state") and steps[0].__name__ == "step"
    finally:
        tdx.destroy_process_group()
        pl.registry().clear()
