"""The port's mixed precision (`amp.py`) and gradient clipping (`nn/utils.py`)
against the reference's.

Mirrors the reference's `tests/test_amp.py` contract by contract: the scale
promotes (torch's default 2**16 survives an fp16 loss), unscale reports
overflow, the growth/backoff schedule, `where_finite` gates, one rank's inf
makes every rank skip (the reference's `axis_name` under `shard_map`; here
its driver-mode form, a min over the rank dim, and the `group=` all-reduce),
an fp16 loop with a stateful optimizer recovers from an overflow, policies
cast floating leaves only, and the clip norms. Across the packages, on the
same seeded values: the scale schedule over a sequence of finite and
overflowing steps is exact, and the clip norms (p 1, 2, 3 and inf, local and
across 8 ranks) and clipped grads are within rtol 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

import pytorch_distributed_example_tpu_torch as tdx
from pytorch_distributed_example_tpu import amp as jamp
from pytorch_distributed_example_tpu._compat import shard_map_fn
from pytorch_distributed_example_tpu.nn import utils as jutils
from pytorch_distributed_example_tpu_torch import optim
from pytorch_distributed_example_tpu_torch.amp import GradScaler, get_policy
from pytorch_distributed_example_tpu_torch.nn.utils import clip_grad_norm_, clip_grad_value_

NORM_TOL = dict(rtol=1e-6, atol=0)


@pytest.fixture
def group8():
    pg = tdx.init_process_group(world_size=8, device="cpu")
    yield pg
    tdx.destroy_process_group()


class TestGradScaler:
    def test_scale_unscale_round_trip(self):
        s = GradScaler(init_scale=1024.0)
        st = s.init()
        scaled = s.scale(torch.tensor(2.0, dtype=torch.float16), st)
        assert float(scaled) == 2048.0 and scaled.dtype == torch.float32
        un, finite = s.unscale({"w": torch.tensor([1024.0, 2048.0], dtype=torch.float16)}, st)
        assert un["w"].dtype == torch.float32 and un["w"].tolist() == [1.0, 2.0]
        assert bool(finite)

    def test_default_scale_survives_fp16_loss(self):
        s = GradScaler()
        scaled = s.scale(torch.tensor(1.5, dtype=torch.float16), s.init())
        assert np.isfinite(float(scaled)) and float(scaled) == 1.5 * 2.0**16

    def test_overflow_detected_and_backoff(self):
        s = GradScaler(init_scale=1024.0, backoff_factor=0.5)
        st = s.init()
        _, finite = s.unscale({"w": torch.tensor([float("inf"), 1.0])}, st)
        assert not bool(finite)
        st2 = s.update(st, finite)
        assert float(st2.scale) == 512.0 and int(st2.growth_tracker) == 0

    def test_growth_after_interval(self):
        s = GradScaler(init_scale=8.0, growth_factor=2.0, growth_interval=3)
        st = s.init()
        finite = torch.tensor(True)
        for _ in range(2):
            st = s.update(st, finite)
            assert float(st.scale) == 8.0
        st = s.update(st, finite)
        assert float(st.scale) == 16.0 and int(st.growth_tracker) == 0

    def test_schedule_is_the_references_exactly(self):
        flags = [True] * 5 + [False] + [True] * 7 + [False, False] + [True] * 4
        s = GradScaler(init_scale=3.0, growth_factor=2.0, backoff_factor=0.25,
                       growth_interval=3)
        js = jamp.GradScaler(init_scale=3.0, growth_factor=2.0, backoff_factor=0.25,
                             growth_interval=3)
        st, jst = s.init(), js.init()
        for f in flags:
            st = s.update(st, torch.tensor(f))
            jst = js.update(jst, jnp.asarray(f))
            assert st.scale.numpy().tobytes() == np.asarray(jst.scale).tobytes()
            assert int(st.growth_tracker) == int(jst.growth_tracker)
            assert st.scale.dtype == torch.float32 and st.growth_tracker.dtype == torch.int32

    def test_where_finite_skips_on_overflow(self):
        s = GradScaler()
        old, new = {"w": torch.tensor([1.0, 2.0])}, {"w": torch.tensor([0.5, 1.5])}
        assert s.where_finite(torch.tensor(False), new, old)["w"].tolist() == [1.0, 2.0]
        assert s.where_finite(torch.tensor(True), new, old)["w"].tolist() == [0.5, 1.5]

    def test_unscale_verdict_agrees_across_ranks(self, group8):
        """One rank's overflow: the driver-mode min over the rank dim and the
        group all-reduce both say False, as the reference's pmin does."""
        s = GradScaler(init_scale=2.0)
        st = s.init()
        g = np.ones((8, 3), np.float32)
        g[5, 1] = np.inf
        _, by_axis = s.unscale({"g": torch.from_numpy(g)}, st, axis_name="dp")
        _, by_group = s.unscale({"g": torch.from_numpy(g)}, st, group=group8)
        assert not bool(by_axis) and not bool(by_group)
        _, clean = s.unscale({"g": torch.ones(8, 3)}, st, group=group8)
        assert bool(clean)

        mesh = Mesh(np.array(jax.devices()[:8]), ("dp",))
        js = jamp.GradScaler(init_scale=2.0)

        def f(gl):
            _, finite = js.unscale({"g": gl}, js.init(), axis_name="dp")
            return finite.astype(jnp.int32)[None]

        per_rank = jax.jit(shard_map_fn(f, mesh=mesh, in_specs=(P("dp"),), out_specs=P("dp")))(
            jnp.asarray(g))
        assert (np.asarray(per_rank) == 0).all()

    def test_fp16_training_recovers_from_overflow(self):
        """A poisoned first batch is skipped, params AND adam's moments
        untouched, the scaler backs off, and training proceeds."""
        scaler = GradScaler(init_scale=2.0**10)
        opt = optim.adam(0.05)
        w0 = {"w": torch.tensor([1.0, 1.0])}

        def step(w, opt_state, sstate, x, y):
            wt = w["w"].detach().requires_grad_(True)
            pred = (x.half() @ wt.half()).float()
            loss = scaler.scale(((pred - y) ** 2).mean(), sstate)
            (gw,) = torch.autograd.grad(loss, [wt])
            grads, finite = scaler.unscale({"w": gw}, sstate)
            updates, new_opt = opt.update(grads, opt_state, w)
            new_w = optim.apply_updates(w, updates)
            return (scaler.where_finite(finite, new_w, w),
                    scaler.where_finite(finite, new_opt, opt_state),
                    scaler.update(sstate, finite), finite)

        sstate, opt_state = scaler.init(), opt.init(w0)
        y = torch.zeros(4)
        w, opt_state, sstate, finite = step(w0, opt_state, sstate, torch.full((4, 2), 60000.0), y)
        assert not bool(finite)
        assert torch.equal(w["w"], w0["w"]) and float(sstate.scale) == 2.0**9
        assert all(torch.isfinite(l).all() for l in (opt_state["mu"]["w"], opt_state["nu"]["w"]))
        x = torch.from_numpy(np.random.default_rng(0).standard_normal((4, 2)).astype(np.float32))
        losses = []
        for _ in range(10):
            w, opt_state, sstate, finite = step(w, opt_state, sstate, x, y)
            assert bool(finite)
            losses.append(float(((x @ w["w"]) ** 2).mean()))
        assert losses[-1] < losses[0]

    def test_bad_hyperparams_rejected(self):
        with pytest.raises(ValueError):
            GradScaler(growth_factor=1.0)
        with pytest.raises(ValueError):
            GradScaler(backoff_factor=1.5)


class TestPolicy:
    def test_policy_casts_only_floats(self):
        pol = get_policy("bf16")
        cast = pol.cast_to_compute({"w": torch.ones(2), "step": torch.tensor(3, dtype=torch.int32)})
        assert cast["w"].dtype == torch.bfloat16 and cast["step"].dtype == torch.int32
        assert pol.cast_to_param(cast)["w"].dtype == torch.float32
        assert get_policy("fp16").compute_dtype == torch.float16

    def test_unknown_policy(self):
        with pytest.raises(ValueError):
            get_policy("tf32")


def _grads(seed=0, world=None):
    gen = np.random.default_rng(seed)
    lead = () if world is None else (world,)
    return {"a": gen.standard_normal(lead + (6, 5)).astype(np.float32),
            "b": gen.standard_normal(lead + (7,)).astype(np.float32) * 3}


class TestClipGrad:
    def test_clip_norm_matches_torch_semantics(self):
        grads = {"a": torch.tensor([3.0, 4.0]), "b": torch.tensor([12.0])}
        clipped, total = clip_grad_norm_(grads, max_norm=6.5)
        assert float(total) == pytest.approx(13.0)
        got = float(torch.sqrt(sum((l ** 2).sum() for l in clipped.values())))
        assert got == pytest.approx(6.5, rel=1e-4)

    def test_no_clip_below_threshold(self):
        clipped, total = clip_grad_norm_({"a": torch.tensor([0.3, 0.4])}, max_norm=10.0)
        assert float(total) == pytest.approx(0.5)
        np.testing.assert_allclose(clipped["a"].numpy(), [0.3, 0.4], rtol=1e-5)

    def test_inf_norm(self):
        grads = {"a": torch.tensor([-7.0, 2.0]), "b": torch.tensor([3.0])}
        clipped, total = clip_grad_norm_(grads, 3.5, norm_type=float("inf"))
        assert float(total) == 7.0
        assert float(clipped["a"].abs().max()) == pytest.approx(3.5, rel=1e-4)

    def test_clip_value(self):
        out = clip_grad_value_({"a": torch.tensor([-7.0, 0.2])}, 1.0)
        np.testing.assert_allclose(out["a"].numpy(), [-1.0, 0.2], rtol=1e-6)
        jout = jutils.clip_grad_value_({"a": jnp.asarray([-7.0, 0.2])}, 1.0)
        assert out["a"].numpy().tobytes() == np.asarray(jout["a"]).tobytes()

    @pytest.mark.parametrize("p", [1.0, 2.0, 3.0, float("inf")])
    def test_norms_match_the_reference(self, p):
        g = _grads()
        clipped, total = clip_grad_norm_({k: torch.from_numpy(v) for k, v in g.items()}, 1.0, p)
        jclipped, jtotal = jutils.clip_grad_norm_({k: jnp.asarray(v) for k, v in g.items()},
                                                  1.0, p)
        np.testing.assert_allclose(float(total), float(jtotal), **NORM_TOL)
        for k in g:
            np.testing.assert_allclose(clipped[k].numpy(), np.asarray(jclipped[k]), **NORM_TOL)

    @pytest.mark.parametrize("p", [2.0, float("inf")])
    def test_global_norm_across_ranks_matches_the_reference(self, group8, p):
        """Per-rank shards at world 8: the driver-mode psum over the rank
        dim and the group all-reduce against the reference under
        `shard_map`."""
        g = _grads(1, world=8)
        tg = {k: torch.from_numpy(v) for k, v in g.items()}
        by_axis, t_axis = clip_grad_norm_(tg, 1.0, p, axis_name="dp")
        by_group, t_group = clip_grad_norm_(tg, 1.0, p, group=group8)
        mesh = Mesh(np.array(jax.devices()[:8]), ("dp",))

        def f(ga, gb):
            c, t = jutils.clip_grad_norm_({"a": ga, "b": gb}, 1.0, p, axis_name="dp")
            return c["a"], c["b"], t[None]

        ja, jb, jt = jax.jit(shard_map_fn(f, mesh=mesh, in_specs=(P("dp"), P("dp")),
                                          out_specs=(P("dp"), P("dp"), P("dp"))))(
            jnp.asarray(g["a"].reshape(48, 5)), jnp.asarray(g["b"].reshape(56)))
        np.testing.assert_allclose(float(t_axis), np.asarray(jt)[0], **NORM_TOL)
        assert float(t_axis) == float(t_group)
        np.testing.assert_allclose(by_axis["a"].numpy().reshape(48, 5), np.asarray(ja),
                                   **NORM_TOL)
        np.testing.assert_allclose(by_group["b"].numpy().reshape(56), np.asarray(jb),
                                   **NORM_TOL)
