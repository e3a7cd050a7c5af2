"""The port's sharded trainer step against the reference's `fully_shard`.

Three AdamW steps (lr 1e-3) of the trainer's step over an ("fsdp", "tp")
mesh of (2, 2) in driver mode, dense and MoE (4 experts, top-1), against
the reference's `fully_shard(..., rules=transformer_sharding_rules("tp",
"fsdp"), data_axes=("fsdp",))` step on a (2, 2) mesh of the conftest's
CPU devices, and against the port's own unsharded step: the same converted
params and tokens, float32, dense attention on both sides. Losses agree to
rtol 1e-5, params to rtol 1e-4 / atol 1e-6. Then ZeRO-2
(`make_zero2_train_step`) and ZeRO-1 (`shard_optimizer_only`) against the
reference's.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from pytorch_distributed_example_tpu.mesh import init_device_mesh
from pytorch_distributed_example_tpu.models import transformer as jtr
from pytorch_distributed_example_tpu.parallel import fsdp as jfsdp
from pytorch_distributed_example_tpu_torch.dtensor import DTensor, Replicate, Shard
from pytorch_distributed_example_tpu_torch.examples import lm
from pytorch_distributed_example_tpu_torch.mesh import DeviceMesh
from pytorch_distributed_example_tpu_torch.models import convert, transformer as ttr
from pytorch_distributed_example_tpu_torch.parallel import fsdp as tfsdp
from pytorch_distributed_example_tpu_torch.parallel.comm_hooks import blockwise_quant_hook
from pytorch_distributed_example_tpu_torch.utils import memstats

LR = 1e-3
STEPS = 3
LOSS_RTOL = 1e-5
PARAM_TOL = dict(rtol=1e-4, atol=1e-6)
AMPLIFIED = 2  # entries a tensor whose gradient sits at AdamW's eps (docstring)
KW = dict(vocab_size=128, d_model=64, n_layers=2, n_heads=4, max_seq_len=32, use_flash=False)


def _tokens(step):
    return np.random.default_rng(10 + step).integers(0, 128, (4, 32)).astype(np.int32)


def _jax_loss(logits, y):
    return optax.softmax_cross_entropy_with_integer_labels(logits[:, :-1], y[:, 1:]).mean()


@functools.lru_cache(maxsize=None)
def _reference(n_experts):
    """(initial params as numpy, losses, final params as numpy) of the
    reference's fully_shard step over 3 steps."""
    model = jtr.TransformerLM(jtr.TransformerConfig(n_experts=n_experts, **KW))
    params = jax.jit(model.init)(jax.random.PRNGKey(0), jnp.asarray(_tokens(0)))
    init = jax.tree.map(np.asarray, params)
    mesh = init_device_mesh(("fsdp", "tp"), (2, 2), devices=jax.devices()[:4])
    mod = jfsdp.fully_shard(model, params, mesh, axis="fsdp",
                            rules=jtr.sharding_rules("tp", "fsdp"), data_axes=("fsdp",))
    opt = optax.adamw(LR)
    step = mod.make_train_step(opt, _jax_loss, donate=False)
    p, s = mod.params, opt.init(mod.params)
    losses = []
    for i in range(STEPS):
        toks = jnp.asarray(_tokens(i))
        p, s, loss = step(p, s, toks, toks)
        losses.append(float(loss))
    return init, losses, jax.tree.map(np.asarray, p)


def _port_model(n_experts, init):
    m = ttr.TransformerLM(ttr.TransformerConfig(n_experts=n_experts, **KW), device="cpu")
    m.load_state_dict(convert.from_flax(init))
    return m


def _port_sharded(n_experts, init, mesh_shape=(2, 2)):
    """(losses, final state dict, the FSDPModule, its optimizer)."""
    mod = lm.shard(_port_model(n_experts, init), LR, mesh_shape[0] * mesh_shape[1],
                   mesh_shape[1])
    opt = mod.step.init_opt_state(mod.params)
    losses = []
    for i in range(STEPS):
        t = torch.from_numpy(_tokens(i)).long()
        losses.append(float(lm.train_step(mod, opt, t)))
    return losses, mod.gather_params(), mod, opt


def _port_unsharded(n_experts, init):
    m = _port_model(n_experts, init)
    opt = lm.make_optimizer(m, LR)
    losses = [float(lm.train_step(m, opt, torch.from_numpy(_tokens(i)).long()))
              for i in range(STEPS)]
    return losses, {k: v.detach() for k, v in m.state_dict().items()}


def _assert_params(got, want_state, what):
    assert set(got) == set(want_state)
    for name, want in want_state.items():
        want = np.asarray(want)
        diff = np.abs(got[name].numpy() - want)
        outside = diff > PARAM_TOL["atol"] + PARAM_TOL["rtol"] * np.abs(want)
        assert outside.sum() <= AMPLIFIED and diff.max() <= STEPS * LR, (
            f"{what}: {name}: {outside.sum()} entries outside rtol 1e-4 / atol 1e-6, "
            f"max |diff| {diff.max():.3e}")


@pytest.mark.parametrize("n_experts", [0, 4], ids=["dense", "moe"])
def test_sharded_step_matches_reference_fully_shard(n_experts):
    init, want_losses, want = _reference(n_experts)
    losses, state, _, _ = _port_sharded(n_experts, init)
    np.testing.assert_allclose(losses, want_losses, rtol=LOSS_RTOL)
    _assert_params(state, convert.from_flax(want), "port sharded vs reference")


@pytest.mark.parametrize("n_experts", [0, 4], ids=["dense", "moe"])
def test_sharded_step_matches_own_unsharded_step(n_experts):
    init, _, _ = _reference(n_experts)
    losses, state, _, _ = _port_sharded(n_experts, init)
    want_losses, want = _port_unsharded(n_experts, init)
    np.testing.assert_allclose(losses, want_losses, rtol=LOSS_RTOL)
    _assert_params(state, want, "port sharded vs unsharded")


@pytest.mark.parametrize("mesh_shape", [(4, 1), (1, 4)], ids=["fsdp4", "tp4"])
def test_other_meshes_match_own_unsharded_step(mesh_shape):
    init, _, _ = _reference(0)
    losses, state, _, _ = _port_sharded(0, init, mesh_shape)
    want_losses, want = _port_unsharded(0, init)
    np.testing.assert_allclose(losses, want_losses, rtol=LOSS_RTOL)
    _assert_params(state, want, f"mesh {mesh_shape}")


def test_params_and_optimizer_state_are_sharded_by_the_rules():
    init, _, _ = _reference(4)
    _, _, mod, opt = _port_sharded(4, init)
    p = mod.params
    assert p["layers.0.attn.q_proj.weight"].placements == (Shard(1), Shard(0))
    assert p["layers.0.attn.q_proj.weight"]._local.shape == (2, 2, 32, 32)
    assert p["layers.0.attn.o_proj.weight"].placements == (Shard(0), Shard(1))
    assert p["tok_embed.weight"].placements == (Replicate(), Shard(1))
    assert p["lm_head.weight"].placements == (Shard(1), Shard(0))
    assert p["layers.1.mlp.experts_up"].placements == (Shard(0), Shard(2))
    assert p["layers.1.mlp.experts_down"].placements == (Shard(0), Shard(1))
    assert p["layers.1.mlp.router"].placements == (Replicate(), Replicate())
    assert p["final_norm.weight"].placements == (Replicate(), Replicate())
    rep = memstats.train_memory_report(p, opt)
    # the big leaves split 4 ways, the norms, router and embedding's rows less
    assert rep["param_bytes"] / rep["param_bytes_per_device"] > 3.0
    assert rep["opt_state_reduction_x"] > 3.0
    # AdamW's two moments mirror the params; its step counts count whole
    steps = sum(s["step"].numel() * s["step"].element_size() for s in opt.state.values())
    assert rep["opt_state_bytes"] == 2 * rep["param_bytes"] + steps


def test_sharded_state_round_trips_through_flax_layout():
    init, _, _ = _reference(4)
    mod = lm.shard(_port_model(4, init), LR, 4, 2)
    tree = convert.to_flax(mod.params)
    flat_want = jax.tree_util.tree_leaves_with_path(init["params"])
    flat_got = dict(jax.tree_util.tree_leaves_with_path(tree))
    assert len(flat_got) == len(flat_want)
    for path, want in flat_want:
        np.testing.assert_array_equal(flat_got[path], want)


def test_replicated_update_matches_sharded_update():
    init, _, _ = _reference(0)
    runs = []
    for swu in ("auto", "off"):
        model = _port_model(0, init)
        mesh = DeviceMesh(["cpu"] * 4, (2, 2), ("fsdp", "tp"))
        mod = tfsdp.fully_shard(model, None, mesh, axis="fsdp",
                                rules=ttr.sharding_rules("tp", "fsdp"), data_axes=("fsdp",))
        step = mod.make_train_step(lm.adamw(LR), lm.loss_fn, shard_weight_update=swu)
        opt = step.init_opt_state(mod.params)
        for i in range(STEPS):
            t = torch.from_numpy(_tokens(i)).long()
            step(mod.params, opt, t, t)
        runs.append((mod.gather_params(), memstats.train_memory_report(mod.params, opt)))
    (auto, rep_auto), (off, rep_off) = runs
    for k in auto:
        torch.testing.assert_close(auto[k], off[k], rtol=0, atol=0)
    assert rep_off["opt_state_reduction_x"] == 1.0 < rep_auto["opt_state_reduction_x"]


def test_generic_module_trains_on_gathered_params():
    """A module without a mesh-aware forward (a plain MLP) runs on its
    gathered params: the step equals the unsharded one."""
    torch.manual_seed(0)
    net = torch.nn.Sequential(torch.nn.Linear(8, 16), torch.nn.Tanh(), torch.nn.Linear(16, 4))
    ref = torch.nn.Sequential(torch.nn.Linear(8, 16), torch.nn.Tanh(), torch.nn.Linear(16, 4))
    ref.load_state_dict(net.state_dict())
    mesh = DeviceMesh(["cpu"] * 4, (4,), ("fsdp",))
    mod = tfsdp.fully_shard(net, None, mesh, axis="fsdp", data_axes=("fsdp",))
    assert mod.params["0.weight"].placements == (Shard(0),)
    assert mod.params["2.bias"].placements == (Shard(0),)
    loss_fn = lambda out, y: torch.nn.functional.mse_loss(out, y)
    step = mod.make_train_step(functools.partial(torch.optim.SGD, lr=0.1), loss_fn)
    opt = step.init_opt_state(mod.params)
    ref_opt = torch.optim.SGD(ref.parameters(), lr=0.1)
    gen = torch.Generator().manual_seed(1)
    for _ in range(3):
        x, y = torch.randn(8, 8, generator=gen), torch.randn(8, 4, generator=gen)
        _, _, loss = step(mod.params, opt, x, y)
        ref_opt.zero_grad()
        ref_loss = loss_fn(ref(x), y)
        ref_loss.backward()
        ref_opt.step()
        torch.testing.assert_close(loss, ref_loss.detach())
    for k, v in mod.gather_params().items():
        torch.testing.assert_close(v, ref.state_dict()[k])


def test_refused_options_name_the_roadmap():
    """What the reference's steps refuse, the port's refuse: a stateful
    hook on ZeRO-2 (it carries no hook state), a hook over two data axes,
    and data axes the mesh lacks."""
    mesh = DeviceMesh(["cpu"] * 2, (2,), ("fsdp",))
    with pytest.raises(NotImplementedError, match="stateless"):
        tfsdp.make_zero2_train_step(None, None, None, mesh, data_axes=("fsdp",),
                                    comm_hook=blockwise_quant_hook(error_feedback=True))
    mesh2 = DeviceMesh(["cpu"] * 4, (2, 2), ("dp", "fsdp"))
    with pytest.raises(ValueError, match="exactly one data axis"):
        tfsdp.make_zero2_train_step(None, None, None, mesh2, data_axes=("dp", "fsdp"),
                                    comm_hook=blockwise_quant_hook(error_feedback=False))
    with pytest.raises(ValueError, match="data_axes"):
        tfsdp.make_fsdp_train_step(None, None, None, mesh, {}, data_axes=("dp",))
    with pytest.raises(ValueError, match="rng_fn"):
        tfsdp.make_fsdp_train_step(None, None, None, mesh, {}, data_axes=("fsdp",),
                                   has_rng=True)


# -- the ("dp", "fsdp", "tp") mesh -------------------------------------------


def _tokens8(step):
    return np.random.default_rng(20 + step).integers(0, 128, (8, 32)).astype(np.int32)


MESH_3D = ((2, 2, 2), ("dp", "fsdp", "tp"))


@functools.lru_cache(maxsize=None)
def _reference_3d():
    """The reference's fully_shard step over ("dp", "fsdp", "tp") (2, 2, 2),
    the batch of 8 (two rows a data rank, the dry run's) over ("dp",
    "fsdp"): (init, losses, final params). At a batch of 4 (one row a data
    rank) the reference's forward on this mesh is off its own unsharded
    forward by up to 4.0 in the logits (ROADMAP.md, Queue 3)."""
    model = jtr.TransformerLM(jtr.TransformerConfig(**KW))
    params = jax.jit(model.init)(jax.random.PRNGKey(0), jnp.asarray(_tokens(0)))
    init = jax.tree.map(np.asarray, params)
    mesh = init_device_mesh(MESH_3D[1], MESH_3D[0], devices=jax.devices()[:8])
    mod = jfsdp.fully_shard(model, params, mesh, axis="fsdp",
                            rules=jtr.sharding_rules("tp", "fsdp"), data_axes=("dp", "fsdp"))
    opt = optax.adamw(LR)
    step = mod.make_train_step(opt, _jax_loss, donate=False)
    p, s = mod.params, opt.init(mod.params)
    losses = []
    for i in range(STEPS):
        toks = jnp.asarray(_tokens8(i))
        p, s, loss = step(p, s, toks, toks)
        losses.append(float(loss))
    return init, losses, jax.tree.map(np.asarray, p)


def _port_3d(init, tokens):
    """(losses, gathered params, model) of the port's step over the 3-D mesh."""
    model = _port_model(0, init)
    mesh = DeviceMesh(["cpu"] * 8, *MESH_3D)
    mod = tfsdp.fully_shard(model, None, mesh, axis="fsdp",
                            rules=ttr.sharding_rules("tp", "fsdp"), data_axes=("dp", "fsdp"))
    assert mod.params["layers.0.attn.q_proj.weight"].placements == (
        Replicate(), Shard(1), Shard(0))
    assert mod.params["layers.0.attn.q_proj.weight"]._local.shape == (1, 2, 2, 32, 32)
    step = mod.make_train_step(lm.adamw(LR), lm.loss_fn)
    opt = step.init_opt_state(mod.params)
    losses = []
    for i in range(STEPS):
        t = torch.from_numpy(tokens(i)).long()
        losses.append(float(step(mod.params, opt, t, t)[2]))
    return losses, mod.gather_params(), model


def test_3d_mesh_step_matches_reference_fully_shard():
    """dp x fsdp x tp in driver mode: the stacked path (the data ranks
    folded into the rows, params one replica over dp), three AdamW steps
    against the reference's."""
    init, want_losses, want = _reference_3d()
    losses, state, model = _port_3d(init, _tokens8)
    assert model.sharded_aux == []  # the stacked path ran, not the gathered one
    np.testing.assert_allclose(losses, want_losses, rtol=LOSS_RTOL)
    _assert_params(state, convert.from_flax(want), "3-D mesh vs reference")


def test_3d_mesh_step_matches_own_unsharded_step():
    """At a batch of 4, one row a data rank, against the port's unsharded
    step (where the reference's own 3-D step goes astray)."""
    init, _, _ = _reference_3d()
    losses, state, _ = _port_3d(init, _tokens)
    want_losses, want = _port_unsharded(0, init)
    np.testing.assert_allclose(losses, want_losses, rtol=LOSS_RTOL)
    _assert_params(state, want, "3-D mesh vs unsharded")


# -- dropout in the sharded steps (has_rng) ----------------------------------


class _MaskedMLP(torch.nn.Module):
    """A dropout-free MLP that takes masks (and ignores them)."""

    def __init__(self):
        super().__init__()
        self.fc1, self.fc2 = torch.nn.Linear(8, 16), torch.nn.Linear(16, 4)

    def forward(self, x, masks=None):
        return self.fc2(torch.tanh(self.fc1(x)))


def _mask_fn(seen):
    def rng_fn(generator, batch):
        m = torch.rand((batch, 16), generator=generator) < 0.5
        seen.append(m)
        return m
    return rng_fn


@pytest.mark.parametrize("which", ["fsdp", "zero2"])
def test_has_rng_gives_the_same_step_and_a_mask_a_rank(which):
    """On a dropout-free model the has_rng step is the step without it,
    bit for bit, and each of the 4 data ranks draws its own mask from the
    generator the step takes."""
    torch.manual_seed(0)
    mesh = DeviceMesh(["cpu"] * 4, (2, 2), ("dp", "fsdp"))
    loss_fn = lambda out, y: torch.nn.functional.mse_loss(out, y)
    gen = torch.Generator().manual_seed(1)
    x, y = torch.randn(8, 8, generator=gen), torch.randn(8, 4, generator=gen)
    base = _MaskedMLP()
    runs, seen = [], []
    for has_rng in (False, True):
        net = _MaskedMLP()
        net.load_state_dict(base.state_dict())
        kw = dict(has_rng=True, rng_fn=_mask_fn(seen)) if has_rng else {}
        extra = (torch.Generator().manual_seed(2),) if has_rng else ()
        sgd = functools.partial(torch.optim.SGD, lr=0.1)
        if which == "fsdp":
            mod = tfsdp.fully_shard(net, None, mesh, axis="fsdp", data_axes=("dp", "fsdp"))
            step = mod.make_train_step(sgd, loss_fn, **kw)
            params = mod.params
        else:
            params = {k: v.detach().clone() for k, v in net.state_dict().items()}
            apply = lambda p, xx, *m: torch.func.functional_call(net, p, (xx, *m))
            step = tfsdp.make_zero2_train_step(apply, loss_fn, sgd, mesh, axis="fsdp",
                                               data_axes=("dp", "fsdp"), **kw)
        opt = step.init_opt_state(params)
        losses = [step(params, opt, x, y, *extra)[2] for _ in range(2)]
        full = mod.gather_params() if which == "fsdp" else params
        runs.append((losses, {k: v.detach().clone() for k, v in full.items()}))
    (l0, p0), (l1, p1) = runs
    torch.testing.assert_close(l1, l0, rtol=0, atol=0)
    for k in p0:
        torch.testing.assert_close(p1[k], p0[k], rtol=0, atol=0)
    assert len(seen) == 2 * 4 and all(m.shape == (2, 16) for m in seen)
    for a in range(4):  # one step's four ranks: four different masks
        for b in range(a):
            assert not torch.equal(seen[a], seen[b])
    with pytest.raises(TypeError, match="Generator"):
        step(params, opt, x, y)


# -- ZeRO-2 and ZeRO-1 -------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _zero2_reference():
    model = jtr.TransformerLM(jtr.TransformerConfig(**KW))
    params = jax.jit(model.init)(jax.random.PRNGKey(1), jnp.asarray(_tokens(0)))
    init = jax.tree.map(np.asarray, params)
    mesh = init_device_mesh(("fsdp",), (4,), devices=jax.devices()[:4])
    opt = optax.adamw(LR)
    step = jfsdp.make_zero2_train_step(model.apply, _jax_loss, opt, mesh, axis="fsdp",
                                       data_axes=("fsdp",), donate=False)
    p, s = params, step.init_opt_state(params)
    losses = []
    for i in range(STEPS):
        toks = jnp.asarray(_tokens(i))
        p, s, loss = step(p, s, toks, toks)
        losses.append(float(loss))
    return init, losses, jax.tree.map(np.asarray, p)


def test_zero2_step_matches_reference():
    init, want_losses, want = _zero2_reference()
    model = _port_model(0, init)
    params = {k: v.detach().clone() for k, v in model.state_dict().items()}
    mesh = DeviceMesh(["cpu"] * 4, (4,), ("fsdp",))
    apply = lambda p, x: torch.func.functional_call(model, p, (x,))
    step = tfsdp.make_zero2_train_step(apply, lm.loss_fn, lm.adamw(LR), mesh, axis="fsdp",
                                       data_axes=("fsdp",))
    opt = step.init_opt_state(params)
    losses = []
    for i in range(STEPS):
        t = torch.from_numpy(_tokens(i)).long()
        params, opt, loss = step(params, opt, t, t)
        losses.append(float(loss))
    np.testing.assert_allclose(losses, want_losses, rtol=LOSS_RTOL)
    _assert_params(params, convert.from_flax(want), "ZeRO-2")
    rep = memstats.train_memory_report(params, opt)
    # every leaf here has a dim 0 that 4 divides but the norms' (64,): all split
    assert rep["opt_state_reduction_x"] > 3.5
    assert opt.shards["layers.0.attn.q_proj.weight"].shape == (4, 16, 64)


def test_shard_optimizer_only_matches_reference_layout():
    gen = np.random.default_rng(5)
    state = {"mu": {"w": gen.standard_normal((8, 3)).astype(np.float32),
                    "b": gen.standard_normal((3,)).astype(np.float32)},
             "count": np.array(3, np.int32)}
    jmesh = init_device_mesh(("fsdp",), (4,), devices=jax.devices()[:4])
    want = jfsdp.shard_optimizer_only(jax.tree.map(jnp.asarray, state), jmesh, "fsdp")
    tmesh = DeviceMesh(["cpu"] * 4, (4,), ("fsdp",))
    got = tfsdp.shard_optimizer_only(jax.tree.map(torch.from_numpy, state), tmesh, "fsdp")
    for path, w in jax.tree_util.tree_leaves_with_path(want):
        g = got
        for k in path:
            g = g[k.key]
        assert isinstance(g, DTensor)
        spec = w.sharding.spec
        want_placements = (Shard(0),) if len(spec) and spec[0] == "fsdp" else (Replicate(),)
        assert g.placements == want_placements, path
        np.testing.assert_array_equal(g.full_tensor().numpy(), np.asarray(w))


@functools.lru_cache(maxsize=None)
def _zero2_reference_dp():
    """The reference's ZeRO-2 over ("dp", "fsdp") (2, 2), the batch over
    both, gradients reduce-scattered over fsdp."""
    model = jtr.TransformerLM(jtr.TransformerConfig(**KW))
    params = jax.jit(model.init)(jax.random.PRNGKey(1), jnp.asarray(_tokens(0)))
    init = jax.tree.map(np.asarray, params)
    mesh = init_device_mesh(("dp", "fsdp"), (2, 2), devices=jax.devices()[:4])
    step = jfsdp.make_zero2_train_step(model.apply, _jax_loss, optax.adamw(LR), mesh,
                                       axis="fsdp", data_axes=("dp", "fsdp"), donate=False)
    p, s = params, step.init_opt_state(params)
    losses = []
    for i in range(STEPS):
        toks = jnp.asarray(_tokens(i))
        p, s, loss = step(p, s, toks, toks)
        losses.append(float(loss))
    return init, losses, jax.tree.map(np.asarray, p)


def test_zero2_over_dp_and_fsdp_matches_reference():
    init, want_losses, want = _zero2_reference_dp()
    model = _port_model(0, init)
    params = {k: v.detach().clone() for k, v in model.state_dict().items()}
    mesh = DeviceMesh(["cpu"] * 4, (2, 2), ("dp", "fsdp"))
    apply = lambda p, x: torch.func.functional_call(model, p, (x,))
    step = tfsdp.make_zero2_train_step(apply, lm.loss_fn, lm.adamw(LR), mesh, axis="fsdp",
                                       data_axes=("dp", "fsdp"))
    opt = step.init_opt_state(params)
    losses = []
    for i in range(STEPS):
        t = torch.from_numpy(_tokens(i)).long()
        params, opt, loss = step(params, opt, t, t)
        losses.append(float(loss))
    np.testing.assert_allclose(losses, want_losses, rtol=LOSS_RTOL)
    _assert_params(params, convert.from_flax(want), "ZeRO-2 over (dp, fsdp)")
    # the optimizer state splits over fsdp (2), not over the 4 data ranks
    assert opt.shards["layers.0.attn.q_proj.weight"].shape == (2, 32, 64)


# -- ZeRO-2 with a comm hook -------------------------------------------------

HOOK_DIMS = (16, 32, 4)  # the reference's test_quant ZeRO-2 MLP: in, hidden, classes


def _hook_mlp_apply(p, x):
    """flax's Dense_0 -> relu -> Dense_1 on the reference's (in, out) kernels."""
    h = torch.relu(x @ p["Dense_0.kernel"] + p["Dense_0.bias"])
    return h @ p["Dense_1.kernel"] + p["Dense_1.bias"]


@functools.lru_cache(maxsize=None)
def _zero2_hook_reference(hooked):
    import flax.linen as fnn

    from pytorch_distributed_example_tpu.parallel.comm_hooks import (
        blockwise_quant_hook as jquant)

    Din, H, C = HOOK_DIMS

    class MLP(fnn.Module):
        @fnn.compact
        def __call__(self, x):
            x = fnn.relu(fnn.Dense(H)(x))
            return fnn.Dense(C)(x)

    model = MLP()
    params = model.init(jax.random.PRNGKey(0), jnp.zeros((1, Din)))
    gen = np.random.default_rng(0)
    x = gen.standard_normal((8, Din)).astype(np.float32)
    y = gen.integers(0, C, 8).astype(np.int32)
    mesh = init_device_mesh(("fsdp",), (4,), devices=jax.devices()[:4])
    opt = optax.sgd(0.05)
    step = jfsdp.make_zero2_train_step(
        model.apply, lambda lg, yy: optax.softmax_cross_entropy_with_integer_labels(
            lg, yy).mean(), opt, mesh, axis="fsdp", data_axes=("fsdp",),
        comm_hook=jquant(error_feedback=False) if hooked else None, donate=False)
    p, s = params, step.init_opt_state(params)
    losses = []
    for _ in range(STEPS):
        p, s, loss = step(p, s, x, y)
        losses.append(float(loss))
    flat = lambda tree: {f"{a}.{b}": np.asarray(v) for a, d in tree["params"].items()
                         for b, v in d.items()}
    return flat(jax.tree.map(np.asarray, params)), x, y, losses, flat(p)


@pytest.mark.parametrize("hooked", [False, True], ids=["stock", "blockwise_quant"])
def test_zero2_comm_hook_matches_reference(hooked):
    """ZeRO-2 with `blockwise_quant_hook(error_feedback=False)` (and
    without, its baseline) against the reference's, 3 SGD steps at 4
    ranks: the int8 wire's blocks are the reference's leaves' own, so the
    two agree to float32 rounding (rtol 1e-5 / atol 1e-6)."""
    init, x, y, want_losses, want = _zero2_hook_reference(hooked)
    params = {k: torch.tensor(v) for k, v in init.items()}
    mesh = DeviceMesh(["cpu"] * 4, (4,), ("fsdp",))
    step = tfsdp.make_zero2_train_step(
        _hook_mlp_apply, lambda lg, yy: torch.nn.functional.cross_entropy(lg, yy),
        functools.partial(torch.optim.SGD, lr=0.05), mesh, axis="fsdp", data_axes=("fsdp",),
        comm_hook=blockwise_quant_hook(error_feedback=False) if hooked else None)
    opt = step.init_opt_state(params)
    losses = []
    for _ in range(STEPS):
        params, opt, loss = step(params, opt, torch.tensor(x), torch.tensor(y).long())
        losses.append(float(loss))
    np.testing.assert_allclose(losses, want_losses, rtol=1e-5)
    for k, w in want.items():
        np.testing.assert_allclose(params[k].numpy(), w, rtol=1e-5, atol=1e-6, err_msg=k)


def test_zero2_takes_a_flat_hook():
    """A flat hook (`allreduce_hook`: the ranks' gradients packed into
    one (W, N) buffer) gives the stock ZeRO-2 step."""
    from pytorch_distributed_example_tpu_torch.parallel.comm_hooks import allreduce_hook

    init, x, y, _, _ = _zero2_hook_reference(False)
    mesh = DeviceMesh(["cpu"] * 4, (4,), ("fsdp",))
    runs = []
    for hook in (None, allreduce_hook):
        params = {k: torch.tensor(v) for k, v in init.items()}
        step = tfsdp.make_zero2_train_step(
            _hook_mlp_apply, lambda lg, yy: torch.nn.functional.cross_entropy(lg, yy),
            functools.partial(torch.optim.SGD, lr=0.05), mesh, axis="fsdp",
            data_axes=("fsdp",), comm_hook=hook)
        opt = step.init_opt_state(params)
        for _ in range(STEPS):
            params, opt, _ = step(params, opt, torch.tensor(x), torch.tensor(y).long())
        runs.append(params)
    for k in runs[0]:
        torch.testing.assert_close(runs[1][k], runs[0][k], rtol=1e-6, atol=1e-7)
