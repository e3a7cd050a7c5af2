"""The port's sharded trainer in multiproc mode: a gloo gang of 4 processes
on the CPU, one rank a process (`tests/_torch_mp_fsdp.py`).

The TransformerLM's FSDP step (`fully_shard` with the reference's rules,
`stacked_forward` over the mesh) over ("fsdp", "tp") (2, 2), dense and
with the MoE (4 experts, top-1: each process gathers the global batch's
tokens to route them; SGD, whose update keeps the gradients' float32
rounding in proportion where AdamW's first step amplifies it at eps),
and over ("dp", "fsdp", "tp") (2, 2, 1), 8 rows a step (the reference's
own 3-D step is wrong at one row a data rank), two AdamW steps; ZeRO-2 with the
block-quantized comm hook; a module on its gathered params; DTensor's
collectives. Each process's losses and gathered params are held to the
port's driver mode on the same converted params and tokens, and the
trainer's and ZeRO-2's to the reference's `fully_shard` /
`make_zero2_train_step` on the conftest's CPU devices: losses rtol 1e-5,
params rtol 1e-4 / atol 1e-6 (`PARAM_TOL` of `test_torch_fsdp.py`, with its
allowance for entries whose gradient sits at AdamW's eps).
"""

import pickle

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

from pytorch_distributed_example_tpu.mesh import init_device_mesh
from pytorch_distributed_example_tpu.models import transformer as jtr
from pytorch_distributed_example_tpu.parallel import fsdp as jfsdp
from pytorch_distributed_example_tpu.parallel.comm_hooks import blockwise_quant_hook as jquant
from pytorch_distributed_example_tpu_torch.models import convert
from tests import _torch_mp_fsdp as cases
from tests._torch_gang import run_gang

LOSS_RTOL = 1e-5
PARAM_TOL = dict(rtol=1e-4, atol=1e-6)
AMPLIFIED = 2


def _jax_loss(logits, y):
    return optax.softmax_cross_entropy_with_integer_labels(logits[:, :-1], y[:, 1:]).mean()


def _reference_lm(init_params, key):
    shape, names, experts = cases.MESHES[key]
    model = jtr.TransformerLM(jtr.TransformerConfig(n_experts=experts, **cases.KW))
    mesh = init_device_mesh(names, shape, devices=jax.devices()[:cases.W])
    data = tuple(a for a in ("dp", "fsdp") if a in names)
    mod = jfsdp.fully_shard(model, init_params, mesh, axis="fsdp",
                            rules=jtr.sharding_rules("tp", "fsdp"), data_axes=data)
    opt = optax.sgd(cases.MOE_LR) if experts else optax.adamw(cases.LR)
    step = mod.make_train_step(opt, _jax_loss, donate=False)
    p, s = mod.params, opt.init(mod.params)
    losses = []
    for i in range(cases.STEPS):
        toks = jnp.asarray(cases.tokens(i))
        p, s, loss = step(p, s, toks, toks)
        losses.append(float(loss))
    return np.array(losses), convert.from_flax(jax.tree.map(np.asarray, p))


def _reference_zero2(init_tree):
    Din, H, C = cases.HOOK_DIMS

    class MLP(fnn.Module):
        @fnn.compact
        def __call__(self, x):
            x = fnn.relu(fnn.Dense(H)(x))
            return fnn.Dense(C)(x)

    model = MLP()
    x, y = cases.hook_batch()
    mesh = init_device_mesh(("fsdp",), (cases.W,), devices=jax.devices()[:cases.W])
    step = jfsdp.make_zero2_train_step(
        model.apply, lambda lg, yy: optax.softmax_cross_entropy_with_integer_labels(
            lg, yy).mean(), optax.sgd(cases.HOOK_LR), mesh, axis="fsdp", data_axes=("fsdp",),
        comm_hook=jquant(error_feedback=False), donate=False)
    p, s = init_tree, step.init_opt_state(init_tree)
    losses = []
    for _ in range(cases.STEPS):
        p, s, loss = step(p, s, x, y)
        losses.append(float(loss))
    flat = {f"{a}.{b}": np.asarray(v) for a, d in p["params"].items() for b, v in d.items()}
    return np.array(losses), flat


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """(inputs, the reference's results, driver mode's, the gang's by rank)."""
    tmp = tmp_path_factory.mktemp("fsdp")
    inits = {}
    for experts in (0, 4):
        model = jtr.TransformerLM(jtr.TransformerConfig(n_experts=experts, **cases.KW))
        inits[experts] = jax.jit(model.init)(jax.random.PRNGKey(0),
                                             jnp.asarray(cases.tokens(0)))
    Din, H, C = cases.HOOK_DIMS
    hook_init = {"params": {
        "Dense_0": {"kernel": jax.random.normal(jax.random.PRNGKey(1), (Din, H)) / 4,
                    "bias": jnp.zeros(H)},
        "Dense_1": {"kernel": jax.random.normal(jax.random.PRNGKey(2), (H, C)) / 6,
                    "bias": jnp.zeros(C)}}}
    inputs = {"lm": jax.tree.map(np.asarray, inits[0]),
              "lm_moe": jax.tree.map(np.asarray, inits[4]),
              "hook": {f"{a}.{b}": np.asarray(v) for a, d in hook_init["params"].items()
                       for b, v in d.items()}}
    path = tmp / "inputs.pkl"
    with open(path, "wb") as f:
        pickle.dump(inputs, f)
    rcs, texts, gang = run_gang("tests._torch_mp_fsdp", tmp, cases.W, args=(str(path),),
                                timeout=240)
    for r, (rc, text) in enumerate(zip(rcs, texts)):
        assert rc == 0, f"rank {r} failed:\n{text}"
    reference = {key: _reference_lm(inits[cases.MESHES[key][2]], key) for key in cases.MESHES}
    reference["zero2_hook"] = _reference_zero2(hook_init)
    return inputs, reference, cases.run_all(inputs, False), gang


def _assert_params(got, want_state, what):
    assert set(got) == set(want_state)
    for name, want in want_state.items():
        want = np.asarray(want)
        diff = np.abs(np.asarray(got[name]) - want)
        outside = diff > PARAM_TOL["atol"] + PARAM_TOL["rtol"] * np.abs(want)
        assert outside.sum() <= AMPLIFIED and diff.max() <= cases.STEPS * cases.LR * 10, (
            f"{what}: {name}: {outside.sum()} entries outside rtol 1e-4 / atol 1e-6, "
            f"max |diff| {diff.max():.3e}")


@pytest.mark.parametrize("key", list(cases.MESHES))
def test_trainer_gang_matches_driver_mode(run, key):
    _, _, driver, gang = run
    for r, res in enumerate(gang):
        np.testing.assert_allclose(res[key]["losses"], driver[key]["losses"], rtol=LOSS_RTOL)
        _assert_params(res[key]["params"], driver[key]["params"], f"{key} rank {r}")


@pytest.mark.parametrize("key", list(cases.MESHES))
def test_trainer_gang_matches_reference(run, key):
    _, reference, _, gang = run
    want_losses, want = reference[key]
    for r, res in enumerate(gang):
        np.testing.assert_allclose(res[key]["losses"], want_losses, rtol=LOSS_RTOL)
        _assert_params(res[key]["params"], want, f"{key} rank {r} vs reference")


@pytest.mark.parametrize("key", list(cases.MESHES))
def test_trainer_gang_holds_its_own_shards(run, key):
    """Every rank dim of a process's local is 1, and the local is its 1/n
    of the driver-mode stack's shard layout."""
    _, _, driver, gang = run
    shape = cases.MESHES[key][0]
    q = gang[0][key]["local_shapes"]["layers.0.attn.q_proj.weight"]
    assert q[:len(shape)] == (1,) * len(shape)
    assert q == (1,) * len(shape) + tuple(driver[key]["local_shapes"][
        "layers.0.attn.q_proj.weight"][len(shape):])


def test_zero2_hook_gang_matches_driver_mode_and_reference(run):
    _, reference, driver, gang = run
    want_losses, want = reference["zero2_hook"]
    for r, res in enumerate(gang):
        got = res["zero2_hook"]
        assert got["shard_rows"] == 1 and driver["zero2_hook"]["shard_rows"] == cases.W
        np.testing.assert_allclose(got["losses"], driver["zero2_hook"]["losses"], rtol=1e-5)
        np.testing.assert_allclose(got["losses"], want_losses, rtol=1e-5)
        for k, w in want.items():
            np.testing.assert_allclose(got["params"][k], driver["zero2_hook"]["params"][k],
                                       rtol=1e-5, atol=1e-6, err_msg=k)
            np.testing.assert_allclose(got["params"][k], w, rtol=1e-5, atol=1e-6, err_msg=k)


def test_gathered_module_gang_matches_driver_mode(run):
    _, _, driver, gang = run
    for res in gang:
        np.testing.assert_allclose(res["generic"]["losses"], driver["generic"]["losses"],
                                   rtol=1e-6)
        for k, w in driver["generic"]["params"].items():
            np.testing.assert_allclose(res["generic"]["params"][k], w, rtol=1e-6, atol=1e-7)


def test_dtensor_gang_matches_driver_mode(run):
    _, _, driver, gang = run
    want = driver["dtensor"]
    for res in gang:
        got = res["dtensor"]
        for k in ("full", "redistributed", "sum"):
            np.testing.assert_array_equal(got[k], want[k])
        assert got["placements"] == want["placements"] and got["shape"] == want["shape"]
