"""The port's multichip dry run against the reference's five parts, on the CPU.

`dryrun.dryrun_multichip(8, device="cpu")` runs every rank in driver mode;
the test rebuilds the reference's `__graft_entry__.dryrun_multichip(8)`
part by part with the JAX package's API on the conftest's 8 virtual CPU
devices, on the same numpy draws (`dryrun.draw_inputs`) and the reference's
flax inits carried across (`models.convert`). Tolerances (float32): the
sharded step's loss, ring attention and the MoE rtol 1e-5 / atol 1e-5,
the pipeline the reference's forward tolerance (rtol 1e-4 / atol 1e-5),
the all_reduce exact. Part 5's dropout masks
differ by design (torch generators against jax keys), so its loss is held
to the reference's with dropout off (`has_rng=False`), rtol 1e-5.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from pytorch_distributed_example_tpu import DistributedDataParallel as JDDP
from pytorch_distributed_example_tpu.mesh import init_device_mesh
from pytorch_distributed_example_tpu.models import ConvNet as JConvNet
from pytorch_distributed_example_tpu.models import transformer as jtr
from pytorch_distributed_example_tpu.parallel import (fully_shard, make_cp_attention, make_ep_moe,
                                                      make_pipeline_fn, stack_stage_params)
from pytorch_distributed_example_tpu_torch import distributed as tdist
from pytorch_distributed_example_tpu_torch import dryrun
from pytorch_distributed_example_tpu_torch.models import convert

N = 8
TOL = dict(rtol=1e-5, atol=1e-5)
PIPE_TOL = dict(rtol=1e-4, atol=1e-5)


def _mesh(names, shape):
    return init_device_mesh(names, shape, devices=jax.devices()[:int(np.prod(shape))])


def _xent(logits, y):
    return optax.softmax_cross_entropy_with_integer_labels(logits, y).mean()


@functools.lru_cache(maxsize=None)
def _reference():
    """The reference's five parts on `draw_inputs(8)`, and its inits."""
    d = dryrun.draw_inputs(N)
    dp, fsdp, tp = dryrun._factor_mesh(N)
    model = jtr.TransformerLM(jtr.TransformerConfig(**dryrun.LM_KW))
    toks = jnp.asarray(d["toks"], jnp.int32)
    params = model.init(jax.random.PRNGKey(0), toks)
    mod = fully_shard(model, params, _mesh(("dp", "fsdp", "tp"), (dp, fsdp, tp)), axis="fsdp",
                      rules=jtr.sharding_rules("tp", "fsdp"),
                      data_axes=("dp", "fsdp"))
    opt = optax.adamw(1e-3)
    step = mod.make_train_step(
        opt, lambda lg, y: _xent(lg[:, :-1], y[:, 1:]), donate=False)
    _, _, loss = step(mod.params, opt.init(mod.params), toks, toks)
    q = jnp.asarray(d["q"])
    o = make_cp_attention(_mesh(("sp",), (N,)), axis_name="sp", mode="ring", causal=True)(q, q, q)
    ymoe, aux = make_ep_moe(_mesh(("ep",), (N,)), "ep", capacity_factor=float(N))(
        *(jnp.asarray(d[k]) for k in ("xt", "wu", "wd", "rw")))
    pipe = make_pipeline_fn(lambda p, x: jnp.tanh(x @ p["w"]), _mesh(("pp",), (N,)), "pp")
    ypipe = pipe(stack_stage_params([{"w": jnp.asarray(w)} for w in d["ws"]]),
                 jnp.asarray(d["px"]))
    cparams = JConvNet().init(jax.random.PRNGKey(0), jnp.zeros((1, 28, 28, 1)))
    return (jax.tree.map(np.asarray, params), jax.tree.map(np.asarray, cparams),
            {"loss": float(loss), "ring": np.asarray(o), "moe_y": np.asarray(ymoe),
             "moe_aux": float(aux), "pipe": np.asarray(ypipe)})


@functools.lru_cache(maxsize=None)
def _port():
    params, cparams, _ = _reference()
    return dryrun.dryrun_multichip(N, device="cpu", lm_params=convert.from_flax(params),
                                   convnet_params=convert.convnet_from_flax(cparams))


def test_inputs_follow_the_reference_order_of_draws():
    d = dryrun.draw_inputs(N)
    gen = np.random.default_rng(0)
    np.testing.assert_array_equal(d["toks"], gen.integers(0, 128, (8, 32)))
    np.testing.assert_array_equal(d["q"], gen.standard_normal((1, 64, 2, 8)).astype(np.float32))
    assert dryrun._factor_mesh(8) == (2, 2, 2) and dryrun._factor_mesh(4) == (1, 2, 2)
    assert d["cy"].shape == (16,) and d["ws"].shape == (8, 16, 16)


@pytest.mark.parametrize("part", ["loss", "ring", "moe_y", "moe_aux", "pipe"])
def test_part_matches_reference(part):
    got, want = _port()[part], _reference()[2][part]
    tol = PIPE_TOL if part == "pipe" else TOL
    np.testing.assert_allclose(np.asarray(torch.as_tensor(got).detach()), want, **tol)


def test_all_reduce_is_exact():
    assert _port()["all_reduce"] == float(sum(range(N)))
    assert np.isfinite(float(_port()["ddp_loss"]))


def test_ddp_step_without_dropout_matches_reference(world):
    _, cparams, _ = _reference()
    d = dryrun.draw_inputs(N)
    jddp = JDDP(JConvNet(), cparams)
    opt = optax.sgd(0.01, momentum=0.5)
    _, _, want = jddp.make_train_step(opt, _xent)(
        jddp.params, opt.init(jddp.params), d["cx"], d["cy"].astype(np.int32))
    tdist.init_process_group(world_size=N, device="cpu")
    try:
        got = dryrun.ddp_step(N, d["cx"], d["cy"], "cpu", convert.convnet_from_flax(cparams),
                              has_rng=False)
    finally:
        tdist.destroy_process_group()
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)


def test_entry_runs_the_flagship_forward():
    fn, (params, toks) = dryrun.entry(device="cpu")
    out = fn(params, toks)
    assert out.shape == (2, 64, 256) and bool(torch.isfinite(out).all())


def test_without_a_card_the_dry_run_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is cuda:0")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dryrun.dryrun_multichip(N)
