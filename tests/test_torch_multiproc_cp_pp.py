"""Ring attention, Ulysses and the pipeline schedules in multiproc mode: a
gloo gang of 4 processes on the CPU, one rank a process
(`tests/_torch_mp_cp_pp.py`).

The ring (the dense block, and the flash block through the kernels' plain
versions), causal and not, with its shift the core's isend/irecv and its
causal skip reading the process's axis index; `make_cp_attention` ring and
Ulysses (the reshard an all_to_all of the sp group) on global tensors;
GPipe, interleaved (V 2), 1F1B and GPipe training at pp 4, a stage a
process. Every process's outputs and gradients are held to the port's
driver mode on the same numpy inputs and to the reference's `shard_map`
forms on the conftest's CPU devices: the ring's values `FWD_TOL` of
`test_torch_context_parallel.py` (rtol 1e-5), its gradients 2e-5; the
pipelines' `test_torch_pipeline.py` tolerances. One more gang runs under
`TDX_SCHEDULE_CHECK=1` with rank 1 skipping its ring shift: every rank
raises `ScheduleMismatchError` naming the divergent calls.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import PartitionSpec as P

from pytorch_distributed_example_tpu._compat import shard_map_fn
from pytorch_distributed_example_tpu.mesh import init_device_mesh
from pytorch_distributed_example_tpu.parallel import context_parallel as jcp
from pytorch_distributed_example_tpu.parallel import pipeline as jpp
from tests import _torch_mp_cp_pp as cases
from tests._torch_gang import run_gang

MODULE = "tests._torch_mp_cp_pp"
CP_TOL = dict(rtol=1e-5, atol=1e-5)
CP_GRAD_TOL = dict(rtol=2e-5, atol=2e-5)
PP_TOL = dict(rtol=1e-4, atol=1e-5)
PP_GRAD_TOL = dict(rtol=1e-4, atol=1e-6)


@pytest.fixture(scope="module")
def gang(tmp_path_factory):
    rcs, texts, results = run_gang(MODULE, tmp_path_factory.mktemp("cp_pp"), cases.W)
    for r, (rc, text) in enumerate(zip(rcs, texts)):
        assert rc == 0, f"rank {r} failed:\n{text}"
    return results


@pytest.fixture(scope="module")
def driver():
    return cases.driver()


def _check(name, res, want, tol, grad_tol):
    W = len(res)
    for k, (kind, w) in want.items():
        t = tol if k in ("o", "y", "loss") else grad_tol
        if kind == "sum":
            np.testing.assert_allclose(sum(res[r][name][k][1] for r in range(W)), w,
                                       err_msg=f"{name} {k}", **t)
            continue
        for r in range(W):
            gkind, got = res[r][name][k]
            assert gkind == kind
            w_r = {"rows": lambda a: a[r:r + 1], "rows1": lambda a: a[:, r:r + 1],
                   "full": lambda a: a}[kind](w)
            np.testing.assert_allclose(got, w_r, err_msg=f"{name} {k} rank {r}", **t)


def _tols(name):
    return (CP_TOL, CP_GRAD_TOL) if name.startswith(("ring", "cp")) else (PP_TOL, PP_GRAD_TOL)


# -- the reference ------------------------------------------------------------


def _jmesh(axis):
    return init_device_mesh((axis,), (cases.W,), devices=jax.devices()[:cases.W])


def _reference_ring(bk, causal):
    q, k, v, do = cases.cp_inputs(10 + 2 * (bk == "flash") + causal)
    spec = P(None, "sp", None, None)
    fn = jax.jit(shard_map_fn(functools.partial(jcp.ring_attention, axis_name="sp",
                                                causal=causal, block_kernel=bk),
                              mesh=_jmesh("sp").jax_mesh, in_specs=(spec,) * 3,
                              out_specs=spec))
    o, vjp = jax.vjp(fn, *(jnp.asarray(x) for x in (q, k, v)))
    grads = vjp(jnp.asarray(do))
    out = {"o": ("rows", cases.shard(np.asarray(o)))}
    for n, g in zip("qkv", grads):
        out["d" + n] = ("rows", cases.shard(np.asarray(g)))
    return out


def _reference_cp(mode):
    q, k, v, do = cases.cp_inputs(20 + (mode == "ulysses"))
    fn = jcp.make_cp_attention(_jmesh("sp"), axis_name="sp", mode=mode, causal=True)
    o, vjp = jax.vjp(fn, *(jnp.asarray(x) for x in (q, k, v)))
    out = {"o": ("full", np.asarray(o))}
    for n, g in zip("qkv", vjp(jnp.asarray(do))):
        out["d" + n] = ("sum", np.asarray(g))
    return out


def _jstage(p, x):
    return jnp.tanh(x @ p["w"])


def _jloss(y, t):
    return ((y - t) ** 2).mean()


def _reference_pipe(name):
    S, V = cases.S, cases.V
    if name == "pp-gpipe":
        ws, x, _ = cases.pipe_inputs(1, S)
        pipe = jpp.make_pipeline_fn(_jstage, _jmesh("pp"), axis_name="pp", jit=False)
        y, vjp = jax.vjp(lambda w: pipe({"w": w}, jnp.asarray(x)), jnp.asarray(ws))
        (dw,) = vjp(2 * y)
        return {"y": ("full", np.asarray(y)), "dw": ("rows", np.asarray(dw))}
    if name == "pp-interleaved":
        ws, x, _ = cases.pipe_inputs(2, V * S)
        pipe = jpp.make_pipeline_fn(_jstage, _jmesh("pp"), axis_name="pp", jit=False,
                                    virtual_stages=V)
        y, vjp = jax.vjp(lambda w: pipe({"w": w}, jnp.asarray(x)), jnp.asarray(ws))
        (dw,) = vjp(2 * y)
        return {"y": ("full", np.asarray(y)),
                "dw": ("rows1", np.asarray(dw).reshape(V, S, cases.F, cases.F))}
    ws, x, tgt = cases.pipe_inputs(3, S)
    schedule = "1f1b" if name == "pp-1f1b" else "gpipe"
    train = jpp.make_pipeline_train_fn(_jstage, _jloss, _jmesh("pp"), schedule=schedule)
    loss, grads = train({"w": jnp.asarray(ws)}, jnp.asarray(x), jnp.asarray(tgt))
    return {"loss": ("full", np.asarray(loss)), "dw": ("rows", np.asarray(grads["w"]))}


# -- the tests ----------------------------------------------------------------

RING = [f"ring-{bk}-{'causal' if c else 'full'}" for bk, c in cases.RING]
ALL = RING + ["cp-ring", "cp-ulysses", "pp-gpipe", "pp-interleaved", "pp-1f1b",
              "pp-gpipe-train"]


@pytest.mark.parametrize("name", ALL)
def test_gang_matches_driver_mode(gang, driver, name):
    _check(name, gang, driver[name], *_tols(name))


@pytest.mark.parametrize("name", ALL)
def test_gang_matches_reference(gang, name):
    if name.startswith("ring"):
        _, bk, c = name.split("-")
        want = _reference_ring(bk, c == "causal")
    elif name.startswith("cp"):
        want = _reference_cp(name.split("-")[1])
    else:
        want = _reference_pipe(name)
    _check(name, gang, want, *_tols(name))


def test_causal_ring_skips_by_the_process_axis_index(gang, driver):
    """Rank r runs the flash forward on r + 1 of the W ring steps when
    causal, on all W otherwise; driver mode folds the live ranks into one
    launch a step (W)."""
    for r, res in enumerate(gang):
        assert res["_flash_fwd_calls"] == {"ring-flash-False": [cases.W],
                                           "ring-flash-True": [r + 1]}
    assert driver["_flash_fwd_calls"]["ring-flash-True"] == [cases.W]


def test_schedule_check_names_a_skipped_send(tmp_path):
    rcs, texts, results = run_gang(MODULE, tmp_path, cases.W, extra_env={
        "TDX_SCHEDULE_CHECK": "1", "TDX_SCHEDULE_CHECK_EVERY": "1",
        "TDX_SCHEDULE_CHECK_TIMEOUT_S": "20"}, args=("skip_send",))
    for r, (rc, text) in enumerate(zip(rcs, texts)):
        assert rc == 0, f"rank {r} failed:\n{text}"
        msg = results[r]["raised"]
        assert msg is not None, f"rank {r} saw no divergence"
        assert "permute" in msg and "all_reduce" in msg, msg
