"""The port's differentiable collectives, TP seams and `make_ep_moe` in
multiproc mode: gloo gangs of 2 and 4 processes on the CPU.

Each gang (one launch a world size, `tests/_torch_gang.py`) runs every case
of `tests/_torch_mp_collectives.py` as its rank: a process holds its own
rows (rank dims of size 1) inside its multiproc mesh, and the collectives
go through the c10d core to torch.distributed. Every process's value and
gradient are held to two things on the same numpy inputs: the port's own
driver mode (the ranks stacked on one device) and the reference's
`shard_map` form on the conftest's CPU devices. float32, sums in another
order: rtol 1e-5 (PRODUCT's log-abs-exp form 2e-5).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh, PartitionSpec as P

from pytorch_distributed_example_tpu._compat import shard_map_fn
from pytorch_distributed_example_tpu.nn import functional as JF
from pytorch_distributed_example_tpu.parallel import expert_parallel as JEP
from pytorch_distributed_example_tpu.parallel import tensor_parallel as JTP
from pytorch_distributed_example_tpu.types import ReduceOp as JOp
from pytorch_distributed_example_tpu.types import _PremulSum as JPremul
from tests import _torch_mp_collectives as cases
from tests._torch_gang import run_gang

WORLDS = (2, 4)
TOL = dict(rtol=1e-5, atol=1e-5)
PRODUCT_TOL = dict(rtol=2e-5, atol=2e-5)
MODULE = "tests._torch_mp_collectives"


@pytest.fixture(scope="module")
def gangs(tmp_path_factory):
    """Each world size's gang results, by rank."""
    out = {}
    for W in WORLDS:
        rcs, texts, results = run_gang(MODULE, tmp_path_factory.mktemp(f"w{W}"), W)
        for r, (rc, text) in enumerate(zip(rcs, texts)):
            assert rc == 0, f"world {W} rank {r} failed:\n{text}"
        out[W] = results
    return out


@pytest.fixture(scope="module")
def drivers():
    return {W: cases.driver(W) for W in WORLDS}


def _position(name, res, r):
    """The leading index of process r's rows in a stacked array."""
    if name.startswith("2d"):
        c = res[r]["_coord2"]
        return (slice(c[0], c[0] + 1), slice(c[1], c[1] + 1))
    return (slice(r, r + 1),)


def _check(name, res, want, tol):
    """Every process's outputs of case `name` against `want` ({output:
    (kind, stacked or whole array)})."""
    W = len(res)
    for k, (kind, w) in want.items():
        if kind == "sum":
            got = sum(res[r][name][k][1] for r in range(W))
            np.testing.assert_allclose(got, w, err_msg=f"{name} {k}", **tol)
            continue
        for r in range(W):
            gkind, got = res[r][name][k]
            assert gkind == kind, (name, k, gkind, kind)
            w_r = w[_position(name, res, r)] if kind == "rows" else w
            np.testing.assert_allclose(got, w_r, err_msg=f"{name} {k} rank {r}", **tol)


def _tol(name):
    return PRODUCT_TOL if name.endswith("PRODUCT") else TOL


# -- the reference ------------------------------------------------------------


def _jmesh(shape, names):
    return Mesh(np.array(jax.devices()[:int(np.prod(shape))]).reshape(shape), names)


def _vjp(f, args, ct):
    if ct is None:  # value only
        return np.asarray(f(*[jnp.asarray(a) for a in args])), None
    y, vjp = jax.vjp(f, *[jnp.asarray(a) for a in args])
    return np.asarray(y), [np.asarray(g) for g in vjp(jnp.asarray(ct, y.dtype))]


def _reference_collective(name, W, y_local):
    """The reference's op under shard_map over ("dp", W), stacked (W, ...),
    with the cotangent the port's case draws."""
    fn_name, kw, local = cases.COLLECTIVES[name]
    X, gen = cases.block_inputs(name, W, local)
    C = gen.standard_normal((W,) + tuple(y_local)).astype(np.float32)
    kw = cases.op_of(kw, JOp, JPremul)
    f = shard_map_fn(lambda x: getattr(JF, fn_name)(x, axis_name="dp", **kw),
                     mesh=_jmesh((W,), ("dp",)), in_specs=(P("dp"),), out_specs=P("dp"))
    flat = lambda a: a.reshape((-1,) + a.shape[2:])  # noqa: E731
    grad = name not in cases.VALUE_ONLY
    y, g = _vjp(f, (flat(X),), flat(C) if grad else None)
    out = {"y": ("rows", y.reshape((W,) + tuple(y_local)))}
    if grad:
        out["dx"] = ("rows", g[0].reshape(X.shape))
    return out


def _reference_2d(name, W, y_local):
    fn_name, kw, local, axis = cases.COLLECTIVES_2D[name]
    X, gen = cases.block_inputs(name, W, local)
    C = gen.standard_normal((2, W // 2) + tuple(y_local)).astype(np.float32)
    kw = cases.op_of(kw, JOp, JPremul)
    spec = P(("fsdp", "tp"))
    f = shard_map_fn(lambda x: getattr(JF, fn_name)(x, axis_name=axis, **kw),
                     mesh=_jmesh((2, W // 2), ("fsdp", "tp")), in_specs=(spec,), out_specs=spec)
    y, (g,) = _vjp(f, (X.reshape((-1,) + tuple(local[1:])),),
                   C.reshape((-1,) + tuple(y_local[1:])))
    return {"y": ("rows", y.reshape((2, W // 2) + tuple(y_local))),
            "dx": ("rows", g.reshape((2, W // 2) + tuple(local)))}


def _reference_ppermute(W):
    X, gen = cases.block_inputs(cases.PERMUTE, W, (4, 3))
    C = gen.standard_normal((W, 4, 3)).astype(np.float32)
    perm = [(i, (i + 1) % W) for i in range(W - 1)]
    f = shard_map_fn(lambda x: jax.lax.ppermute(x, "dp", perm), mesh=_jmesh((W,), ("dp",)),
                     in_specs=(P("dp"),), out_specs=P("dp"))
    y, (g,) = _vjp(f, (X.reshape(-1, 3),), C.reshape(-1, 3))
    return {"y": ("rows", y.reshape(W, 4, 3)), "dx": ("rows", g.reshape(W, 4, 3))}


def _reference_tp(name, T):
    a = cases.tp_inputs(name, T)
    mesh = _jmesh((T,), ("tp",))

    def run(fn, in_specs, out_spec, args):
        f = shard_map_fn(fn, mesh=mesh, in_specs=in_specs, out_specs=out_spec)
        return _vjp(f, args, a["ct"])

    cols = lambda w: cases._cols(w, T)  # noqa: E731
    rows = lambda w: cases._rows(w, T)  # noqa: E731
    if name == "tp-column":
        y, (dx, dw) = run(lambda x, w: JTP.column_parallel_matmul(x, w, "tp"),
                          (P(), P(None, "tp")), P(None, "tp"), (a["x"], a["w"]))
        return {"y": ("rows", y.reshape(6, T, 4).transpose(1, 0, 2)), "dx": ("full", dx),
                "dw": ("rows", cols(dw))}
    if name == "tp-row":
        y, (dx, dw) = run(lambda x, w: JTP.row_parallel_matmul(x, w, "tp"),
                          (P(None, "tp"), P("tp", None)), P(), (a["x"], a["w"]))
        return {"y": ("full", y), "dx": ("rows", dx.reshape(6, T, 2).transpose(1, 0, 2)),
                "dw": ("rows", rows(dw))}
    if name == "tp-mlp_block":
        y, (dx, dup, ddown) = run(lambda x, u, d: JTP.mlp_block_tp(x, u, d, "tp"),
                                  (P(), P(None, "tp"), P("tp", None)), P(),
                                  (a["x"], a["up"], a["down"]))
        return {"y": ("full", y), "dx": ("full", dx), "dup": ("rows", cols(dup)),
                "ddown": ("rows", rows(ddown))}
    if name == "tp-vocab_logits":
        y, (dh, demb) = run(lambda h, e: JTP.vocab_parallel_logits(h, e, "tp"),
                            (P(), P(None, "tp")), P(), (a["h"], a["emb"]))
        return {"y": ("full", y), "dh": ("full", dh), "demb": ("rows", cols(demb))}
    if name == "tp-gathered_matmul":
        y, (dx, dw) = run(lambda x, w: JTP.gathered_matmul(x, w, "tp"), (P("tp"), P()), P(),
                          (a["x"], a["w"]))
        return {"y": ("full", y), "dx": ("rows", dx.reshape(T, 2, 6)), "dw": ("full", dw)}
    targets = jnp.asarray(a["targets"].astype(np.int32))
    f = shard_map_fn(lambda lg, t: JTP.vocab_parallel_cross_entropy(lg, t, "tp"), mesh=mesh,
                     in_specs=(P(None, None, "tp"), P()), out_specs=P())
    y, (dl,) = _vjp(lambda lg: f(lg, targets), (a["logits"],), a["ct"])
    return {"y": ("full", y),
            "dlogits": ("rows", dl.reshape(2, 5, T, 4).transpose(2, 0, 1, 3))}


def _reference_ep(name, W):
    k = int(name[-1])
    a = cases.ep_inputs(k, W)
    jfn = JEP.make_ep_moe(_jmesh((W,), ("ep",)), "ep", capacity_factor=1.0, k=k)

    def objective(*args):
        y, aux = jfn(*args)
        return (y * jnp.asarray(a["ct"])).sum() + aux, (y, aux)

    (_, (y, aux)), grads = jax.value_and_grad(objective, argnums=(0, 1, 2, 3), has_aux=True)(
        *[jnp.asarray(a[n]) for n in ("x", "up", "down", "router")])
    out = {"y": ("full", np.asarray(y)), "aux": ("full", np.asarray(aux))}
    for n, g in zip(("dx", "dup", "ddown", "drouter"), grads):
        out[n] = ("sum", np.asarray(g))
    return out


# -- the tests ----------------------------------------------------------------

ALL = (list(cases.COLLECTIVES) + list(cases.COLLECTIVES_2D) + list(cases.REPLICA)
       + [cases.PERMUTE] + list(cases.TP) + list(cases.EP))


@pytest.mark.parametrize("W", WORLDS)
@pytest.mark.parametrize("name", ALL)
def test_gang_matches_driver_mode(gangs, drivers, name, W):
    _check(name, gangs[W], drivers[W][name], _tol(name))


REFERENCED = [n for n in ALL if n not in cases.REPLICA]


@pytest.mark.parametrize("W", WORLDS)
@pytest.mark.parametrize("name", REFERENCED)
def test_gang_matches_reference(gangs, drivers, name, W):
    y_local = drivers[W][name]["y"][1].shape
    if name in cases.COLLECTIVES:
        want = _reference_collective(name, W, y_local[1:])
    elif name in cases.COLLECTIVES_2D:
        want = _reference_2d(name, W, y_local[2:])
    elif name == cases.PERMUTE:
        want = _reference_ppermute(W)
    elif name in cases.TP:
        want = _reference_tp(name, W)
    else:
        want = _reference_ep(name, W)
    _check(name, gangs[W], want, _tol(name))
