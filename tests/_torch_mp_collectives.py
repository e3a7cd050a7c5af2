"""Cases of `tests/test_torch_multiproc_collectives.py`: the port's
differentiable collectives, TP seams and `make_ep_moe`, each a function of
(W, pick) that runs in driver mode (`pick` keeps every rank's rows) and in
a multiproc gang (`pick` keeps this process's rows, inside its mesh).

A case returns {name: (kind, array)}: "rows" arrays are rank-stacked (the
mesh's dims lead; a process returns its own, of size 1), "full" arrays
are every process's whole value, "sum" arrays add up over the processes
to driver mode's (the gradients of a process's own experts and tokens).
Inputs come from numpy seeds. No JAX here: the test holds the results to
the reference.
"""

import numpy as np
import torch

from pytorch_distributed_example_tpu_torch import distributed as dist
from pytorch_distributed_example_tpu_torch.mesh import DeviceMesh, init_device_mesh
from pytorch_distributed_example_tpu_torch.nn import functional as TF
from pytorch_distributed_example_tpu_torch.parallel import expert_parallel as TEP
from pytorch_distributed_example_tpu_torch.parallel import tensor_parallel as TTP
from pytorch_distributed_example_tpu_torch.types import ReduceOp as TOp
from pytorch_distributed_example_tpu_torch.types import _PremulSum as TPremul

# name: (function, keyword arguments, a rank's block shape); the function
# is called as F.<fn>(x, **kw, axis_name) in both packages
COLLECTIVES = {
    "all_reduce-SUM": ("all_reduce", dict(op="SUM"), (4, 3)),
    "all_reduce-AVG": ("all_reduce", dict(op="AVG"), (4, 3)),
    "all_reduce-PREMUL_SUM": ("all_reduce", dict(op="PREMUL_SUM"), (4, 3)),
    "all_reduce-PRODUCT": ("all_reduce", dict(op="PRODUCT"), (4, 3)),
    "all_reduce-MAX": ("all_reduce", dict(op="MAX"), (4, 3)),
    "all_reduce-MIN": ("all_reduce", dict(op="MIN"), (4, 3)),
    "all_gather-0": ("all_gather", dict(axis=0), (4, 3)),
    "all_gather-1": ("all_gather", dict(axis=1), (4, 3)),
    "all_gather-untiled": ("all_gather", dict(axis=1, tiled=False), (4, 3)),
    "reduce_scatter-0": ("reduce_scatter", dict(axis=0), (8, 3)),
    "reduce_scatter-1": ("reduce_scatter", dict(axis=1), (2, 8)),
    "all_to_all-0-1": ("all_to_all", dict(split_axis=0, concat_axis=1), (8, 3)),
    "all_to_all-1-0": ("all_to_all", dict(split_axis=1, concat_axis=0), (2, 8)),
    "all_to_all_single": ("all_to_all_single", dict(), (8, 3)),
    "broadcast": ("broadcast", dict(src=1), (4, 3)),
    "gather": ("gather", dict(dst=1, axis=0), (4, 3)),
    "scatter": ("scatter", dict(src=1, axis=0), (8, 3)),
    "reduce": ("reduce", dict(dst=1, op="SUM"), (4, 3)),
}
VALUE_ONLY = ("all_reduce-MAX", "all_reduce-MIN")
# over one axis of a ("fsdp", "tp") mesh of (2, W/2)
COLLECTIVES_2D = {
    "2d-all_reduce-tp": ("all_reduce", dict(op="SUM"), (4, 3), "tp"),
    "2d-all_gather-tp": ("all_gather", dict(axis=1), (4, 3), "tp"),
    "2d-reduce_scatter-fsdp": ("reduce_scatter", dict(axis=0), (8, 3), "fsdp"),
    "2d-all_to_all-tp": ("all_to_all", dict(split_axis=0, concat_axis=1), (8, 3), "tp"),
}
# the port's own forms (no reference counterpart): against driver mode
REPLICA = ("replica-all_reduce-AVG", "replica-all_gather-1", "replicate",
           "rank_all_reduce-SUM", "rank_all_reduce-AVG")
TP = ("tp-column", "tp-row", "tp-mlp_block", "tp-vocab_logits", "tp-gathered_matmul",
      "tp-vocab_ce")
EP = ("ep-k1", "ep-k2")
PERMUTE = "ppermute-ring"


def op_of(kw, Op, Premul):
    """The keyword arguments with the op resolved in package (Op, Premul)."""
    kw = dict(kw)
    if "op" in kw:
        kw["op"] = Premul(0.25) if kw["op"] == "PREMUL_SUM" else getattr(Op, kw["op"])
    return kw


def block_inputs(name, W, local):
    """(X (W, *local), cotangent seed) of a case."""
    gen = np.random.default_rng(sum(map(ord, name)) + 7 * W)
    X = gen.standard_normal((W,) + tuple(local)).astype(np.float32)
    if name.endswith("PRODUCT"):
        X[1, 1, 1] = 0.0  # a zero factor: value and gradient 0 there
    return X, gen


def _leaf(a):
    return torch.tensor(np.ascontiguousarray(a), requires_grad=True)


def _run(fn, x, ct_gen, grad=True):
    """(y, dx) of fn at x for the cotangent C = ct_gen(y.shape)."""
    x = _leaf(x)
    y = fn(x)
    out = {"y": ("rows", y.detach().numpy())}
    if grad:
        y.backward(torch.from_numpy(ct_gen(tuple(y.shape))))
        out["dx"] = ("rows", x.grad.numpy())
    return out


def _ct(gen, W):
    """A cotangent for a rank-stacked output: drawn for every rank, picked."""
    def make(stacked_shape):
        return gen.standard_normal(stacked_shape).astype(np.float32)
    return make


def collective(name, W, pick, ndims=1):
    fn_name, kw, local = COLLECTIVES[name]
    X, gen = block_inputs(name, W, local)
    kw = op_of(kw, TOp, TPremul)
    C = None

    def ct(shape):  # the whole stacked cotangent, then this process's rows
        nonlocal C
        if C is None:
            C = gen.standard_normal((W,) + tuple(shape[1:])).astype(np.float32)
        return np.ascontiguousarray(pick(C))

    return _run(lambda x: getattr(TF, fn_name)(x, axis_name="dp", **kw), pick(X), ct,
                name not in VALUE_ONLY)


def collective_2d(name, W, pick):
    fn_name, kw, local, axis = COLLECTIVES_2D[name]
    X, gen = block_inputs(name, W, local)
    X = X.reshape((2, W // 2) + tuple(local))
    kw = op_of(kw, TOp, TPremul)
    C = None

    def ct(shape):
        nonlocal C
        if C is None:
            C = gen.standard_normal((2, W // 2) + tuple(shape[2:])).astype(np.float32)
        return np.ascontiguousarray(pick(C, 2))

    return _run(lambda x: getattr(TF, fn_name)(x, axis_name=axis, axes=("fsdp", "tp"), **kw),
                pick(X, 2), ct)


def replica(name, W, pick):
    X, gen = block_inputs(name, W, (4, 3))
    x = _leaf(pick(X))
    if name == "replica-all_reduce-AVG":
        y = TF.all_reduce(x, TOp.AVG, "dp", replica=True)
    elif name == "replica-all_gather-1":
        y = TF.all_gather(x, "dp", 1, replica=True)
    elif name == "replicate":  # every rank's replica of one value, scaled by its rank
        v = _leaf(X[0])
        scale = torch.from_numpy(pick(np.arange(1, W + 1, dtype=np.float32)))
        y = TF.replicate(v, "dp", W) * scale[:, None, None]
        y.backward(torch.from_numpy(pick(gen.standard_normal((W, 4, 3)).astype(np.float32))))
        return {"y": ("rows", y.detach().numpy()), "dv": ("full", v.grad.numpy())}
    else:  # rank_all_reduce inside the rank vmap of the DDP step's form
        op = name.rsplit("-", 1)[1]
        with DeviceMesh.from_group(dist._resolve(None), TF.RANKS) if x.shape[0] == 1 \
                else DeviceMesh(["cpu"] * W, (W,), (TF.RANKS,)):
            y = torch.func.vmap(lambda r: TF.rank_all_reduce((r * r).sum(0), op))(x)
        out = {"y": ("rows", y.detach().numpy())}
        y.backward(torch.from_numpy(pick(gen.standard_normal((W, 3)).astype(np.float32))))
        out["dx"] = ("rows", x.grad.numpy())
        return out
    y.backward(torch.from_numpy(gen.standard_normal(tuple(y.shape)).astype(np.float32)))
    return {"y": ("full", y.detach().numpy()), "dx": ("rows", x.grad.numpy())}


def ppermute(W, pick):
    X, gen = block_inputs(PERMUTE, W, (4, 3))
    perm = [(i, (i + 1) % W) for i in range(W - 1)]  # the last rank sends nothing
    C = gen.standard_normal((W, 4, 3)).astype(np.float32)
    return _run(lambda x: TF.ppermute(x, "dp", perm), pick(X),
                lambda shape: np.ascontiguousarray(pick(C)))


# -- the TP seams over a ("tp", W) axis -------------------------------------


def _cols(w, T):  # (in, out) -> (T, in, out/T): the ranks' column blocks
    return w.reshape(w.shape[0], T, -1).transpose(1, 0, 2)


def _rows(w, T):  # (in, out) -> (T, in/T, out)
    return w.reshape(T, -1, w.shape[1])


def tp_inputs(name, T):
    gen = np.random.default_rng(sum(map(ord, name)) + T)
    f = lambda *s: gen.standard_normal(s).astype(np.float32)  # noqa: E731
    if name == "tp-column":
        return dict(x=f(6, 8), w=f(8, 4 * T), ct=f(6, 4 * T))
    if name == "tp-row":
        return dict(x=f(6, 2 * T), w=f(2 * T, 5), ct=f(6, 5))
    if name == "tp-mlp_block":
        return dict(x=f(6, 8), up=f(8, 4 * T), down=f(4 * T, 8), ct=f(6, 8))
    if name == "tp-vocab_logits":
        return dict(h=f(6, 8), emb=f(8, 5 * T), ct=f(6, 5 * T))
    if name == "tp-gathered_matmul":
        return dict(x=f(2 * T, 6), w=f(6, 3), ct=f(2 * T, 3))
    logits = f(2, 5, 4 * T) * 3
    targets = gen.integers(0, 4 * T, (2, 5)).astype(np.int64)
    targets[0, 1] = -100  # ignored
    return dict(logits=logits, targets=targets, ct=f(2, 5))


def tp_case(name, T, pick):
    a = tp_inputs(name, T)
    ct = a["ct"]
    if name == "tp-column":
        x, w = _leaf(a["x"]), _leaf(pick(_cols(a["w"], T)))
        y = TTP.column_parallel_matmul(x, w, "tp")  # (T, 6, 4)
        y.backward(torch.from_numpy(pick(ct.reshape(6, T, 4).transpose(1, 0, 2).copy())))
        return {"y": ("rows", y.detach().numpy()), "dx": ("full", x.grad.numpy()),
                "dw": ("rows", w.grad.numpy())}
    if name == "tp-row":
        x = _leaf(pick(a["x"].reshape(6, T, 2).transpose(1, 0, 2)))
        w = _leaf(pick(_rows(a["w"], T)))
        y = TTP.row_parallel_matmul(x, w, "tp")
        y.backward(torch.from_numpy(ct))
        return {"y": ("full", y.detach().numpy()), "dx": ("rows", x.grad.numpy()),
                "dw": ("rows", w.grad.numpy())}
    if name == "tp-mlp_block":
        x, up, down = _leaf(a["x"]), _leaf(pick(_cols(a["up"], T))), _leaf(
            pick(_rows(a["down"], T)))
        y = TTP.mlp_block_tp(x, up, down, "tp")
        y.backward(torch.from_numpy(ct))
        return {"y": ("full", y.detach().numpy()), "dx": ("full", x.grad.numpy()),
                "dup": ("rows", up.grad.numpy()), "ddown": ("rows", down.grad.numpy())}
    if name == "tp-vocab_logits":
        h, emb = _leaf(a["h"]), _leaf(pick(_cols(a["emb"], T)))
        y = TTP.vocab_parallel_logits(h, emb, "tp")
        y.backward(torch.from_numpy(ct))
        return {"y": ("full", y.detach().numpy()), "dh": ("full", h.grad.numpy()),
                "demb": ("rows", emb.grad.numpy())}
    if name == "tp-gathered_matmul":
        x, w = _leaf(pick(a["x"].reshape(T, 2, 6))), _leaf(a["w"])
        y = TTP.gathered_matmul(x, w, "tp")
        y.backward(torch.from_numpy(ct))
        return {"y": ("full", y.detach().numpy()), "dx": ("rows", x.grad.numpy()),
                "dw": ("full", w.grad.numpy())}
    lg = _leaf(pick(a["logits"].reshape(2, 5, T, 4).transpose(2, 0, 1, 3)))
    y = TTP.vocab_parallel_cross_entropy(lg, torch.from_numpy(a["targets"]), "tp")
    y.backward(torch.from_numpy(ct))
    return {"y": ("full", y.detach().numpy()), "dlogits": ("rows", lg.grad.numpy())}


# -- make_ep_moe over ("ep", W) ---------------------------------------------

EP_SHAPE = dict(T=32, D=8, F=12, E=4)


def ep_inputs(k, W):
    gen = np.random.default_rng(40 + k + W)
    T, D, F, E = (EP_SHAPE[c] for c in "TDFE")
    return dict(x=gen.standard_normal((T, D)).astype(np.float32),
                up=(gen.standard_normal((E, D, F)) / np.sqrt(D)).astype(np.float32),
                down=(gen.standard_normal((E, F, D)) / np.sqrt(F)).astype(np.float32),
                router=gen.standard_normal((D, E)).astype(np.float32),
                ct=gen.standard_normal((T, D)).astype(np.float32))


def ep_case(name, W, mesh):
    k = int(name[-1])
    a = ep_inputs(k, W)
    leaves = [_leaf(a[n]) for n in ("x", "up", "down", "router")]
    y, aux = TEP.make_ep_moe(mesh, "ep", capacity_factor=1.0, k=k)(*leaves)
    ((y * torch.from_numpy(a["ct"])).sum() + aux).backward()
    out = {"y": ("full", y.detach().numpy()), "aux": ("full", aux.detach().numpy())}
    for n, t in zip(("dx", "dup", "ddown", "drouter"), leaves):
        out[n] = ("sum", t.grad.numpy())
    return out


# -- both modes ---------------------------------------------------------------


def run_all(W, mesh_1d, mesh_2d, mesh_ep, pick_1d, pick_2d):
    out = {}
    with mesh_1d:
        for name in COLLECTIVES:
            out[name] = collective(name, W, pick_1d)
        for name in REPLICA:
            out[name] = replica(name, W, pick_1d)
        out[PERMUTE] = ppermute(W, pick_1d)
    with mesh_2d:
        for name in COLLECTIVES_2D:
            out[name] = collective_2d(name, W, pick_2d)
    tp_mesh = mesh_1d  # the same ranks, the axis named "tp"
    with tp_mesh_named(tp_mesh, "tp"):
        for name in TP:
            out[name] = tp_case(name, W, pick_1d)
    for name in EP:
        out[name] = ep_case(name, W, mesh_ep)
    return out


def tp_mesh_named(mesh, name):
    """The 1-D mesh's ranks under axis `name` (driver mode: a driver mesh)."""
    if not mesh.multiproc:
        return DeviceMesh(mesh.device_list(), mesh.shape, (name,))
    return DeviceMesh.from_group(mesh.get_group(mesh.axis_names[0]), name)


def driver(W):
    """Every case in driver mode on the CPU."""
    dev = ["cpu"] * W
    return run_all(W, DeviceMesh(dev, (W,), ("dp",)),
                   DeviceMesh(dev, (2, W // 2), ("fsdp", "tp")),
                   DeviceMesh(dev, (W,), ("ep",)), lambda a, n=1: a, lambda a, n=2: a)


def gang(rank, world):
    """Every case as this process's rank of a multiproc gang."""
    m1 = init_device_mesh(("dp",), (world,))
    m2 = init_device_mesh(("fsdp", "tp"), (2, world // 2))
    mep = init_device_mesh(("ep",), (world,))
    c2 = m2.get_coordinate()

    def pick_1d(a, n=1):
        return a[rank:rank + 1]

    def pick_2d(a, n=2):
        return a[c2[0]:c2[0] + 1, c2[1]:c2[1] + 1]

    out = run_all(world, m1, m2, mep, pick_1d, pick_2d)
    out["_coord2"] = c2
    return out
