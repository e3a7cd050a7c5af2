"""Cases of `tests/test_torch_multiproc_cp_pp.py`: ring attention, Ulysses
and the pipeline schedules over a world-4 axis, each a function of
(mesh, pick) that runs in driver mode (a driver-mode mesh, `pick` keeping
every rank's rows) and as a rank of a multiproc gang (the gang's mesh,
`pick` keeping this process's rows). Results are {name: (kind, array)}
as in `tests/_torch_mp_collectives.py`, plus "rows1" (the rank dim is
dim 1: the interleaved schedule's (V, S, ...) chunks).

`skip_send` is the schedule-check gang: every rank shifts a row around the
pp ring and then all-reduces, but rank 1 skips its shift. No JAX here.
"""

import numpy as np
import torch

from pytorch_distributed_example_tpu_torch.mesh import DeviceMesh, init_device_mesh
from pytorch_distributed_example_tpu_torch.nn import functional as TF
from pytorch_distributed_example_tpu_torch.parallel import context_parallel as tcp
from pytorch_distributed_example_tpu_torch.parallel import pipeline as tpp
from pytorch_distributed_example_tpu_torch.types import ReduceOp

W = 4
B, L, H, D = 1, 4 * 16, 4, 16  # shards of 16 rows; H splits over W for Ulysses
RING = [(bk, causal) for bk in ("dense", "flash") for causal in (False, True)]
S, M, MB, F, V = 4, 6, 2, 16, 2  # stages, microbatches, rows a microbatch, width, chunks


def cp_inputs(seed):
    gen = np.random.default_rng(seed)
    return [gen.standard_normal((B, L, H, D)).astype(np.float32) for _ in range(4)]


def shard(x):
    """global (B, L, H, D) -> rank-stacked (W, B, L/W, H, D)."""
    return np.ascontiguousarray(x.reshape(B, W, L // W, H, D).transpose(1, 0, 2, 3, 4))


def _leaf(a):
    return torch.tensor(np.ascontiguousarray(a), requires_grad=True)


def ring_case(bk, causal, mesh, pick, counts):
    q, k, v, do = cp_inputs(10 + 2 * (bk == "flash") + causal)
    ts = [_leaf(pick(shard(x))) for x in (q, k, v)]
    with mesh:
        calls = counts.setdefault(f"ring-{bk}-{causal}", [])
        n0 = len(counts["_fwd"])
        o = tcp.ring_attention(*ts, causal=causal, block_kernel=bk, axis_name="sp")
        o.backward(torch.from_numpy(pick(shard(do))))
        calls.append(len(counts["_fwd"]) - n0)
    out = {"o": ("rows", o.detach().numpy())}
    for n, t in zip("qkv", ts):
        out["d" + n] = ("rows", t.grad.numpy())
    return out


def cp_global_case(mode, mesh):
    """make_cp_attention on global tensors: the same call in both modes;
    the gradients of a process's own shard add up over the processes."""
    q, k, v, do = cp_inputs(20 + (mode == "ulysses"))
    ts = [_leaf(x) for x in (q, k, v)]
    o = tcp.make_cp_attention(mesh, "sp", mode=mode, causal=True)(*ts)
    o.backward(torch.from_numpy(do))
    out = {"o": ("full", o.detach().numpy())}
    for n, t in zip("qkv", ts):
        out["d" + n] = ("sum", t.grad.numpy())
    return out


def stage_fn(p, x):
    return torch.tanh(x @ p["w"])


def loss_fn(y, t):
    return ((y - t) ** 2).mean()


def pipe_inputs(seed, n):
    gen = np.random.default_rng(seed)
    ws = np.stack([(gen.standard_normal((F, F)) * 0.3).astype(np.float32) for _ in range(n)])
    x = gen.standard_normal((M, MB, F)).astype(np.float32)
    tgt = gen.standard_normal((M, MB, F)).astype(np.float32)
    return ws, x, tgt


def gpipe_case(mesh, pick):
    ws, x, _ = pipe_inputs(1, S)
    p = {"w": _leaf(pick(ws))}
    y = tpp.make_pipeline_fn(stage_fn, mesh, axis_name="pp")(p, torch.tensor(x))
    (y ** 2).sum().backward()
    return {"y": ("full", y.detach().numpy()), "dw": ("rows", p["w"].grad.numpy())}


def interleaved_case(mesh, pick):
    ws, x, _ = pipe_inputs(2, V * S)
    chunks = ws.reshape(V, S, F, F)  # [v, i]: global stage v·S + i on device i
    local = pick(chunks.transpose(1, 0, 2, 3)).transpose(1, 0, 2, 3)  # (V, S or 1, F, F)
    p = {"w": _leaf(np.ascontiguousarray(local).reshape(-1, F, F))}
    y = tpp.make_pipeline_fn(stage_fn, mesh, axis_name="pp", virtual_stages=V)(
        p, torch.tensor(x))
    (y ** 2).sum().backward()
    return {"y": ("full", y.detach().numpy()),
            "dw": ("rows1", p["w"].grad.numpy().reshape(V, -1, F, F))}


def train_case(schedule, mesh, pick):
    ws, x, tgt = pipe_inputs(3, S)
    train = tpp.make_pipeline_train_fn(stage_fn, loss_fn, mesh, axis_name="pp",
                                       schedule=schedule)
    loss, grads = train({"w": torch.tensor(pick(ws))}, torch.tensor(x), torch.tensor(tgt))
    return {"loss": ("full", loss.detach().numpy()), "dw": ("rows", grads["w"].numpy())}


def run_all(sp, pp, pick):
    counts = {"_fwd": []}
    real = tcp._fwd

    def counted(*args, **kwargs):
        counts["_fwd"].append(1)
        return real(*args, **kwargs)

    tcp._fwd = counted
    try:
        out = {f"ring-{bk}-{'causal' if c else 'full'}": ring_case(bk, c, sp, pick, counts)
               for bk, c in RING}
    finally:
        tcp._fwd = real
    out["cp-ring"] = cp_global_case("ring", sp)
    out["cp-ulysses"] = cp_global_case("ulysses", sp)
    out["pp-gpipe"] = gpipe_case(pp, pick)
    out["pp-interleaved"] = interleaved_case(pp, pick)
    out["pp-1f1b"] = train_case("1f1b", pp, pick)
    out["pp-gpipe-train"] = train_case("gpipe", pp, pick)
    out["_flash_fwd_calls"] = {k: v for k, v in counts.items() if k.startswith("ring-flash")}
    return out


def driver():
    dev = ["cpu"] * W
    return run_all(DeviceMesh(dev, (W,), ("sp",)), DeviceMesh(dev, (S,), ("pp",)), lambda a: a)


def gang(rank, world, which="cases"):
    if which == "skip_send":
        return skip_send(rank, world)
    sp = init_device_mesh(("sp",), (world,))
    pp = init_device_mesh(("pp",), (world,))
    return run_all(sp, pp, lambda a: a[rank:rank + 1])


def skip_send(rank, world):
    """Rank 1 skips its ring shift: the schedule check names the divergence
    (every rank raises) instead of a hang."""
    from pytorch_distributed_example_tpu_torch.schedule import ScheduleMismatchError

    pp = init_device_mesh(("pp",), (world,))
    x = torch.full((1, 3), float(rank))
    ring = [(i, (i + 1) % world) for i in range(world)]
    try:
        with pp:
            if rank != 1:
                x = TF.ppermute(x, "pp", ring)
            TF.all_reduce(x, ReduceOp.SUM, "pp")
        return {"raised": None}
    except ScheduleMismatchError as e:
        return {"raised": str(e)}
