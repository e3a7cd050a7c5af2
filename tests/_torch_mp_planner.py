"""Cases of `tests/test_torch_planner_traced.py` and `tests/test_torch_p2p.py`
that run as ranks of a gloo gang on the CPU (`tests/_torch_mp_worker.py`):

* "prepare": `plan.traced.prepare` with a per-rank `TDX_PLANNER_FORCE`
  ("-" for none): the agreed entry, or the `ProgramScheduleMismatchError`
  text;
* "executor": the eager planner over the p2p plane (`plan.maybe_lower`'s
  multiproc half): all_reduce forced to each algorithm, twice (bitwise
  re-execution), beside the stock gloo all_reduce; a ring all_gather and
  reduce_scatter; `TDX_TOPOLOGY` gives two hosts so `hier` is a
  candidate. Rank 0's choice is agreed once a (op, size bucket) for the
  life of the group, so each algorithm gets a payload of its own bucket;
* "p2p": send/recv (float32, bf16, int64), recv(src=None), isend/irecv,
  batch_isend_irecv, the object lists and `permute` rows, with the
  plane's frame counts (the store path when `TDX_P2P_PLANE=0`).

No JAX here.
"""

import os

import torch

import pytorch_distributed_example_tpu_torch as tdx
from pytorch_distributed_example_tpu_torch import distributed as dist
from pytorch_distributed_example_tpu_torch import plan
from pytorch_distributed_example_tpu_torch.plan import traced
from pytorch_distributed_example_tpu_torch.schedule import ProgramScheduleMismatchError
from pytorch_distributed_example_tpu_torch.tensor import DistTensor

SIZES = (37, 300, 1100)  # one size bucket each: 1, 4 and 16 KiB


def _prepare(rank, forces):
    os.environ["TDX_COLLECTIVE_PLANNER"] = "1"
    f = forces.split(",")[rank]
    if f != "-":
        os.environ["TDX_PLANNER_FORCE"] = f
    pg = dist._get_default_group()
    try:
        traced.prepare(pg, [("all_reduce", 256, "avg")], timeout=20.0)
        return {"agreed": traced.lookup("all_reduce", 256, "avg")}
    except ProgramScheduleMismatchError as e:
        return {"mismatch": str(e)}


def _executor(rank, world, algs):
    os.environ["TDX_PLANNER_PROBE_CACHE"] = ""
    os.environ["TDX_TOPOLOGY"] = ",".join(str(r * 2 // world) for r in range(world))
    pg = dist._get_default_group()
    g = torch.Generator().manual_seed(100 + rank)
    res = {}

    def reduce(x, on):
        plan.enable_for_group(pg, on)
        plan.reset_group(pg)
        dt = DistTensor.wrap(x.clone(), pg)
        tdx.all_reduce(dt)
        return dt.tensor[0].clone()

    for alg, n in zip(algs.split(","), SIZES):
        x = torch.randn(1, n, generator=g)
        os.environ["TDX_PLANNER_FORCE"] = alg
        res[alg] = {"x": x[0].clone(), "stock": reduce(x, False),
                    "planned": (reduce(x, True), reduce(x, True)),
                    "choice": plan.planner_for_group(pg).last_choice}
    x = torch.randn(1, SIZES[0], generator=g)
    res["x"] = x[0].clone()
    os.environ["TDX_PLANNER_FORCE"] = "ring"
    plan.enable_for_group(pg, True)
    plan.reset_group(pg)
    res["all_gather"] = tdx.all_gather(DistTensor.wrap(x.clone(), pg)).tensor[0].clone()
    rows = torch.randn(1, world, 5, generator=g)
    res["rows"] = rows[0].clone()
    res["reduce_scatter"] = tdx.reduce_scatter(DistTensor.wrap(rows, pg)).tensor[0].clone()
    res["routes"] = getattr(pg, "_plan_route_ctr", 0)
    res["frames"] = dist._p2p_plane.frames_sent
    plan.enable_for_group(pg, None)
    return res


def _p2p(rank, world):
    pg = dist._get_default_group()
    peer = 1 - rank
    out = {"listening": dist._p2p_plane.listening}
    f32 = torch.arange(12, dtype=torch.float32).reshape(3, 4) + 100 * rank
    bf = (torch.arange(6, dtype=torch.float32) / 3 + rank).bfloat16()
    if rank == 0:
        tdx.send(f32, 1)
        tdx.send(bf, 1, tag=3)
        tdx.isend(torch.tensor([7, 8, 9]), 1, tag=5).wait()
    else:
        buf = torch.empty(3, 4)
        out["src"] = tdx.recv(buf, 0)
        out["f32"] = buf
        b = torch.empty(6, dtype=torch.bfloat16)
        out["any_src"] = tdx.recv(b, None, tag=3)
        out["bf16"] = b
        i = torch.empty(3, dtype=torch.int64)
        w = tdx.irecv(i, 0, tag=5)
        w.wait()
        out["int"] = i
    # both ranks send and receive in one batch
    mine = torch.full((5,), float(rank))
    got = torch.empty(5)
    for w in tdx.batch_isend_irecv([tdx.P2POp(tdx.isend, mine, peer),
                                    tdx.P2POp(tdx.irecv, got, peer)]):
        w.wait()
    out["batch"] = got
    if rank == 0:
        tdx.send_object_list([{"a": 1}, "two"], 1)
    else:
        objs = [None, None]
        tdx.recv_object_list(objs, 0)
        out["objects"] = objs
    rows = DistTensor.wrap(torch.full((1, 4), float(rank)), pg)
    dist.permute(rows, [(0, 1), (1, 0)])
    out["permuted"] = rows.tensor[0].clone()
    out["frames"] = (dist._p2p_plane.frames_sent, dist._p2p_plane.frames_received)
    return out


def gang(rank, world, mode, *args):
    if mode == "prepare":
        return _prepare(rank, *args)
    if mode == "executor":
        return _executor(rank, world, *args)
    return _p2p(rank, world)
