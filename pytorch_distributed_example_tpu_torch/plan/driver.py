"""Driver-plane realizations of the planner's algorithms.

The port of the reference's `plan/driver.py`. There each algorithm is a
`shard_map` body over the group's mesh axis. Here the group's ranks are
the rows of one rank-stacked tensor, as `backends/stacked.py` holds them
(driver mode: all W rows on one device), and each body is written with the
differentiable collectives of `nn/functional.py` over an axis name: a
`ppermute` is a row permutation, `psum_scatter` and `all_gather` are the
stacked folds, and a rank's own offsets come from `nn.functional.rank_ids`.
So the same body also runs inside an entered multiproc mesh, where the
process holds one row and the collectives cross processes (the traced
seam, `plan/traced.py`).

Conventions match `backends/stacked.py`: all_reduce takes and returns the
(n, *s) rows; all_gather (n, *s) -> (n, W, *s); reduce_scatter
(n, W, *s) -> (n, *s), n the rows this process holds.

Algorithm menu (probe candidates): "onepass" is the stock one-shot fold
and exists so the probe table can PICK the status quo when it wins;
"ring" decomposes all-reduce into reduce-scatter + all-gather phases
(all-gather and reduce-scatter as W-1 neighbour shifts); "rhd" is the
recursive-halving/doubling tree built from row permutations
(latency-optimal round count, power-of-two worlds).
"""

from __future__ import annotations

import os
from typing import Callable

import torch

__all__ = [
    "body_for", "compiled_body", "supports", "driver_candidates",
    "reduce_kind_of", "AXIS",
]

# the axis name a group's rank dim takes when a body runs on a
# `ProcessGroup`'s stacked tensor (`plan._lower_driver`, the probe)
AXIS = "_ranks"
_SUM_KINDS = ("sum", "avg")


def reduce_kind_of(op) -> str:
    """Canonical planner name for a ReduceOp; raises KeyError for ops the
    planner does not synthesize (PRODUCT, bitwise, PREMUL_SUM) — callers
    catch and fall back to the stock lowering."""
    from ..types import ReduceOp

    return {
        ReduceOp.SUM: "sum",
        ReduceOp.AVG: "avg",
        ReduceOp.MAX: "max",
        ReduceOp.MIN: "min",
    }[op]


def supports(op_name: str, algorithm: str, world: int,
             reduce_kind: str = "sum") -> bool:
    """Can this (op, algorithm) run on the driver plane at this world?"""
    if world < 2:
        return False
    if op_name == "all_reduce":
        if algorithm == "onepass":
            return True
        if algorithm == "ring":
            return reduce_kind in _SUM_KINDS  # psum_scatter sums
        if algorithm == "rhd":
            return (world & (world - 1)) == 0
        return False
    if op_name == "all_gather":
        return algorithm in ("onepass", "ring")
    if op_name == "reduce_scatter":
        return algorithm in ("onepass", "ring")
    return False


def driver_candidates(op_name: str, world: int, reduce_kind: str = "sum"):
    return tuple(
        a for a in ("onepass", "ring", "rhd")
        if supports(op_name, a, world, reduce_kind)
    )


def compiled_body(op_name: str, algorithm: str, world: int, axis: str = AXIS,
                  mesh=None, reduce_kind: str = "sum"):
    """The driver-plane program seam (`plan._lower_driver` and the probe
    build through here): the body, run eagerly on the stacked tensor. The
    port compiles nothing here; the mesh is the reference's argument and
    is not needed. Under `TDX_PROGLINT=1` the program is wrapped by
    `tools/proglint.instrument`: its first call fingerprints the
    collectives it issues (the ppermute rounds ARE the schedule) and, in
    a multiproc gang, agrees them across ranks before they dispatch."""
    body = body_for(op_name, algorithm, world, axis, reduce_kind)

    @torch.no_grad()
    def prog(t):
        return body(t)

    if os.environ.get("TDX_PROGLINT", "0") == "1":
        from ..tools import proglint

        prog = proglint.instrument(
            f"plan.{op_name}.{algorithm}",
            prog,
            path="pytorch_distributed_example_tpu_torch/plan/driver.py",
            mesh_axes=(axis,),
            world=world,
        )
    return prog


def _combine(reduce_kind: str):
    if reduce_kind in _SUM_KINDS:
        return torch.add
    return {"max": torch.maximum, "min": torch.minimum}[reduce_kind]


def _ring_pairs(world: int):
    return [(i, (i + 1) % world) for i in range(world)]


def _take(cur, off, n: int):
    """Each row's n elements from its own offset: cur (rows, N), off (rows,)."""
    idx = off[:, None] + torch.arange(n, device=cur.device)
    return torch.gather(cur, 1, idx)


def _put(cur, off, vals):
    """cur with each row's vals written at its own offset."""
    idx = off[:, None] + torch.arange(vals.shape[1], device=cur.device)
    return cur.scatter(1, idx, vals)


def _padded(t, W: int):
    flat = t.reshape(t.shape[0], -1)
    n0 = flat.shape[1]
    pad = (-n0) % W
    if pad:
        flat = torch.cat([flat, flat.new_zeros((flat.shape[0], pad))], dim=1)
    return flat, n0


def body_for(op_name: str, algorithm: str, world: int, axis: str = AXIS,
             reduce_kind: str = "sum") -> Callable:
    """The rank-stacked body of (op, algorithm) over `axis`'s W ranks."""
    from .. import nn as _nn  # noqa: F401  (nn.functional)
    from ..nn import functional as nnf
    from ..types import ReduceOp

    W = world
    avg = reduce_kind == "avg"

    def ids(t):
        return nnf.rank_ids(axis, t.shape[0], t.device)

    if op_name == "all_reduce":
        if algorithm == "onepass":
            op = {"sum": ReduceOp.SUM, "avg": ReduceOp.AVG,
                  "max": ReduceOp.MAX, "min": ReduceOp.MIN}[reduce_kind]
            return lambda t: nnf.all_reduce(t, op, axis)

        if algorithm == "ring":

            def ring(t):  # (n, *s)
                flat, n0 = _padded(t, W)
                red = nnf.reduce_scatter(flat, axis, 0)
                out = nnf.all_gather(red, axis, 0, tiled=True)
                if avg:
                    out = out / W
                return out[:, :n0].reshape(t.shape)

            return ring

        if algorithm == "rhd":
            comb = _combine(reduce_kind)

            def rhd(t):  # (n, *s)
                flat, n0 = _padded(t, W)
                idx = ids(t)
                cur, seg = flat, flat.shape[1]
                off = torch.zeros_like(idx)
                L = W.bit_length() - 1
                for k in range(L):  # recursive halving (reduce-scatter)
                    m = 1 << k
                    pairs = [(i, i ^ m) for i in range(W)]
                    half = seg // 2
                    hi = (idx // m) % 2
                    keep_off = off + hi * half
                    send_off = off + (1 - hi) * half
                    got = nnf.ppermute(_take(cur, send_off, half), axis, pairs)
                    cur = _put(cur, keep_off, comb(_take(cur, keep_off, half), got))
                    off, seg = keep_off, half
                for k in reversed(range(L)):  # recursive doubling (gather)
                    m = 1 << k
                    pairs = [(i, i ^ m) for i in range(W)]
                    hi = (idx // m) % 2
                    peer_off = torch.where(hi == 1, off - seg, off + seg)
                    got = nnf.ppermute(_take(cur, off, seg), axis, pairs)
                    cur = _put(cur, peer_off, got)
                    off, seg = torch.minimum(off, peer_off), seg * 2
                if avg:
                    cur = cur / W
                return cur[:, :n0].reshape(t.shape)

            return rhd

    if op_name == "all_gather":
        if algorithm == "onepass":
            return lambda t: nnf.all_gather(t, axis, 0, tiled=False)

        def ag_ring(t):  # (n, *s) -> (n, W, *s)
            idx, rows = ids(t), torch.arange(t.shape[0], device=t.device)
            out = t.new_zeros((t.shape[0], W) + tuple(t.shape[1:]))
            out[rows, idx] = t
            cur = t
            for s in range(W - 1):
                cur = nnf.ppermute(cur, axis, _ring_pairs(W))
                out[rows, (idx - s - 1) % W] = cur
            return out

        return ag_ring

    if op_name == "reduce_scatter":
        if algorithm == "onepass":

            def rs_one(t):  # (n, W, *s): the stock fold
                r = nnf.reduce_scatter(t.reshape(t.shape[0], -1), axis, 0)
                if avg:
                    r = r / W
                return r.reshape((t.shape[0],) + tuple(t.shape[2:]))

            return rs_one

        comb = _combine(reduce_kind)

        def rs_ring(t):  # (n, W, *s) -> (n, *s)
            xs = t.reshape(t.shape[0], W, -1)
            idx, rows = ids(t), torch.arange(t.shape[0], device=t.device)
            cur = xs[rows, (idx - 1) % W]
            for s in range(W - 1):
                nxt = nnf.ppermute(cur, axis, _ring_pairs(W))
                cur = comb(nxt, xs[rows, (idx - s - 2) % W])
            if avg:
                cur = cur / W
            return cur.reshape((t.shape[0],) + tuple(t.shape[2:]))

        return rs_ring

    raise ValueError(f"no driver body for {op_name}/{algorithm}")
