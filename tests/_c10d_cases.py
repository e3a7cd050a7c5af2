"""Collective cases at world 2, run the same way by both packages.

`tests/test_torch_c10d_multiproc.py` runs them on the port in a 2-process
gloo gang (each process holds its row) and on the JAX package in driver mode
on a 2-rank group of the session world, and compares the rows. This module
imports neither package: the caller passes its module, its ReduceOp and how
to build a DistTensor from numpy values.
"""

import numpy as np

W = 2
SPLITS = [[1, 2], [2, 1]]  # ragged all_to_all_single: rank r sends SPLITS[r][j] rows to j

CASES = [
    dict(fn="all_reduce", op="SUM", dtype="float32", shape=(3, 2)),
    dict(fn="all_reduce", op="SUM", dtype="bfloat16", shape=(5,)),
    dict(fn="all_reduce", op="SUM", dtype="int32", shape=(4,)),
    dict(fn="all_reduce", op="SUM", dtype="bool", shape=(4,)),
    dict(fn="all_reduce", op="AVG", dtype="float32", shape=(4,)),
    dict(fn="all_reduce", op="AVG", dtype="int32", shape=(4,)),
    dict(fn="all_reduce", op="MAX", dtype="bfloat16", shape=(4,)),
    dict(fn="all_reduce", op="MIN", dtype="int32", shape=(4,)),
    dict(fn="all_reduce", op="PRODUCT", dtype="float32", shape=(4,)),
    dict(fn="all_reduce", op="BAND", dtype="int32", shape=(4,)),
    dict(fn="all_reduce", op="BOR", dtype="bool", shape=(4,)),
    dict(fn="all_reduce", op="BXOR", dtype="int32", shape=(4,)),
    dict(fn="all_reduce", op="PREMUL_SUM(2.5)", dtype="bfloat16", shape=(4,)),
    dict(fn="all_reduce", op="PREMUL_SUM(2.5)", dtype="int32", shape=(4,)),
    dict(fn="reduce", op="SUM", dtype="float32", shape=(3,), dst=1),
    dict(fn="reduce", op="AVG", dtype="int32", shape=(3,), dst=0),
    dict(fn="broadcast", dtype="float32", shape=(2, 3), src=1),
    dict(fn="broadcast", dtype="bool", shape=(3,), src=0),
    dict(fn="all_gather", dtype="float32", shape=(3,)),
    dict(fn="all_gather", dtype="bool", shape=(3,)),
    dict(fn="gather", dtype="int32", shape=(3,), dst=1),
    dict(fn="scatter", dtype="float32", shape=(W, 3), src=0),
    dict(fn="reduce_scatter", op="SUM", dtype="float32", shape=(W, 3)),
    dict(fn="reduce_scatter", op="AVG", dtype="bfloat16", shape=(W, 3)),
    dict(fn="reduce_scatter", op="MAX", dtype="int32", shape=(W, 3)),
    dict(fn="all_to_all", dtype="float32", shape=(W, 2)),
    dict(fn="all_to_all", dtype="bool", shape=(W, 2)),
    dict(fn="all_gather_into_tensor", dtype="float32", shape=(2, 2)),
    dict(fn="all_to_all_single", dtype="int32", shape=(2 * W, 2)),
    dict(fn="all_to_all_single", dtype="float32", shape=(3, 2), splits=SPLITS),
    dict(fn="reduce_scatter_tensor", op="SUM", dtype="float32", shape=(2 * W, 2)),
    dict(fn="send_recv", dtype="float32", shape=(3,)),
    dict(fn="batch_isend_irecv", dtype="int32", shape=(3,)),
]


def case_id(case):
    extra = [str(case[k]) for k in ("op", "dtype") if k in case]
    return "-".join([case["fn"], *extra]) + ("-ragged" if "splits" in case else "")


def inputs(index, shape):
    """Integer-valued float32 values, (W, *shape), from the case's seed."""
    rng = np.random.default_rng(100 + index)
    return rng.integers(-2, 3, (W,) + tuple(shape)).astype(np.float32)


def _op(name, ReduceOp):
    if name == "PREMUL_SUM(2.5)":
        return ReduceOp.PREMUL_SUM(2.5)
    return getattr(ReduceOp, name)


def run(mod, ReduceOp, make, index, group=None, rank=None):
    """Run case `index` with package `mod`; returns its result DistTensor.
    `rank` is None in driver mode (this process acts for both ranks), else
    this process's rank (point-to-point ops differ by mode)."""
    case = CASES[index]
    t = make(inputs(index, case["shape"]), case["dtype"], group)
    fn = case["fn"]
    if fn == "all_reduce":
        mod.all_reduce(t, _op(case["op"], ReduceOp), group)
        return t
    if fn == "reduce":
        mod.reduce(t, case["dst"], _op(case["op"], ReduceOp), group)
        return t
    if fn == "broadcast":
        mod.broadcast(t, case["src"], group)
        return t
    if fn in ("gather",):
        return mod.gather(t, case["dst"], group)
    if fn == "scatter":
        return mod.scatter(t, case["src"], group)
    if fn in ("reduce_scatter", "reduce_scatter_tensor"):
        return getattr(mod, fn)(t, _op(case["op"], ReduceOp), group)
    if fn == "all_to_all_single" and "splits" in case:
        return mod.all_to_all_single(t, input_split_sizes=case["splits"], group=group)
    if fn == "send_recv":  # rank 0's row goes to rank 1
        if rank is None:
            mod.send(t, 1, group, src=0)
            mod.recv(t, 0, group, dst=1)
        elif rank == 0:
            mod.send(t, 1, group)
        else:
            assert mod.recv(t, 0, group) == 0
        return t
    if fn == "batch_isend_irecv":  # the two ranks swap rows
        if rank is None:
            ops = [mod.P2POp(mod.isend, t, 1 - r, group, rank=r) for r in range(W)]
            ops += [mod.P2POp(mod.irecv, t, 1 - r, group, rank=r) for r in range(W)]
        else:
            ops = [mod.P2POp(mod.isend, t, 1 - rank, group),
                   mod.P2POp(mod.irecv, t, 1 - rank, group)]
        for w in mod.batch_isend_irecv(ops):
            w.wait()
        return t
    return getattr(mod, fn)(t, group=group)
