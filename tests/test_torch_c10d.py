"""The port's c10d core in driver mode against the JAX package's, on the CPU.

The port runs world 8 as 8 ranks stacked on the CPU device; the reference
runs on the session `world` fixture (8 virtual CPU devices). The same numpy
inputs, made from a seed, go through both, and every collective, ReduceOp
and dtype the reference accepts must give the same values in the same
dtype; where the reference raises, the port raises the same error type.

Tolerances: integer-valued inputs are exact in every dtype (sums of eight
values in [-2, 2], products of at most eight factors of 2, all representable
in bfloat16). Random float32 inputs are held to rtol 1e-6 and random
bfloat16 to rtol 2**-7 (the two may sum the rows in another order; on the
CPU both add them in rank order and agree bit for bit).
"""

import importlib.util
import os

import ml_dtypes
import numpy as np
import pytest
import torch

import pytorch_distributed_example_tpu as jtdx
import pytorch_distributed_example_tpu_torch as tdx
from pytorch_distributed_example_tpu.types import ReduceOp as JOp
from pytorch_distributed_example_tpu_torch.backends import BackendError
from pytorch_distributed_example_tpu_torch.examples import toy
from pytorch_distributed_example_tpu_torch.types import ReduceOp as TOp
from tests._mp_util import REPO

W = 8
F32_TOL = dict(rtol=1e-6, atol=0)
BF16_TOL = dict(rtol=2 ** -7, atol=0)

DTYPES = {
    "float32": (np.float32, torch.float32),
    "bfloat16": (ml_dtypes.bfloat16, torch.bfloat16),
    "int32": (np.int32, torch.int32),
    "bool": (np.bool_, torch.bool),
}
OPS = ["SUM", "AVG", "PRODUCT", "MIN", "MAX", "BAND", "BOR", "BXOR", "PREMUL_SUM",
       "PREMUL_SUM(2.5)"]


def _op(name, enum):
    if name == "PREMUL_SUM(2.5)":
        return enum.PREMUL_SUM(2.5)
    return getattr(enum, name)


@pytest.fixture
def port():
    """The port's default group: 8 ranks stacked on the CPU, torn down after."""
    pg = tdx.init_process_group(backend="xla", world_size=W, device="cpu")
    yield pg
    tdx.destroy_process_group()


def _values(seed, shape, low=-2, high=2):
    """Integer-valued float32 inputs, (W, *shape)."""
    return np.random.default_rng(seed).integers(low, high + 1, (W,) + shape).astype(np.float32)


def _pair(x, dtype, group=(None, None)):
    """The same (W, ...) numpy values as a reference and a port DistTensor."""
    jdt, tdt = DTYPES[dtype]
    j = jtdx.DistTensor.from_stacked(x.astype(jdt), group[0])
    t = tdx.DistTensor.from_stacked(torch.from_numpy(x.astype(np.float32)).to(tdt), group[1])
    return j, t


def _dtype_name(dt):
    return str(dt).removeprefix("torch.")


def _assert_same(ref, got, tol=None):
    """Reference DistTensor vs port DistTensor: dtype and values."""
    assert _dtype_name(got.dtype) == str(ref.dtype), (got.dtype, ref.dtype)
    want = np.asarray(ref.numpy()).astype(np.float64)
    have = got.numpy().astype(np.float64)
    assert have.shape == want.shape, (have.shape, want.shape)
    if tol is None:
        np.testing.assert_array_equal(have, want)
    else:
        np.testing.assert_allclose(have, want, **tol)


def _both(run_ref, run_port):
    """Run the reference; if it raises, the port must raise the same type."""
    try:
        ref = run_ref()
    except (TypeError, NotImplementedError, ValueError) as e:
        with pytest.raises(type(e)):
            run_port()
        return None, None
    return ref, run_port()


# ---------------------------------------------------------------------------
# reductions: every op x every dtype
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("op", OPS)
def test_all_reduce_matches_reference(world, port, op, dtype):
    x = _values(1, (3, 5))
    j, t = _pair(x, dtype)
    ref, got = _both(lambda: (jtdx.all_reduce(j, _op(op, JOp)), j)[1],
                     lambda: (tdx.all_reduce(t, _op(op, TOp)), t)[1])
    if ref is not None:
        _assert_same(ref, got)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("op", OPS)
def test_reduce_scatter_matches_reference(world, port, op, dtype):
    x = _values(2, (W, 4))
    j, t = _pair(x, dtype)
    ref, got = _both(lambda: jtdx.reduce_scatter(j, _op(op, JOp)),
                     lambda: tdx.reduce_scatter(t, _op(op, TOp)))
    if ref is not None:
        _assert_same(ref, got)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("op", ["SUM", "AVG", "PRODUCT", "MAX", "BOR", "PREMUL_SUM(2.5)"])
def test_reduce_matches_reference(world, port, op, dtype):
    """Only dst's row holds the reduction; the others keep their input (in
    the reduction's dtype, as the reference's `where` promotes them)."""
    x = _values(3, (6,))
    j, t = _pair(x, dtype)
    ref, got = _both(lambda: (jtdx.reduce(j, 3, _op(op, JOp)), j)[1],
                     lambda: (tdx.reduce(t, 3, _op(op, TOp)), t)[1])
    if ref is not None:
        _assert_same(ref, got)


@pytest.mark.parametrize("dtype,tol", [("float32", F32_TOL), ("bfloat16", BF16_TOL)])
@pytest.mark.parametrize("op", ["SUM", "AVG", "MAX", "MIN", "PREMUL_SUM(2.5)"])
def test_random_float_all_reduce(world, port, op, dtype, tol):
    x = np.random.default_rng(4).standard_normal((W, 257)).astype(np.float32)
    j, t = _pair(x, dtype)
    jtdx.all_reduce(j, _op(op, JOp))
    tdx.all_reduce(t, _op(op, TOp))
    _assert_same(j, t, tol)


def test_integer_avg_is_float32_true_division(port):
    """The reference's AVG is `lax.pmean`: the int32 SUM, then true
    division, so it comes out float32 (here 1.875, not 1)."""
    t = tdx.DistTensor.from_rank_fn(lambda r: torch.tensor([r % 3 + 1], dtype=torch.int32))
    tdx.all_reduce(t, TOp.AVG)
    assert t.dtype == torch.float32
    np.testing.assert_array_equal(t.numpy(), np.full((W, 1), 15 / 8, np.float32))


# ---------------------------------------------------------------------------
# data movement
# ---------------------------------------------------------------------------


_MOVES = {
    "broadcast_src0": (lambda m, t: (m.broadcast(t, 0), t)[1], (4,)),
    "broadcast_src5": (lambda m, t: (m.broadcast(t, 5), t)[1], (2, 3)),
    "all_gather": (lambda m, t: m.all_gather(t), (3,)),
    "gather_dst2": (lambda m, t: m.gather(t, 2), (3,)),
    "scatter_src1": (lambda m, t: m.scatter(t, 1), (W, 2)),
    "all_to_all": (lambda m, t: m.all_to_all(t), (W, 3)),
    "all_gather_into_tensor": (lambda m, t: m.all_gather_into_tensor(t), (2, 3)),
    "all_to_all_single": (lambda m, t: m.all_to_all_single(t), (2 * W, 2)),
    "reduce_scatter_tensor": (lambda m, t: m.reduce_scatter_tensor(t), (2 * W, 3)),
}


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("name", list(_MOVES))
def test_data_movement_matches_reference(world, port, name, dtype):
    fn, shape = _MOVES[name]
    x = _values(5, shape)
    j, t = _pair(x, dtype)
    ref, got = _both(lambda: fn(jtdx, j), lambda: fn(tdx, t))
    if ref is not None:
        _assert_same(ref, got)


@pytest.mark.parametrize("splits", [
    [1, 0, 2, 1, 3, 0, 1, 2],  # one list for every rank
    [[(1, 0, 2, 1, 3, 0, 1, 2)[(r + j) % W] for j in range(W)] for r in range(W)],  # per rank
])
def test_ragged_all_to_all_single(world, port, splits):
    rows = [sum(s) for s in splits] if isinstance(splits[0], list) else [sum(splits)] * W
    assert len(set(rows)) == 1  # one input length for every rank
    x = _values(6, (rows[0], 2), -9, 9)
    j, t = _pair(x, "float32")
    ref = jtdx.all_to_all_single(j, input_split_sizes=splits)
    got = tdx.all_to_all_single(t, input_split_sizes=splits)
    _assert_same(ref, got)
    assert got.split_sizes == ref.split_sizes


def test_uneven_reduce_scatter_tensor(world, port):
    splits = [3, 0, 1, 2, 1, 1, 0, 2]
    x = _values(7, (sum(splits), 2))
    j, t = _pair(x, "float32")
    ref = jtdx.reduce_scatter_tensor(j, split_sizes=splits)
    got = tdx.reduce_scatter_tensor(t, split_sizes=splits)
    _assert_same(ref, got)
    assert got.split_sizes == ref.split_sizes


def test_results_are_separate_rows(port):
    """An in-place op on one rank's result leaves every other rank's alone:
    the reduction is materialized W times, not an expand() view."""
    t = tdx.DistTensor.from_rank_fn(lambda r: torch.full((4,), float(r)))
    tdx.all_reduce(t)
    assert t.tensor.stride(0) != 0
    t.tensor[0] += 1
    np.testing.assert_array_equal(t.numpy()[1:], np.full((W - 1, 4), 28.0, np.float32))
    b = tdx.DistTensor.from_rank_fn(lambda r: torch.full((2,), float(r)))
    tdx.broadcast(b, 3)
    b.tensor[5].zero_()
    np.testing.assert_array_equal(b.numpy()[4], [3.0, 3.0])


# ---------------------------------------------------------------------------
# Work, groups, coalescing, p2p, objects
# ---------------------------------------------------------------------------


def test_async_work(world, port):
    x = _values(8, (5,))
    j, t = _pair(x, "float32")
    jtdx.all_reduce(j)
    work = tdx.all_reduce(t, async_op=True)
    assert work.wait()
    assert work.is_completed() and work.is_success()
    _assert_same(j, t)
    res, work = tdx.all_gather(t, async_op=True)
    assert work.wait() and work.result() is res.tensor


@pytest.mark.parametrize("ranks", [[1, 3, 5], [0, 1, 2, 3]])
def test_new_group_matches_reference(world, port, ranks):
    jg, tg = jtdx.new_group(ranks), tdx.new_group(ranks)
    assert tdx.get_world_size(tg) == len(ranks)
    assert tdx.get_process_group_ranks(tg) == ranks
    x = np.random.default_rng(9).integers(-2, 3, (len(ranks), 4)).astype(np.float32)
    j, t = _pair(x, "float32", (jg, tg))
    jtdx.all_reduce(j, JOp.MAX, jg)
    tdx.all_reduce(t, TOp.MAX, tg)
    _assert_same(j, t)
    assert tdx.get_group_rank(tg, ranks[-1]) == len(ranks) - 1
    assert tdx.get_global_rank(tg, 0) == ranks[0]


def test_new_subgroups_match_reference(world, port):
    (jcur, jgroups), (tcur, tgroups) = jtdx.new_subgroups(4), tdx.new_subgroups(4)
    assert [g.ranks for g in tgroups] == [g.ranks for g in jgroups] == [[0, 1, 2, 3],
                                                                        [4, 5, 6, 7]]
    assert tcur.ranks == jcur.ranks
    for jg, tg in zip(jgroups, tgroups):
        x = _values(10, (3,))[:4]
        j, t = _pair(x, "int32", (jg, tg))
        jtdx.all_reduce(j, JOp.SUM, jg)
        tdx.all_reduce(t, TOp.SUM, tg)
        _assert_same(j, t)
    tcur, tgroups = tdx.new_subgroups_by_enumeration([[0, 7], [2, 3, 4]])
    assert [g.ranks for g in tgroups] == [[0, 7], [2, 3, 4]] and tcur is tgroups[0]
    assert tdx.split_group(split_ranks=[[0, 1], [2, 3]]).ranks == [0, 1]


def test_coalescing_manager(world, port):
    xs = [_values(11 + i, (4,)) for i in range(3)]
    pairs = [_pair(x, "float32") for x in xs]
    with jtdx.coalescing_manager() as jcm:
        for j, _ in pairs:
            jtdx.all_reduce(j, async_op=True)
    with tdx.coalescing_manager() as tcm:
        for _, t in pairs:
            tdx.all_reduce(t, async_op=True)
    assert len(tcm.works) == 0 and len(jcm.works) == 0  # waited at exit
    for j, t in pairs:
        _assert_same(j, t)
    cm = tdx.all_reduce_coalesced([t for _, t in pairs], TOp.MAX, async_op=True)
    cm.wait()
    for j, t in pairs:
        jtdx.all_reduce(j, JOp.MAX)
        _assert_same(j, t)


def test_send_recv_and_batch_isend_irecv(world, port):
    x = _values(12, (3,), -9, 9)
    j, t = _pair(x, "float32")
    jtdx.send(j, 5, src=1)
    jtdx.recv(j, 1, dst=5)
    tdx.send(t, 5, src=1)
    assert tdx.recv(t, 1, dst=5) == 1
    _assert_same(j, t)
    ring = [(r, (r + 1) % W) for r in range(W)]
    jops = [jtdx.P2POp(jtdx.isend, j, d, rank=s) for s, d in ring] + \
        [jtdx.P2POp(jtdx.irecv, j, s, rank=d) for s, d in ring]
    tops = [tdx.P2POp(tdx.isend, t, d, rank=s) for s, d in ring] + \
        [tdx.P2POp(tdx.irecv, t, s, rank=d) for s, d in ring]
    for w in jtdx.batch_isend_irecv(jops):
        w.wait()
    for w in tdx.batch_isend_irecv(tops):
        w.wait()
    _assert_same(j, t)
    with pytest.raises(ValueError):
        tdx.send(t, 2, tag=-1, src=0)


def test_object_collectives_match_reference(world, port):
    objs = [{"rank": r, "payload": list(range(r))} for r in range(W)]
    assert tdx.all_gather_object(objs) == jtdx.all_gather_object(objs)
    jl, tl = list(objs), list(objs)
    jtdx.broadcast_object_list(jl, src=3)
    tdx.broadcast_object_list(tl, src=3)
    assert tl == jl == [objs[3]] * W
    jout, tout = [], []
    jtdx.scatter_object_list(jout, [f"item{r}" * r for r in range(W)], src=2)
    tdx.scatter_object_list(tout, [f"item{r}" * r for r in range(W)], src=2)
    assert tout == jout
    gathered = []
    assert tdx.gather_object(objs, gathered, dst=1) == jtdx.gather_object(objs, dst=1)
    assert gathered == objs
    with pytest.raises(RuntimeError):
        tdx.send_object_list([1], dst=1)


def test_barriers_and_queries(port):
    assert tdx.is_initialized() and tdx.get_rank() == 0 and tdx.get_world_size() == W
    assert tdx.get_backend() == "xla"
    assert tdx.barrier(async_op=True).is_completed()
    tdx.monitored_barrier()
    assert tdx.get_pg_count() == 1
    assert tdx.is_gloo_available()


# ---------------------------------------------------------------------------
# error paths
# ---------------------------------------------------------------------------


def test_double_init_raises(port):
    with pytest.raises(RuntimeError, match="twice"):
        tdx.init_process_group(world_size=W, device="cpu")


def test_unknown_backend_lists_registry():
    with pytest.raises(BackendError) as e:
        tdx.init_process_group(backend="bogus", world_size=W, device="cpu")
    for name in ("fake", "gloo", "nccl", "xla"):
        assert repr(name) in str(e.value)
    assert not tdx.is_initialized()


@pytest.mark.parametrize("kwargs", [dict(rank=3), dict(world_size=0), dict(world_size=-4)])
def test_bad_rank_or_world_size_raise(kwargs):
    with pytest.raises(ValueError):
        tdx.init_process_group(**{"world_size": W, "device": "cpu", **kwargs})
    assert not tdx.is_initialized()


def test_collective_argument_errors(port):
    t = tdx.DistTensor.from_rank_fn(lambda r: torch.zeros(3))
    with pytest.raises(ValueError):
        tdx.reduce_scatter(t)  # per-rank leading dim 3 != world 8
    with pytest.raises(ValueError):
        tdx.broadcast(t, W)
    with pytest.raises(TypeError):
        tdx.all_reduce(torch.zeros(3))


def test_no_card_raises_without_device():
    """The library takes the card unless asked for the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tdx.init_process_group(world_size=W)
    assert not tdx.is_initialized()


# ---------------------------------------------------------------------------
# observability
# ---------------------------------------------------------------------------


def _recorded(recorder, group):
    return [(e.seq, e.op, tuple(e.shape), e.dtype, e.state)
            for e in recorder.entries() if e.group == group]


def test_flight_recorder_matches_reference(world, port):
    """The same op sequence on a fresh group of each package leaves the
    same (seq, op, shape, dtype, state) entries."""
    from pytorch_distributed_example_tpu.utils.flight_recorder import global_recorder as jrec
    from pytorch_distributed_example_tpu_torch.utils.flight_recorder import (
        global_recorder as trec,
    )

    name = "flight_recorder_parity"
    jg = jtdx.new_group(range(W), group_desc=name)
    tg = tdx.new_group(range(W), group_desc=name)
    for m, g, x in ((jtdx, jg, _pair(_values(13, (W, 2)), "bfloat16", (jg, tg))[0]),
                    (tdx, tg, _pair(_values(13, (W, 2)), "bfloat16", (jg, tg))[1])):
        m.all_reduce(x, group=g, async_op=True).wait()
        _, w = m.all_gather(x, group=g, async_op=True)
        w.wait()
        m.broadcast(x, 2, group=g, async_op=True).wait()
        _, w = m.reduce_scatter(x, group=g, async_op=True)
        w.wait()
    want = _recorded(jrec(), name)
    assert len(want) == 4 and all(s == "completed" for *_, s in want)
    assert _recorded(trec(), name) == want


def test_watchdog_trips_on_injected_dispatch_hang(port, tmp_path):
    """A `collective.dispatch` hang (the faults seam, inside watchdog
    coverage) trips the group's watchdog, which dumps the flight recorder
    and calls its timeout handler naming the wedged collective."""
    from pytorch_distributed_example_tpu_torch import faults
    from pytorch_distributed_example_tpu_torch.utils.flight_recorder import DebugInfoWriter

    trips = []
    port.enable_watchdog(timeout_s=0.1, poll_interval_s=0.02,
                         on_timeout=lambda desc, work, path: trips.append((desc, path)),
                         writer=DebugInfoWriter(str(tmp_path)))
    faults.install_plan([{"point": "collective.dispatch", "action": "hang", "delay_s": 0.5}],
                        export_env=False)
    try:
        t = tdx.DistTensor.from_rank_fn(lambda r: torch.ones(2))
        tdx.all_reduce(t)
    finally:
        faults.clear_plan()
        port.watchdog.stop()
    assert trips and trips[0][0].startswith("default_pg:all_reduce:")
    assert trips[0][1].startswith(str(tmp_path))
    np.testing.assert_array_equal(t.numpy(), np.full((W, 2), float(W), np.float32))


def test_detail_debug_level_wraps_groups(port):
    from pytorch_distributed_example_tpu_torch.backends.wrapper import ProcessGroupWrapper

    tdx.set_debug_level(tdx.DebugLevel.DETAIL)
    try:
        g = tdx.new_group([0, 1])
    finally:
        tdx.set_debug_level(tdx.DebugLevel.OFF)
    assert isinstance(g.backend_impl, ProcessGroupWrapper)
    t = tdx.DistTensor.from_rank_fn(lambda r: torch.tensor([float(r)]), g)
    tdx.all_reduce(t, group=g)
    np.testing.assert_array_equal(t.numpy(), [[1.0], [1.0]])


# ---------------------------------------------------------------------------
# the slice as a whole: the toy example
# ---------------------------------------------------------------------------


def _reference_toy():
    spec = importlib.util.spec_from_file_location(
        "reference_toy", os.path.join(REPO, "examples", "toy", "main.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_toy_example_prints_the_reference_values(world, capsys):
    """`examples/toy.py --cpu --world-size 8 --steps 3` prints what the
    reference's `examples/toy/main.py` prints for world 8 and 3 steps: its
    `run()` on the session world, line for line."""
    _reference_toy().run(W, 3)
    want = capsys.readouterr().out.splitlines()
    toy.main(["--cpu", "--world-size", "8", "--steps", "3"])
    lines = capsys.readouterr().out.splitlines()
    assert lines == ["initialized: backend=xla world_size=8"] + want
    assert want[-1] == "step 2: all_reduce(SUM) -> 44.0 (every rank agrees: True, expect 44)"
    assert not tdx.is_initialized()


def test_sync_path_work_does_not_pin_the_result(port):
    """A collective the caller ran synchronously leaves a Work in the
    completion sweep; on a card that Work may wait many calls, so it must
    not hold the output alive (an async Work keeps it for `result()`)."""
    t = tdx.DistTensor.from_rank_fn(lambda r: torch.ones(4))
    tdx.all_reduce(t)
    work, _ = port._inflight[-1]
    assert work._result is None
    w = tdx.all_reduce(t, async_op=True)
    assert w.result() is t.tensor
