"""The port's multiproc mode: a 2-process gloo gang against the reference.

Two processes join through the port's `init_process_group(init_method=
"tcp://...")` on the CPU (rank 0 hosts the port's TCPStore; torch.distributed's
gloo group meets over that same store). Each runs the cases of
`tests/_c10d_cases.py`, the toy example, barriers, object collectives and
p2p, then destroys the group; every result row must equal the JAX package's
driver-mode result at world 2 on the same inputs, computed here. A second
gang arms `TDX_SCHEDULE_CHECK=1` and issues divergent schedules: both ranks
must raise `ScheduleMismatchError` naming the divergence.

Integer-valued inputs, so every value is exact. The gangs take a few
seconds each (interpreter and torch start-up).
"""

import io
import contextlib
import importlib.util
import os
import pickle
import subprocess
import sys
import textwrap

import ml_dtypes
import numpy as np
import pytest

import pytorch_distributed_example_tpu as jtdx
from pytorch_distributed_example_tpu.types import ReduceOp as JOp
from tests import _c10d_cases as cases
from tests._mp_util import REPO
from tests._torch_gang import gang_env, gang_port

GANG_TIMEOUT_S = 120

WORKER = textwrap.dedent(
    """
    import contextlib, io, pickle, sys
    rank, world, port, out = int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]

    import torch
    import pytorch_distributed_example_tpu_torch as tdx
    from pytorch_distributed_example_tpu_torch.examples import toy
    from pytorch_distributed_example_tpu_torch.types import ReduceOp
    from tests import _c10d_cases as cases

    DT = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "int32": torch.int32, "bool": torch.bool}

    def make(x, dtype, group):
        return tdx.DistTensor.from_stacked(torch.from_numpy(x).to(DT[dtype]), group)

    pg = tdx.init_process_group(backend="gloo", init_method=f"tcp://127.0.0.1:{port}",
                                rank=rank, world_size=world, device="cpu", timeout=60)
    res = {"mode": tdx.distributed._world.mode, "rank": tdx.get_rank(),
           "world": tdx.get_world_size(), "native": pg.store.underlying.native}
    for i in range(len(cases.CASES)):
        r = cases.run(tdx, ReduceOp, make, i, rank=rank)
        res[i] = (str(r.dtype).removeprefix("torch."), r.local_numpy()[0],
                  getattr(r, "split_sizes", None))
    full = tdx.DistTensor.from_rank_fn(lambda r: torch.tensor([r, 10 * r]))
    res["numpy"] = full.numpy()  # a collective read: every rank's row
    tdx.barrier()
    tdx.monitored_barrier(timeout=30)
    res["objects"] = tdx.all_gather_object({"rank": rank, "sq": rank * rank})
    objs = ["a", {"b": 2}] if rank == 1 else [None, None]
    tdx.broadcast_object_list(objs, src=1)
    res["broadcast_objects"] = objs
    if rank == 0:
        tdx.send_object_list([{"hello": 1}, [2, 3]], dst=1)
    else:
        got = [None, None]
        res["recv_objects"] = (tdx.recv_object_list(got, src=0), got)
    sub = tdx.new_group([1])
    if rank == 1:
        t = tdx.DistTensor.from_process_local(torch.tensor([7.0]), sub)
        tdx.all_reduce(t, group=sub)
        res["subgroup"] = t.local_numpy()[0]
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        toy.run(world, 2)
    res["toy"] = buf.getvalue().splitlines()
    tdx.destroy_process_group()
    res["destroyed"] = not tdx.is_initialized()
    with open(out, "wb") as f:
        pickle.dump(res, f)
    """
)

SCHEDULE_WORKER = textwrap.dedent(
    """
    import sys
    rank, world, port = int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3])

    import torch
    import pytorch_distributed_example_tpu_torch as tdx
    from pytorch_distributed_example_tpu_torch.types import ReduceOp

    tdx.init_process_group(backend="gloo", init_method=f"tcp://127.0.0.1:{port}",
                           rank=rank, world_size=world, device="cpu", timeout=60)
    t = tdx.DistTensor.from_process_local(torch.ones(3))
    try:
        tdx.all_reduce(t)
        # rank 1 diverges: MAX where rank 0 runs SUM
        tdx.all_reduce(t, ReduceOp.MAX if rank == 1 else ReduceOp.SUM)
        print("no mismatch raised")
    except tdx.ScheduleMismatchError as e:
        print("MISMATCH", e)
    finally:
        tdx.destroy_process_group()
    """
)


def _gang(script, tmp_path, extra_env=None, world=cases.W):
    """Run `script` as ranks 0..world-1 of one gang; (returncodes, outputs)."""
    path = tmp_path / "worker.py"
    path.write_text(script)
    port = gang_port()
    env = {**gang_env(), **(extra_env or {})}
    procs = [subprocess.Popen([sys.executable, str(path), str(r), str(world), str(port),
                               str(tmp_path / f"rank{r}.pkl")],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env, cwd=REPO)
             for r in range(world)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=GANG_TIMEOUT_S)[0].decode())
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return [p.returncode for p in procs], outs


@pytest.fixture(scope="module")
def gang(tmp_path_factory):
    """The 2-process gloo gang's results, by rank."""
    tmp = tmp_path_factory.mktemp("gang")
    rcs, outs = _gang(WORKER, tmp)
    for r, (rc, out) in enumerate(zip(rcs, outs)):
        assert rc == 0, f"rank {r} failed:\n{out}"
    results = []
    for r in range(cases.W):
        with open(tmp / f"rank{r}.pkl", "rb") as f:
            results.append(pickle.load(f))
    return results


_JDT = {"float32": np.float32, "bfloat16": ml_dtypes.bfloat16, "int32": np.int32,
        "bool": np.bool_}


@pytest.fixture(scope="module")
def reference(world):
    """The JAX package's results for every case, driver mode at world 2."""
    group = jtdx.new_group(range(cases.W))

    def make(x, dtype, g):
        return jtdx.DistTensor.from_stacked(x.astype(_JDT[dtype]), g)

    out = {}
    for i in range(len(cases.CASES)):
        r = cases.run(jtdx, JOp, make, i, group=group)
        out[i] = (str(r.dtype), np.asarray(r.numpy()), getattr(r, "split_sizes", None))
    return out


@pytest.mark.parametrize("index", range(len(cases.CASES)),
                         ids=[cases.case_id(c) for c in cases.CASES])
def test_gang_matches_reference(gang, reference, index):
    want_dtype, want, want_splits = reference[index]
    for rank, res in enumerate(gang):
        dtype, row, splits = res[index]
        assert dtype == want_dtype, (rank, dtype, want_dtype)
        np.testing.assert_array_equal(row.astype(np.float64), want[rank].astype(np.float64),
                                      err_msg=f"rank {rank}")
        assert splits == want_splits


def test_gang_bring_up_and_teardown(gang):
    for rank, res in enumerate(gang):
        assert (res["mode"], res["rank"], res["world"]) == ("multiproc", rank, cases.W)
        assert res["destroyed"]
    assert gang[0]["native"], "rank 0's store daemon should be the native one"
    for res in gang:
        np.testing.assert_array_equal(res["numpy"], [[0, 0], [1, 10]])


def test_gang_object_collectives_and_p2p(gang):
    want = [{"rank": r, "sq": r * r} for r in range(cases.W)]
    for res in gang:
        assert res["objects"] == want
        assert res["broadcast_objects"] == ["a", {"b": 2}]
    assert gang[1]["recv_objects"] == (0, [{"hello": 1}, [2, 3]])
    np.testing.assert_array_equal(gang[1]["subgroup"], [7.0])


def _reference_toy_lines(world_size):
    spec = importlib.util.spec_from_file_location(
        "reference_toy_mp", os.path.join(REPO, "examples", "toy", "main.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        mod.run(world_size, 2)
    return buf.getvalue().splitlines()


def test_gang_toy_example_matches_reference(world, gang):
    want = _reference_toy_lines(cases.W)
    assert want[0].endswith("(every rank agrees: True, expect 1)")
    for res in gang:
        assert res["toy"] == want


def test_schedule_check_names_the_divergence(tmp_path):
    rcs, outs = _gang(SCHEDULE_WORKER, tmp_path,
                      {"TDX_SCHEDULE_CHECK": "1", "TDX_SCHEDULE_CHECK_EVERY": "2",
                       "TDX_SCHEDULE_CHECK_TIMEOUT_S": "20"})
    for r, (rc, out) in enumerate(zip(rcs, outs)):
        assert rc == 0, f"rank {r} failed:\n{out}"
        assert "MISMATCH" in out, f"rank {r}:\n{out}"
        assert "ReduceOp.MAX" in out and "ReduceOp.SUM" in out, out
