"""The port's trace-time planner seam (`plan/traced.py`) against the JAX
package's, on the CPU.

The reference's three-beat contract (`tests/test_planner_traced.py`):

1. probe OUTSIDE the trace — `prepare()` and `probe_driver` raise
   `TraceGuardError` inside the port's trace: a `torch.func.vmap` body
   (the step's rank vmap) and `torch.compile` (fullgraph, where the
   guard's error is what stops the trace);
2. agree BEFORE the step runs — a skewed `TDX_PLANNER_FORCE` fails the
   sequence-keyed agreement round naming the first divergent eqn on BOTH
   ranks of a real two-process gang, and an unforced rank adopts rank 0's
   choice and agrees (the two gang contracts the reference's own tests
   state and its run does not hold); a rank joining late retries cleanly;
3. dispatch inside the trace is pure — seeded or forced schedules run as
   `plan/driver.py`'s bodies: gathers bitwise the stock ones, reductions
   within rtol 1e-5 / atol 1e-5 of the stock ones and of the reference's
   `traced` functions under `shard_map` on the conftest's CPU devices.

Then the routed call sites (TP's row-parallel sum and gathered matmul,
ZeRO's halves, ZeRO-2's planner hook): planned results against the stock
ones, and with the planner off BITWISE the collective they called before
the seam existed. Last, the eager planner over the p2p plane in gloo gangs
of 2 and 4: ring, rhd and hier all-reduces against the stock gloo
all_reduce (rtol 1e-5 / atol 1e-5) and bitwise against their own
re-execution.
"""

import threading
import warnings

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

import pytorch_distributed_example_tpu_torch as tdx
from pytorch_distributed_example_tpu.plan import traced as jtraced
from pytorch_distributed_example_tpu.parallel import tensor_parallel as jtp
from pytorch_distributed_example_tpu_torch import plan, traceguard
from pytorch_distributed_example_tpu_torch.nn import functional as nnf
from pytorch_distributed_example_tpu_torch.parallel import tensor_parallel as ttp
from pytorch_distributed_example_tpu_torch.parallel import zero
from pytorch_distributed_example_tpu_torch.plan import driver, probe, traced
from pytorch_distributed_example_tpu_torch.schedule import ProgramScheduleMismatchError
from pytorch_distributed_example_tpu_torch.store import HashStore, PrefixStore
from pytorch_distributed_example_tpu_torch.tensor import DistTensor
from pytorch_distributed_example_tpu_torch.types import ReduceOp
from tests._torch_gang import run_gang

TOL = dict(rtol=1e-5, atol=1e-5)
AX = "tp"


@pytest.fixture(autouse=True)
def _isolated_planner(tmp_path, monkeypatch):
    monkeypatch.setenv("TDX_PLANNER_PROBE_CACHE", str(tmp_path / "probe_cache.json"))
    for name in ("TDX_PLANNER_FORCE", "TDX_COLLECTIVE_PLANNER", "TDX_PLANNER_OVERLAP"):
        monkeypatch.delenv(name, raising=False)
    traced.reset()
    jtraced.reset()
    yield
    traced.reset()
    jtraced.reset()


def _x(W, n=16, seed=0):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal((W, n))
                            .astype(np.float32))


def _ref(W, body, *xs, in_specs=None):
    mesh = Mesh(np.array(jax.devices()[:W]), (AX,))
    fn = jax.jit(jax.shard_map(body, mesh=mesh, in_specs=in_specs or P(AX), out_specs=P(AX)))
    return np.asarray(fn(*[x.numpy() for x in xs]))


def _count_permutes(monkeypatch):
    calls = []
    real = nnf.ppermute

    def counted(*a, **k):
        calls.append(1)
        return real(*a, **k)

    monkeypatch.setattr(nnf, "ppermute", counted)
    return calls


class TestTracedDispatch:
    @pytest.mark.parametrize("W", [2, 4, 8])
    def test_seeded_ring_allreduce_matches_stock_and_reference(self, W):
        x = _x(W)
        stock = traced.all_reduce(x, AX)
        traced.seed("all_reduce", "ring", world=W, nbytes=16 * 4)
        jtraced.seed("all_reduce", "ring", world=W, nbytes=16 * 4)
        planned = traced.all_reduce(x, AX)
        assert all(planned[r].numpy().tobytes() == planned[0].numpy().tobytes()
                   for r in range(W))
        torch.testing.assert_close(planned, stock, **TOL)
        want = _ref(W, lambda t: jtraced.all_reduce(t, AX, reduce_kind="sum"), x)
        np.testing.assert_allclose(planned.numpy(), want, **TOL)

    def test_force_env_honored_inside_a_vmap(self, monkeypatch):
        calls = _count_permutes(monkeypatch)
        monkeypatch.setenv("TDX_COLLECTIVE_PLANNER", "1")
        monkeypatch.setenv("TDX_PLANNER_FORCE", "rhd")
        x = _x(4, 8)
        out = torch.func.vmap(lambda t: traced.all_reduce(t, AX), in_dims=1, out_dims=1)(
            x[:, :, None].repeat(1, 1, 3))
        assert len(calls) == 4  # log2(4) halving + doubling rounds
        torch.testing.assert_close(out[..., 0], x.sum(0).expand(4, -1), **TOL)

    def test_all_gather_ring_bitwise_and_overlap_flag(self, monkeypatch):
        W = 4
        x = _x(W, 6).reshape(W, 2, 3)
        stock = traced.all_gather(x, AX, dim=1)
        traced.seed("all_gather", "ring", world=W, nbytes=6 * 4)
        calls = _count_permutes(monkeypatch)
        ring = traced.all_gather(x, AX, dim=1)
        assert len(calls) == W - 1 and torch.equal(ring, stock)
        monkeypatch.setenv("TDX_PLANNER_OVERLAP", "0")
        assert torch.equal(traced.all_gather(x, AX, dim=1), stock) and len(calls) == W - 1
        want = _ref(W, lambda t: jtraced.all_gather(t[0], AX, dim=1)[None], x)
        assert ring.numpy().tobytes() == want.reshape(ring.shape).tobytes()

    def test_reduce_scatter_ring_parity(self):
        W = 4
        flat = _x(W, W * 5, seed=3)
        stock = traced.reduce_scatter(flat, AX, reduce_kind="avg")
        traced.seed("reduce_scatter", "ring", world=W, nbytes=W * 5 * 4, reduce_kind="avg")
        jtraced.seed("reduce_scatter", "ring", world=W, nbytes=W * 5 * 4, reduce_kind="avg")
        planned = traced.reduce_scatter(flat, AX, reduce_kind="avg")
        torch.testing.assert_close(planned, stock, **TOL)
        want = _ref(W, lambda t: jtraced.reduce_scatter(t[0], AX, reduce_kind="avg")[None], flat)
        np.testing.assert_allclose(planned.numpy(), want.reshape(planned.shape), **TOL)

    def test_all_gather_matmul_overlapped_is_row_exact(self):
        W = 4
        x = torch.from_numpy(np.random.default_rng(4).standard_normal((W, 3, 8))
                             .astype(np.float32))
        w = torch.from_numpy(np.random.default_rng(5).standard_normal((8, 5)).astype(np.float32))
        stock = traced.all_gather_matmul(x, w, AX)
        traced.seed("all_gather", "ring", world=W, nbytes=3 * 8 * 4)
        ring = traced.all_gather_matmul(x, w, AX)
        torch.testing.assert_close(ring, stock, **TOL)
        # chunk-exact: each chunk's rows are that chunk's own product
        for r in range(W):
            assert torch.equal(ring[3 * r:3 * r + 3], x[r] @ w)

    def test_missing_bucket_warns_once_when_planner_on(self, monkeypatch):
        monkeypatch.setenv("TDX_COLLECTIVE_PLANNER", "1")
        x = _x(2, 300)
        with warnings.catch_warnings(record=True) as rec:
            warnings.simplefilter("always")
            traced.all_reduce(x, AX)
            traced.all_reduce(x, AX)
        msgs = [str(w.message) for w in rec if "no agreed schedule" in str(w.message)]
        assert len(msgs) == 1

    def test_planner_off_emits_stock_lowering(self, monkeypatch):
        calls = _count_permutes(monkeypatch)
        x = _x(4)
        out = traced.all_reduce(x, AX, replica=True)
        assert not calls and torch.equal(out, nnf.all_reduce(x, ReduceOp.SUM, AX, replica=True))


@pytest.fixture
def world2():
    pg = tdx.init_process_group(world_size=2, device="cpu")
    yield pg
    tdx.destroy_process_group()


class TestProbeNeverUnderTrace:
    def test_prepare_raises_under_tracing(self, world2):
        prepare = getattr(traced, "prepare")

        def body(t):
            with pytest.raises(traceguard.TraceGuardError, match="prepare called under tracing"):
                prepare(world2, [("all_reduce", 64, "sum")])
            return t

        torch.func.vmap(body)(torch.zeros(2, 4))  # the step's rank vmap

        def compiled(t):
            prepare(world2, [("all_reduce", 64, "sum")])
            return t * 2

        with pytest.raises(Exception, match="prepare called under tracing"):
            torch.compile(compiled, backend="eager", fullgraph=True)(torch.zeros(4))
        assert traced.lookup("all_reduce", 64, "sum") is None

    def test_probe_driver_raises_under_tracing(self, world2):
        probe_driver = getattr(probe, "probe_driver")

        def body(t):
            with pytest.raises(traceguard.TraceGuardError, match="under tracing"):
                probe_driver(world2.mesh, driver.AXIS, 2, "all_reduce", ("ring",), 1024)
            return t

        torch.func.vmap(body)(torch.zeros(2, 4))
        with pytest.raises(Exception, match="probe_driver called under tracing"):
            torch.compile(lambda t: (probe_driver(world2.mesh, driver.AXIS, 2, "all_reduce",
                                                  ("ring",), 1024), t)[1],
                          backend="eager", fullgraph=True)(torch.zeros(4))

    def test_prepare_on_host_fills_table(self, world2, monkeypatch):
        monkeypatch.setenv("TDX_COLLECTIVE_PLANNER", "1")
        monkeypatch.setenv("TDX_PLANNER_FORCE", "ring")
        assert list(traced.prepare(world2, [("all_reduce", 16 * 4, "sum")]).values()) == ["ring"]
        entry = traced.lookup("all_reduce", 16 * 4, "sum")
        assert entry["alg"] == "ring" and entry["world"] == 2

    def test_probe_on_host_times_every_candidate(self, world2):
        t = probe.probe_driver(world2.mesh, driver.AXIS, 2, "all_reduce",
                               ("onepass", "ring", "rhd"), 4096)
        assert sorted(t) == ["onepass", "rhd", "ring"] and all(v > 0 for v in t.values())
        t = probe.probe_driver(world2.mesh, driver.AXIS, 2, "reduce_scatter", ("ring",), 4096,
                               dtype=torch.bfloat16)
        assert list(t) == ["ring"]


class TestAgreement:
    def _agree(self, store, rank, world, seq, eqns, timeout=5.0):
        return traced.agree_entry(PrefixStore("planagree", store), rank, world, seq,
                                  op="all_reduce", bucket=1024, reduce_kind="avg", eqns=eqns,
                                  timeout=timeout)

    def _pair(self, st, eqns):
        errs = [None, None]

        def worker(r):
            try:
                self._agree(st, r, 2, 0, eqns[r])
            except Exception as e:
                errs[r] = e

        ts = [threading.Thread(target=worker, args=(r,)) for r in (0, 1)]
        for t in ts:
            t.start()
        for t in ts:
            t.join()
        return errs

    def test_skewed_schedules_fail_naming_first_divergent_eqn(self):
        errs = self._pair(HashStore(30.0), {0: ["all_reduce.ring|w2|avg|round0|psum_scatter"],
                                            1: ["all_reduce.rhd|w2|avg|round0|ppermute[(0,1)]"]})
        for r, e in enumerate(errs):
            assert isinstance(e, ProgramScheduleMismatchError), (r, e)
            assert "#1" in str(e) and "ring" in str(e) and "rhd" in str(e)

    def test_late_join_retries_cleanly_under_same_key(self):
        st = HashStore(30.0)
        eqns = ["all_reduce.ring|w2|avg|round0|psum_scatter"]
        with pytest.raises(ProgramScheduleMismatchError, match="never published"):
            self._agree(st, 0, 2, 0, eqns, timeout=0.3)
        assert self._pair(st, {0: eqns, 1: eqns}) == [None, None]


class TestMultiprocPrepareSkew:
    """The reference's acceptance contract: a skewed force fails prepare()
    on BOTH ranks naming eqn #1; an unforced rank adopts rank 0's choice."""

    def _gang(self, tmp_path, forces):
        rcs, outs, res = run_gang("tests._torch_mp_planner", tmp_path, 2,
                                  args=("prepare", forces), timeout=120)
        assert rcs == [0, 0], "\n".join(outs)
        return res

    def test_skewed_force_fails_prepare_on_both_ranks(self, tmp_path):
        for r, got in enumerate(self._gang(tmp_path, "ring,rhd")):
            assert "mismatch" in got, (r, got)
            assert "#1" in got["mismatch"]

    def test_unforced_ranks_adopt_rank0_and_agree(self, tmp_path):
        for r, got in enumerate(self._gang(tmp_path, "rhd,-")):
            assert got.get("agreed", {}).get("alg") == "rhd", (r, got)


class TestRoutedCallSites:
    def test_row_parallel_matmul_planned_matches_stock_and_off_is_bitwise(self):
        W = 4
        rng = np.random.default_rng(1)
        x = torch.from_numpy(rng.standard_normal((W, 3, 4)).astype(np.float32))
        w = torch.from_numpy(rng.standard_normal((W, 4, 5)).astype(np.float32))
        stock = ttp.row_parallel_matmul(x, w, AX)
        before = nnf.all_reduce(torch.bmm(x, w), ReduceOp.SUM, AX, replica=True)
        assert torch.equal(stock, before)  # the planner off: the old collective
        traced.seed("all_reduce", "ring", world=W, nbytes=3 * 5 * 4)
        planned = ttp.row_parallel_matmul(x, w, AX)
        torch.testing.assert_close(planned, stock, **TOL)
        want = _ref(W, lambda t, wm: jtp.row_parallel_matmul(t[0], wm[0], AX)[None], x, w,
                    in_specs=(P(AX), P(AX)))
        np.testing.assert_allclose(planned.numpy(), want[0], **TOL)

    def test_gathered_matmul_and_vocab_logits_ring_match_stock(self):
        W = 2
        rng = np.random.default_rng(2)
        x = torch.from_numpy(rng.standard_normal((W, 3, 8)).astype(np.float32))
        w = torch.from_numpy(rng.standard_normal((8, 6)).astype(np.float32))
        h = torch.from_numpy(rng.standard_normal((5, 8)).astype(np.float32))
        emb = torch.from_numpy(rng.standard_normal((W, 8, 6)).astype(np.float32))
        stock = (ttp.gathered_matmul(x, w, AX), ttp.vocab_parallel_logits(h, emb, AX))
        traced.seed("all_gather", "ring", world=W, nbytes=3 * 8 * 4)
        traced.seed("all_gather", "ring", world=W, nbytes=5 * 6 * 4)
        torch.testing.assert_close(ttp.gathered_matmul(x, w, AX), stock[0], **TOL)
        assert torch.equal(ttp.vocab_parallel_logits(h, emb, AX), stock[1])

    def test_zero_halves_planned_and_off_bitwise(self, monkeypatch):
        pg = tdx.init_process_group(world_size=4, device="cpu")
        try:
            W, K = 4, 6
            full = _x(W, K, seed=2)
            before = tdx.all_gather(DistTensor.wrap(full.clone(), pg)).tensor[0]
            assert torch.equal(zero.unshard(full, pg), before)
            packed = torch.from_numpy(np.random.default_rng(3).standard_normal((W, W, K))
                                      .astype(np.float32))
            before_rs = tdx.reduce_scatter(DistTensor.wrap(packed.clone(), pg), ReduceOp.AVG).tensor
            assert torch.equal(zero.reduce_scatter_mean(packed, pg), before_rs)
            calls = _count_permutes(monkeypatch)
            traced.seed("all_gather", "ring", world=W, nbytes=K * 4)
            traced.seed("reduce_scatter", "ring", world=W, nbytes=W * K * 4, reduce_kind="avg")
            assert torch.equal(zero.unshard(full, pg), before)  # pure data movement
            torch.testing.assert_close(zero.reduce_scatter_mean(packed, pg), before_rs, **TOL)
            assert len(calls) == 2 * (W - 1)
        finally:
            tdx.destroy_process_group()

    def test_zero2_planner_hook_matches_stock(self, monkeypatch):
        from pytorch_distributed_example_tpu_torch.mesh import DeviceMesh
        from pytorch_distributed_example_tpu_torch.parallel import fsdp

        mesh = DeviceMesh(["cpu"] * 2, (2,), ("fsdp",))
        rng = np.random.default_rng(6)
        w0 = torch.from_numpy(rng.standard_normal((4, 8)).astype(np.float32))
        xs = torch.from_numpy(rng.standard_normal((3, 8, 8)).astype(np.float32))
        ys = torch.from_numpy(rng.standard_normal((3, 8, 4)).astype(np.float32))

        def run(on):
            if on:
                monkeypatch.setenv("TDX_COLLECTIVE_PLANNER", "1")
                monkeypatch.setenv("TDX_PLANNER_FORCE", "ring")
            else:
                monkeypatch.delenv("TDX_COLLECTIVE_PLANNER", raising=False)
            step = fsdp.make_zero2_train_step(
                lambda p, x: x @ p["w"].T, lambda o, y: ((o - y) ** 2).mean(),
                lambda ps: torch.optim.SGD(ps, lr=0.1), mesh, axis="fsdp", data_axes=("fsdp",))
            params = {"w": w0.clone()}
            state = step.init_opt_state(params)
            losses = []
            for i in range(3):
                params, state, loss = step(params, state, xs[i], ys[i])
                losses.append(float(loss))
            return losses, params["w"].clone()

        stock = run(False)
        planned = run(True)
        assert traced.lookup("all_reduce", 4 * 8 * 4, "avg")["alg"] == "ring"
        np.testing.assert_allclose(planned[0], stock[0], rtol=1e-6)
        torch.testing.assert_close(planned[1], stock[1], rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("world,algs", [(2, "ring,rhd"), (4, "ring,rhd,hier")])
def test_executor_gang_over_the_plane(tmp_path, world, algs):
    rcs, outs, res = run_gang("tests._torch_mp_planner", tmp_path, world,
                              args=("executor", algs), timeout=180)
    assert rcs == [0] * world, "\n".join(outs)
    for alg in algs.split(","):
        xs = torch.stack([r[alg]["x"] for r in res])
        for r, got in enumerate(res):
            torch.testing.assert_close(got[alg]["stock"], xs.sum(0), **TOL)
            first, again = got[alg]["planned"]
            assert torch.equal(first, again), (alg, r)  # bitwise re-execution
            assert torch.equal(first, res[0][alg]["planned"][0]), (alg, r)  # every rank
            torch.testing.assert_close(first, got[alg]["stock"], **TOL)
            assert got[alg]["choice"] == ("all_reduce", alg, "force")
    xs = torch.stack([r["x"] for r in res])
    rows = torch.stack([q["rows"] for q in res])
    for r, got in enumerate(res):
        assert torch.equal(got["all_gather"], xs)
        torch.testing.assert_close(got["reduce_scatter"], rows.sum(0)[r], **TOL)
        assert got["routes"] == 2 * len(algs.split(",")) + 2 and got["frames"] > 0
