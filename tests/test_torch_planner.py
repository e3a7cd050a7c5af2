"""The port's collective planner (`plan/`) against the JAX package's, on the CPU.

* Executor gangs: the reference's `TestExecutorGangs` cases, each plan
  walked over W in-process port `P2PPlane`s (one thread a rank) and over
  the reference's planes with the same inputs: every rank's result equal
  to the reference's BITWISE (the same plan fixes the same fold order),
  and within rtol 1e-5 / atol 1e-5 of a float64 sum; pipelined walks
  bitwise the plain ones; hier's fan-in bitwise from run to run.
* `plan.step` chaos (the reference's `TestPlanStepChaos`): a corrupt
  round is named on every rank, a rank failing mid-collective is
  diagnosed by the survivors without a hang, a whole-pass retry replays
  bitwise.
* The probe cache and plan artifacts across packages: each package reads
  the other's `ProbeCache` file and writes the same `Plan` JSON; the
  topology keys are equal.
* Planner choice: force, cache, probe, structural default and the
  candidate filters, the same answer from both packages.
* Driver bodies: `onepass`, `ring` and `rhd` of all_reduce, all_gather and
  reduce_scatter on the rank-stacked tensor against the reference's
  `shard_map` bodies on the conftest's CPU devices at W 2, 4 and 8:
  gathers bitwise, reductions within rtol 1e-5 / atol 1e-5.
* The `_dispatch` seam in driver mode (the reference's
  `TestDispatchLowering`): planned results against the stock ones,
  bitwise at the two-rank geometry; the DDP step through `planner_hook`
  bitwise the stock step at two ranks.
"""

import json
import logging
import threading

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

import pytorch_distributed_example_tpu_torch as tdx
from pytorch_distributed_example_tpu import p2p as jp2p
from pytorch_distributed_example_tpu.plan import driver as jdriver
from pytorch_distributed_example_tpu.plan import executor as jexec
from pytorch_distributed_example_tpu.plan import probe as jprobe
from pytorch_distributed_example_tpu.plan import schedules as jsched
from pytorch_distributed_example_tpu.plan.planner import CollectivePlanner as JPlanner
from pytorch_distributed_example_tpu.plan.topology import Topology as JTopology
from pytorch_distributed_example_tpu_torch import faults, plan
from pytorch_distributed_example_tpu_torch.p2p import P2PPlane
from pytorch_distributed_example_tpu_torch.plan import driver, executor, probe, schedules
from pytorch_distributed_example_tpu_torch.plan.planner import CollectivePlanner
from pytorch_distributed_example_tpu_torch.plan.topology import Topology
from pytorch_distributed_example_tpu_torch.schedule import ScheduleMismatchError, ScheduleVerifier
from pytorch_distributed_example_tpu_torch.store import HashStore, PrefixStore
from pytorch_distributed_example_tpu_torch.tensor import DistTensor
from pytorch_distributed_example_tpu_torch.types import DistError, ReduceOp

SUM_TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True)
def _isolated_probe_cache(tmp_path, monkeypatch):
    monkeypatch.setenv("TDX_PLANNER_PROBE_CACHE", str(tmp_path / "probe_cache.json"))
    for name in ("TDX_PLANNER_FORCE", "TDX_COLLECTIVE_PLANNER", "TDX_TOPOLOGY"):
        monkeypatch.delenv(name, raising=False)
    faults.clear_plan()
    yield
    faults.clear_plan()


def _topo(W, hosts=None):
    return Topology(W, hosts or (tuple(range(W)),), "cpu")


def _run_gang(pln, inputs, planes_of=P2PPlane, execute=executor.execute, reduce_kind="sum",
              average=False, verifiers=None, route="t", join_timeout=60.0, pipeline=1):
    """Execute a plan across W in-process planes (one thread a rank);
    returns (results, errors) by rank."""
    W = pln.world
    st = HashStore(30.0)
    planes = [planes_of(r, st, advertise="127.0.0.1").start() for r in range(W)]
    results, errors = [None] * W, [None] * W

    def worker(r):
        try:
            results[r] = execute(pln, r, inputs[r], planes[r], route=route, timeout=15.0,
                                 reduce_kind=reduce_kind, average=average,
                                 verifier=verifiers[r] if verifiers else None,
                                 pipeline_chunks=pipeline)
        except Exception as e:  # collected for assertions, chaos included
            errors[r] = e

    ts = [threading.Thread(target=worker, args=(r,)) for r in range(W)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(join_timeout)
    alive = [t for t in ts if t.is_alive()]
    for p in planes:
        p.close()
    assert not alive, "planner gang hung (threads still alive)"
    return results, errors


def _both(op, alg, W, n, hosts, xs, **kw):
    """(port results as numpy, reference results) of one plan."""
    p = schedules.synthesize(op, alg, W, n, _topo(W, hosts))
    jp = jsched.synthesize(op, alg, W, n, JTopology(W, hosts or (tuple(range(W)),), "cpu"))
    got, errs = _run_gang(p, [torch.from_numpy(x) for x in xs], **kw)
    assert not any(errs), errs
    want, jerrs = _run_gang(jp, xs, planes_of=jp2p.P2PPlane, execute=jexec.execute, **kw)
    assert not any(jerrs), jerrs
    return [g.numpy() for g in got], want


class TestExecutorGangs:
    @pytest.mark.parametrize("alg,W,hosts", [
        ("ring", 3, None),
        ("ring", 4, None),
        ("rhd", 4, None),
        ("hier", 5, ((0, 1, 2), (3, 4))),
        ("hier", 3, None),  # single host: leader star
    ])
    def test_all_reduce_matches_reference_bitwise(self, alg, W, hosts):
        n = 37  # exercises ring/rhd padding
        rng = np.random.default_rng(1)
        xs = [rng.standard_normal(n).astype(np.float32) for _ in range(W)]
        ref = np.sum(np.stack(xs).astype(np.float64), axis=0)
        got, want = _both("all_reduce", alg, W, n, hosts, xs)
        for r in range(W):
            assert got[r].tobytes() == want[r].tobytes(), (alg, r)
            np.testing.assert_allclose(got[r], ref, **SUM_TOL)

    def test_all_gather_and_reduce_scatter(self):
        W = 4
        rng = np.random.default_rng(2)
        xs = [rng.standard_normal(6).astype(np.float32) for _ in range(W)]
        got, want = _both("all_gather", "ring", W, 6, None, xs)
        for r in range(W):
            np.testing.assert_array_equal(got[r], np.stack(xs))
            assert got[r].tobytes() == want[r].tobytes()
        lists = [rng.standard_normal((W, 5)).astype(np.float32) for _ in range(W)]
        ref = np.sum(np.stack(lists).astype(np.float64), axis=0)
        got, want = _both("reduce_scatter", "ring", W, 5, None, lists)
        for r in range(W):
            assert got[r].tobytes() == want[r].tobytes()
            np.testing.assert_allclose(got[r], ref[r], **SUM_TOL)

    def test_max_and_avg_kinds(self):
        W, n = 3, 12
        rng = np.random.default_rng(3)
        xs = [rng.standard_normal(n).astype(np.float32) for _ in range(W)]
        got, want = _both("all_reduce", "ring", W, n, None, xs, reduce_kind="max")
        np.testing.assert_array_equal(got[0], np.max(np.stack(xs), axis=0))
        got, want = _both("all_reduce", "ring", W, n, None, xs, average=True)
        assert got[1].tobytes() == want[1].tobytes()
        np.testing.assert_allclose(got[1], np.mean(np.stack(xs).astype(np.float64), axis=0),
                                   **SUM_TOL)

    def test_bf16_payload_folds_in_bf16(self):
        W, n = 4, 40
        rng = np.random.default_rng(5)
        xs = [torch.from_numpy(rng.standard_normal(n).astype(np.float32)).bfloat16()
              for _ in range(W)]
        p = schedules.synthesize("all_reduce", "ring", W, n, _topo(W))
        got, errs = _run_gang(p, xs)
        assert not any(errs), errs
        assert all(g.dtype == torch.bfloat16 for g in got)
        ref = torch.stack(xs).double().sum(0)
        torch.testing.assert_close(got[0].double(), ref, rtol=2 ** -6, atol=4e-2)
        assert all(torch.equal(g, got[0]) for g in got)

    def test_pipelined_execution_bitwise_matches_plain(self):
        for alg, W, hosts in [("ring", 4, None), ("rhd", 4, None),
                              ("hier", 5, ((0, 1, 2), (3, 4)))]:
            rng = np.random.default_rng(11)
            xs = [torch.from_numpy(rng.standard_normal(37).astype(np.float32))
                  for _ in range(W)]
            p = schedules.synthesize("all_reduce", alg, W, 37, _topo(W, hosts))
            a, ea = _run_gang(p, xs, pipeline=1, route=f"pl1{alg}")
            b, eb = _run_gang(p, xs, pipeline=4, route=f"pl4{alg}")
            assert not any(ea) and not any(eb), (alg, ea, eb)
            for r in range(W):
                assert a[r].numpy().tobytes() == b[r].numpy().tobytes(), (alg, r)

    def test_pipelined_rounds_fingerprint_chunking(self):
        class Rec:
            def __init__(self):
                self.details = []

            def record(self, seq, op, shape, dtype, detail=""):
                self.details.append(detail)

        W = 5
        rng = np.random.default_rng(12)
        xs = [torch.from_numpy(rng.standard_normal(24).astype(np.float32)) for _ in range(W)]
        p = schedules.synthesize("all_reduce", "hier", W, 24, Topology(W, ((0, 1, 2), (3, 4)),
                                                                        "cpu"))
        recs = [Rec() for _ in range(W)]
        _, errs = _run_gang(p, xs, pipeline=3, verifiers=recs, route="plfp")
        assert not any(errs), errs
        assert all(r.details == recs[0].details for r in recs)
        assert any(d.endswith("|pipe3") for d in recs[0].details)
        assert any("intra_reduce" in d and not d.endswith("|pipe3") for d in recs[0].details)

    def test_split_chunks_covers_exactly(self):
        for off, length, c in [(0, 10, 4), (7, 3, 8), (5, 1, 4), (2, 12, 3)]:
            parts = executor.split_chunks(off, length, c)
            assert parts == jexec.split_chunks(off, length, c)
            assert sum(n for _, n in parts) == length

    def test_hier_reduce_any_is_bitwise_deterministic(self):
        W = 5
        rng = np.random.default_rng(4)
        xs = [torch.from_numpy(rng.standard_normal(64).astype(np.float32)) for _ in range(W)]
        p = schedules.synthesize("all_reduce", "hier", W, 64, Topology(W, ((0, 1, 2), (3, 4)),
                                                                        "cpu"))
        a, ea = _run_gang(p, xs)
        b, eb = _run_gang(p, xs)
        assert not any(ea) and not any(eb)
        for r in range(W):
            assert torch.equal(a[r], b[r])


def _verifiers(W, timeout=4.0, prefix="a0"):
    st = HashStore(30.0)
    return [ScheduleVerifier(PrefixStore(f"plansched_{prefix}", st), r, W, "plangang", every=1,
                             timeout=timeout) for r in range(W)]


class TestPlanStepChaos:
    def _xs(self, W, n, seed=None):
        if seed is None:
            return [torch.full((n,), float(r + 1)) for r in range(W)]
        rng = np.random.default_rng(seed)
        return [torch.from_numpy(rng.standard_normal(n).astype(np.float32)) for _ in range(W)]

    def test_corrupt_names_first_divergent_step_on_every_rank(self):
        W = 3
        p = schedules.synthesize("all_reduce", "ring", W, 24, _topo(W))
        faults.install_plan([{"point": "plan.step", "rank": 1, "after": 2,
                              "action": "corrupt"}], export_env=False)
        _, errs = _run_gang(p, self._xs(W, 24), verifiers=_verifiers(W), join_timeout=30.0)
        assert all(isinstance(e, ScheduleMismatchError) for e in errs), errs
        for e in errs:
            assert "plan.all_reduce.ring" in str(e) and "divergen" in str(e)

    def test_fault_mid_collective_no_hang_survivors_diagnose(self):
        W = 3
        p = schedules.synthesize("all_reduce", "ring", W, 24, _topo(W))
        faults.install_plan([{"point": "plan.step", "rank": 1, "after": 2, "action": "error",
                              "message": "injected mid-plan fault"}], export_env=False)
        _, errs = _run_gang(p, self._xs(W, 24), verifiers=_verifiers(W, timeout=3.0),
                            join_timeout=45.0)
        assert isinstance(errs[1], DistError) and "injected mid-plan fault" in str(errs[1])
        for r in (0, 2):
            assert isinstance(errs[r], ScheduleMismatchError), errs[r]
            assert "did not reach the checkpoint" in str(errs[r])
            assert "plan.all_reduce.ring" in str(errs[r])

    def test_whole_pass_retry_replays_bitwise(self):
        W = 3
        xs = self._xs(W, 40, seed=13)
        p = schedules.synthesize("all_reduce", "ring", W, 40, _topo(W))
        clean, errs = _run_gang(p, xs, route="clean")
        assert not any(errs)
        faults.install_plan([{"point": "plan.step", "rank": 2, "after": 2, "action": "error",
                              "times": 1}], export_env=False)
        _, errs0 = _run_gang(p, xs, verifiers=_verifiers(W, timeout=3.0), route="try0",
                             join_timeout=45.0)
        assert any(errs0)
        res1, errs1 = _run_gang(p, xs, verifiers=_verifiers(W, prefix="a1"), route="try1",
                                join_timeout=45.0)
        assert not any(errs1), errs1
        for r in range(W):
            assert torch.equal(res1[r], clean[r])


class TestAcrossPackages:
    def test_topology_keys_equal(self):
        for W, hosts in [(4, None), (8, ((0, 1, 2, 3), (4, 5, 6, 7))), (5, ((0, 1, 2), (3, 4)))]:
            h = hosts or (tuple(range(W)),)
            assert Topology(W, h, "gpu").key() == JTopology(W, h, "gpu").key()

    def test_probe_cache_files_read_both_ways(self, tmp_path):
        a, b = str(tmp_path / "port.json"), str(tmp_path / "ref.json")
        probe.ProbeCache(a).update("w4/h4/cpu", "all_reduce", 4096, {"ring": 0.5, "rhd": 0.25})
        jprobe.ProbeCache(b).update("w8/h8/cpu", "all_gather", 1024, {"onepass": 0.1},
                                    plane="plane")
        assert jprobe.ProbeCache(a).lookup("w4/h4/cpu", "all_reduce", 4096) == {
            "ring": 0.5, "rhd": 0.25}
        assert probe.ProbeCache(b).lookup("w8/h8/cpu", "all_gather", 1024, "plane") == {
            "onepass": 0.1}
        # merge-on-write across packages keeps the other's rows
        probe.ProbeCache(b).update("w4/h4/cpu", "all_reduce", 4096, {"ring": 1.0})
        c = jprobe.ProbeCache(b)
        assert c.lookup("w8/h8/cpu", "all_gather", 1024, "plane") == {"onepass": 0.1}
        assert c.lookup("w4/h4/cpu", "all_reduce", 4096) == {"ring": 1.0}
        with open(a) as f:
            assert json.load(f)["version"] == 1

    def test_probe_cache_of_another_platform_warns_and_is_not_read(self, tmp_path, caplog):
        path = str(tmp_path / "cache.json")
        jprobe.ProbeCache(path).update("w8/h8/tpu", "all_reduce", 4096, {"ring": 0.5})
        c = probe.ProbeCache(path)
        with caplog.at_level(logging.WARNING):
            assert c.lookup("w8/h8/gpu", "all_reduce", 4096) is None
            assert c.lookup("w8/h8/gpu", "all_reduce", 1 << 20) is None
        warns = [r for r in caplog.records if "do not apply to this topology" in r.getMessage()]
        assert len(warns) == 1 and "w8/h8/gpu" in warns[0].getMessage()

    @pytest.mark.parametrize("op,alg,W,hosts", [
        ("all_reduce", "ring", 4, None), ("all_reduce", "rhd", 8, None),
        ("all_reduce", "hier", 5, ((0, 1, 2), (3, 4))), ("all_gather", "ring", 3, None),
        ("reduce_scatter", "ring", 4, None),
    ])
    def test_plan_artifacts_identical(self, tmp_path, monkeypatch, op, alg, W, hosts):
        h = hosts or (tuple(range(W)),)
        paths = []
        for name, pl in (("port", CollectivePlanner(Topology(W, h, "cpu"))),
                         ("ref", JPlanner(JTopology(W, h, "cpu")))):
            d = tmp_path / name
            monkeypatch.setenv("TDX_PLANNER_ARTIFACT_DIR", str(d))
            pl.plan_for(op, alg, 100)
            paths.append(sorted(d.iterdir()))
        (a,), (b,) = paths
        assert a.name == b.name and a.read_bytes() == b.read_bytes()


class TestPlannerChoice:
    def test_probe_argmin_and_disk_persistence(self, tmp_path):
        calls = []

        def fake_probe(op, cands, bucket, kind):
            calls.append((op, tuple(cands), bucket))
            return {"onepass": 3.0, "ring": 1.0, "rhd": 2.0}

        path = str(tmp_path / "c.json")
        pl = CollectivePlanner(_topo(4), cache=probe.ProbeCache(path), probe_fn=fake_probe)
        assert pl.choose("all_reduce", 4096) == ("ring", "probe")
        assert pl.choose("all_reduce", 4000) == ("ring", "probe") and len(calls) == 1
        pl2 = CollectivePlanner(_topo(4), cache=probe.ProbeCache(path),
                                probe_fn=lambda *a: pytest.fail("should hit the cache"))
        assert pl2.choose("all_reduce", 4096) == ("ring", "cache")
        # the reference's planner reads the port's table the same way
        jpl = JPlanner(JTopology(4, ((0, 1, 2, 3),), "cpu"), cache=jprobe.ProbeCache(path),
                       probe_fn=lambda *a: pytest.fail("should hit the cache"))
        assert jpl.choose("all_reduce", 4096) == ("ring", "cache")

    def test_force_env_pins_and_validates(self, monkeypatch):
        timings = lambda *a: {"ring": 1.0, "onepass": 0.1, "rhd": 0.5}  # noqa: E731
        pl = CollectivePlanner(_topo(4), probe_fn=timings)
        jpl = JPlanner(JTopology(4, ((0, 1, 2, 3),), "cpu"), probe_fn=timings)
        monkeypatch.setenv("TDX_PLANNER_FORCE", "rhd")
        assert pl.choose("all_reduce", 4096) == jpl.choose("all_reduce", 4096) == ("rhd", "force")
        monkeypatch.setenv("TDX_PLANNER_FORCE", "warp9")
        with pytest.raises(ValueError, match="TDX_PLANNER_FORCE"):
            pl.choose("all_reduce", 4096)
        monkeypatch.setenv("TDX_PLANNER_FORCE", "ring")
        got = pl.choose("all_reduce", 4096, "max")
        assert got[0] == jpl.choose("all_reduce", 4096, "max")[0] and got[1] != "force"

    def test_structural_default_without_prober(self):
        pl = CollectivePlanner(Topology(4, ((0, 1), (2, 3)), "cpu"))
        pl.cache = probe.ProbeCache(path=None)
        assert pl.choose("all_reduce", 1 << 20, "sum", "plane") == ("hier", "default")

    def test_ring_pipe_is_a_plane_candidate_and_cache_drives_it(self, tmp_path, monkeypatch):
        t = _topo(4)
        pl = CollectivePlanner(t, cache=probe.ProbeCache(str(tmp_path / "pc.json")))
        cands = pl.candidates("all_reduce", "sum", "plane")
        assert "ring_pipe" in cands and cands[0] == "ring"
        assert pl.choose("all_reduce", 4096, "sum", "plane") == ("ring", "default")
        pl2 = CollectivePlanner(t, cache=probe.ProbeCache(str(tmp_path / "pc2.json")))
        pl2.cache.update(t.key(), "all_reduce", probe.bucket_bytes(1 << 20),
                         {"ring": 2e-3, "rhd": 3e-3, "ring_pipe": 1e-3}, plane="plane")
        assert pl2.choose("all_reduce", 1 << 20, "sum", "plane") == ("ring_pipe", "cache")
        assert pl2.plan_for("all_reduce", "ring_pipe", 1024).algorithm == "ring"

    def test_candidate_filters_match_reference(self):
        for W, hosts in [(3, None), (8, None), (8, ((0, 1, 2, 3), (4, 5, 6, 7)))]:
            h = hosts or (tuple(range(W)),)
            pl = CollectivePlanner(Topology(W, h, "cpu"), probe_fn=lambda *a: {})
            jpl = JPlanner(JTopology(W, h, "cpu"), probe_fn=lambda *a: {})
            for op in ("all_reduce", "all_gather", "reduce_scatter"):
                for kind in ("sum", "avg", "max"):
                    for plane_ in ("driver", "plane"):
                        assert pl.candidates(op, kind, plane_) == jpl.candidates(op, kind, plane_)
        assert driver.reduce_kind_of(ReduceOp.AVG) == "avg"
        with pytest.raises(KeyError):
            driver.reduce_kind_of(ReduceOp.PRODUCT)


def _jmesh(W):
    return Mesh(np.array(jax.devices()[:W]), ("g",))


def _reference_body(op, alg, W, x, kind):
    fn = jax.jit(jax.shard_map(jdriver.body_for(op, alg, W, "g", kind), mesh=_jmesh(W),
                               in_specs=P("g"), out_specs=P("g")))
    return np.asarray(fn(x))


class TestDriverBodies:
    @pytest.mark.parametrize("W", [2, 4, 8])
    @pytest.mark.parametrize("op,alg,kind", [
        ("all_reduce", "onepass", "sum"), ("all_reduce", "ring", "sum"),
        ("all_reduce", "ring", "avg"), ("all_reduce", "rhd", "sum"), ("all_reduce", "rhd", "max"),
        ("all_gather", "onepass", "sum"), ("all_gather", "ring", "sum"),
        ("reduce_scatter", "onepass", "sum"), ("reduce_scatter", "ring", "avg"),
    ])
    def test_body_matches_reference_shard_map(self, W, op, alg, kind):
        rng = np.random.default_rng(W)
        x = (rng.standard_normal((W, W, 5)) if op == "reduce_scatter"
             else rng.standard_normal((W, 37))).astype(np.float32)
        assert driver.supports(op, alg, W, kind) == jdriver.supports(op, alg, W, kind)
        want = _reference_body(op, alg, W, x, kind)
        # the reference's local (1, *s) block concatenates over ranks: (W, ...)
        got = driver.body_for(op, alg, W, reduce_kind=kind)(torch.from_numpy(x)).numpy()
        if op == "all_gather":
            want = want.reshape(W, W, 37)
            assert got.tobytes() == want.tobytes()
        else:
            np.testing.assert_allclose(got, want.reshape(got.shape), **SUM_TOL)
        if op == "all_reduce":  # every rank holds the same result
            assert all(got[r].tobytes() == got[0].tobytes() for r in range(W))


@pytest.fixture
def world4():
    pg = tdx.init_process_group(world_size=4, device="cpu")
    yield pg
    tdx.destroy_process_group()


def _stacked(W, n, seed=7):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.standard_normal((W, n)).astype(np.float32))


class TestDispatchLowering:
    def _reduce(self, pg, vals, on, op=ReduceOp.SUM):
        plan.enable_for_group(pg, on)
        dt = DistTensor.wrap(vals.clone(), pg)
        tdx.all_reduce(dt, op, group=pg)
        return dt.tensor

    def test_all_reduce_ring_rhd_and_avg_match_stock(self, world4, monkeypatch):
        vals = _stacked(4, 257)
        stock = self._reduce(world4, vals, False)
        for alg in ("ring", "rhd"):
            monkeypatch.setenv("TDX_PLANNER_FORCE", alg)
            got = self._reduce(world4, vals, True)
            assert plan.planner_for_group(world4).last_choice == ("all_reduce", alg, "force")
            torch.testing.assert_close(got, stock, rtol=1e-5, atol=1e-5)
        got = self._reduce(world4, vals, True, ReduceOp.AVG)
        np.testing.assert_allclose(got[0].numpy(), vals.double().mean(0).numpy(), rtol=1e-5,
                                   atol=1e-6)

    def test_all_gather_and_reduce_scatter_parity(self, world4, monkeypatch):
        monkeypatch.setenv("TDX_PLANNER_FORCE", "ring")
        vals = _stacked(4, 33)
        out = []
        for on in (True, False):
            plan.enable_for_group(world4, on)
            out.append(tdx.all_gather(DistTensor.wrap(vals.clone(), world4)).tensor)
        assert torch.equal(*out)
        rows = torch.from_numpy(np.random.default_rng(9).standard_normal((4, 4, 11))
                                .astype(np.float32))
        out = []
        for on in (True, False):
            plan.enable_for_group(world4, on)
            dt = DistTensor.wrap(rows.clone(), world4)
            out.append(tdx.reduce_scatter(dt).tensor)
        torch.testing.assert_close(out[0], out[1], rtol=1e-5, atol=1e-5)

    def test_unsupported_reduce_op_falls_back(self, world4):
        vals = _stacked(4, 9).abs() + 0.5
        got = self._reduce(world4, vals, True, ReduceOp.PRODUCT)
        np.testing.assert_allclose(got[0].numpy(), vals.double().prod(0).numpy(), rtol=1e-5)

    def test_group_override_beats_env(self, world4, monkeypatch):
        monkeypatch.setenv("TDX_COLLECTIVE_PLANNER", "1")
        assert plan.active_for_group(world4)
        plan.enable_for_group(world4, False)
        assert not plan.active_for_group(world4)
        plan.enable_for_group(world4, None)
        assert plan.active_for_group(world4)

    def test_bitwise_exact_at_two_rank_geometry(self, world4, monkeypatch):
        sub = tdx.new_group([0, 1])
        vals = _stacked(2, 301, seed=11)
        monkeypatch.setenv("TDX_PLANNER_FORCE", "ring")
        ring = self._reduce(sub, vals, True)
        assert plan.planner_for_group(sub).last_choice[1] == "ring"
        assert torch.equal(ring, self._reduce(sub, vals, False))


class TestDDPCommHook:
    def test_hook_none_when_inactive(self, world4):
        assert plan.ddp_comm_hook(world4) is None

    def test_planner_hook_loss_bitwise_at_two_ranks(self, monkeypatch):
        from pytorch_distributed_example_tpu_torch.optim import sgd
        from pytorch_distributed_example_tpu_torch.parallel.ddp import make_ddp_train_step

        pg = tdx.init_process_group(world_size=2, device="cpu")
        try:
            rng = np.random.default_rng(5)
            w0 = torch.from_numpy(rng.standard_normal((4, 8)).astype(np.float32))
            xs = torch.from_numpy(rng.standard_normal((6, 16, 8)).astype(np.float32))
            ys = torch.from_numpy(rng.standard_normal((6, 16, 4)).astype(np.float32))

            def apply_fn(p, x):
                return x @ p["w"].T + p["b"]

            def loss_fn(out, y):
                return ((out - y) ** 2).mean()

            def train(on):
                plan.enable_for_group(pg, on)
                plan.reset_group(pg)
                step = make_ddp_train_step(apply_fn, loss_fn, sgd(0.05), group=pg)
                assert (step.comm_hook.__name__ == "planner_hook") == on
                params = {"w": w0.clone(), "b": torch.zeros(4)}
                state = step.init_opt_state(params)
                losses = []
                for i in range(6):
                    params, state, loss = step(params, state, xs[i], ys[i])
                    losses.append(np.asarray(loss).tobytes())
                return losses, params

            monkeypatch.setenv("TDX_PLANNER_FORCE", "ring")
            ring_losses, ring_params = train(True)
            # the step prepared its buckets on the host: the weight's mean
            assert plan.traced.lookup("all_reduce", 4 * 8 * 4, "avg")["alg"] == "ring"
            stock_losses, stock_params = train(False)
            assert ring_losses == stock_losses
            for k in ("w", "b"):
                assert torch.equal(ring_params[k], stock_params[k])
        finally:
            tdx.destroy_process_group()


def test_quant_hook_planner_composition(tmp_path, monkeypatch):
    """The reference's `test_quant_hook_planner_composition` (red in its
    own run), held by the port: the stateful int8 hook (error feedback)
    under ZeRO "auto" with TDX_COLLECTIVE_PLANNER=1 trains MNIST (12 steps
    of 64, SGD 0.05 momentum 0.9) to a final loss within 1% (floor 1e-3)
    of the float32 unsharded run, whose default hook is then the
    planner's."""
    import torch.nn.functional as F

    from pytorch_distributed_example_tpu_torch import optim
    from pytorch_distributed_example_tpu_torch.data import SyntheticMNIST
    from pytorch_distributed_example_tpu_torch.examples import mnist
    from pytorch_distributed_example_tpu_torch.models import ConvNet
    from pytorch_distributed_example_tpu_torch.parallel import comm_hooks

    monkeypatch.setenv("TDX_COLLECTIVE_PLANNER", "1")
    pg = tdx.init_process_group(world_size=8, device="cpu")
    try:
        ds = SyntheticMNIST(512)

        def train(hook, mode):
            model = ConvNet(device="cpu", generator=torch.Generator().manual_seed(0))
            ddp = tdx.DistributedDataParallel(model)
            if hook is not None:
                ddp.register_comm_hook(None, hook)
            step = ddp.make_train_step(optim.sgd(0.05, momentum=0.9), F.cross_entropy,
                                       shard_weight_update=mode)
            p, o = ddp.params, step.init_opt_state(ddp.params)
            hs = step.init_hook_state(p) if hasattr(step, "init_hook_state") else None
            losses = []
            for i in range(12):
                x, y = mnist.to_device(*ds[np.arange(i * 64, (i + 1) * 64) % len(ds)], "cpu")
                if hs is not None:
                    p, o, hs, loss = step(p, o, hs, x, y)
                else:
                    p, o, loss = step(p, o, x, y)
                losses.append(float(loss))
            return losses, step

        quant, qstep = train(comm_hooks.blockwise_quant_hook(bits=8, error_feedback=True),
                             "auto")
        ref, rstep = train(None, "off")
        assert qstep.weight_update_sharded and rstep.comm_hook.__name__ == "planner_hook"
        assert quant[-1] < quant[0] * 0.8
        assert abs(quant[-1] - ref[-1]) <= max(0.01 * abs(ref[-1]), 1e-3)
    finally:
        tdx.destroy_process_group()
