"""The port's elastic agent, held to the reference's agent tests.

`tests/test_elastic.py`'s cases run against
`pytorch_distributed_example_tpu_torch.elastic`: gang spawn, the env
contract, restart-on-failure, dynamic world size, controller resizes,
node-elastic membership, the launcher CLI, the watchdog's hang-to-
recovery abort and `examples/elastic.py`'s kill-resume. Workers use the
port's store, faults, rendezvous, checkpoints and process groups, on the
CPU. The churn, multi-node and store-failover gangs are marked slow, as
the reference marks them.
"""

import os
import subprocess
import sys
import textwrap

import pytest

from pytorch_distributed_example_tpu_torch.elastic import (
    LocalElasticAgent,
    WorkerSpec,
    WorkerState,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _write(tmp_path, name, body):
    p = tmp_path / name
    p.write_text(textwrap.dedent(body))
    return str(p)


class TestAgent:
    def test_gang_success_and_env(self, tmp_path):
        script = _write(
            tmp_path,
            "ok.py",
            """
            import os
            out = os.environ["OUT_DIR"]
            r = os.environ["RANK"]
            with open(os.path.join(out, f"rank{r}.txt"), "w") as f:
                f.write("|".join([
                    os.environ["RANK"], os.environ["WORLD_SIZE"],
                    os.environ["MASTER_ADDR"], os.environ["MASTER_PORT"],
                    os.environ["TDX_RESTART_COUNT"],
                ]))
            """,
        )
        spec = WorkerSpec(
            entrypoint=[script],
            nproc_per_node=2,
            env={"OUT_DIR": str(tmp_path)},
        )
        res = LocalElasticAgent(spec).run()
        assert res.state is WorkerState.SUCCEEDED
        assert res.restarts == 0
        for r in range(2):
            fields = (tmp_path / f"rank{r}.txt").read_text().split("|")
            assert fields[0] == str(r)
            assert fields[1] == "2"
            assert int(fields[3]) > 0  # real store port
            assert fields[4] == "0"

    def test_restart_on_failure_then_success(self, tmp_path):
        # rank 1 fails on attempt 0, succeeds on attempt 1 (flag file)
        script = _write(
            tmp_path,
            "flaky.py",
            """
            import os, sys
            out = os.environ["OUT_DIR"]
            rank = os.environ["RANK"]
            attempt = int(os.environ["TDX_RESTART_COUNT"])
            if rank == "1" and attempt == 0:
                sys.exit(3)
            with open(os.path.join(out, f"done{rank}.txt"), "w") as f:
                f.write(str(attempt))
            """,
        )
        spec = WorkerSpec(
            entrypoint=[script],
            nproc_per_node=2,
            max_restarts=2,
            env={"OUT_DIR": str(tmp_path)},
        )
        res = LocalElasticAgent(spec).run()
        assert res.state is WorkerState.SUCCEEDED
        assert res.restarts == 1
        assert (tmp_path / "done0.txt").read_text() == "1"
        assert (tmp_path / "done1.txt").read_text() == "1"

    def test_gives_up_after_max_restarts(self, tmp_path):
        script = _write(tmp_path, "bad.py", "import sys; sys.exit(7)\n")
        spec = WorkerSpec(
            entrypoint=[script], nproc_per_node=2, max_restarts=1
        )
        res = LocalElasticAgent(spec).run()
        assert res.state is WorkerState.FAILED
        assert res.restarts == 1
        assert 7 in res.return_codes.values()

    def test_workers_share_agent_store(self, tmp_path):
        """Workers rendezvous through the agent-hosted TCPStore."""
        script = _write(
            tmp_path,
            "store_user.py",
            f"""
            import os, sys
            sys.path.insert(0, {REPO!r})
            from pytorch_distributed_example_tpu_torch.store import TCPStore
            host, port = os.environ["TDX_AGENT_STORE"].rsplit(":", 1)
            s = TCPStore(host, int(port), timeout=20.0)
            rank = os.environ["RANK"]
            s.set(f"hello/{{rank}}", rank.encode())
            s.wait([f"hello/0", f"hello/1"], 20.0)
            s.barrier(2, tag="t")
            s.close()
            """,
        )
        spec = WorkerSpec(entrypoint=[script], nproc_per_node=2)
        res = LocalElasticAgent(spec).run()
        assert res.state is WorkerState.SUCCEEDED


class TestDynamicWorldSize:
    """torchelastic --nnodes=MIN:MAX semantics (torch run.py:410,
    elastic/agent/server/api.py:455,952-970): worker loss re-forms the
    gang at the surviving size; late joiners are admitted at the next
    generation boundary. 4-rank gang -> kill one -> continues at 3 ->
    rejoin -> 4."""

    def _wait_for(self, predicate, timeout=60.0, what="condition"):
        import time

        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            if predicate():
                return
            time.sleep(0.05)
        raise AssertionError(f"timed out waiting for {what}")

    def test_shrink_on_kill_then_grow_on_join(self, tmp_path):
        import signal
        import threading
        import time

        from tests._mp_util import free_port

        from pytorch_distributed_example_tpu_torch.elastic import request_join

        # Worker: prove each generation's gang really coordinates at its
        # world size (store counter barrier), then idle until STOP.
        script = _write(
            tmp_path,
            "worker.py",
            f"""
            import os, sys, time
            sys.path.insert(0, {REPO!r})
            from pytorch_distributed_example_tpu_torch.store import TCPStore

            out = os.environ["OUT_DIR"]
            gen = os.environ["TDX_RESTART_COUNT"]
            rank = os.environ["RANK"]
            world = int(os.environ["WORLD_SIZE"])
            with open(os.path.join(out, f"pid_g{{gen}}_r{{rank}}"), "w") as f:
                f.write(str(os.getpid()))

            host, port = os.environ["TDX_AGENT_STORE"].rsplit(":", 1)
            s = TCPStore(host, int(port), timeout=30.0)
            s.add(f"gen{{gen}}/arrived", 1)
            deadline = time.monotonic() + 30
            while s.add(f"gen{{gen}}/arrived", 0) < world:
                if time.monotonic() > deadline:
                    sys.exit(5)
                time.sleep(0.02)
            # every member of THIS generation checked in at THIS size
            with open(os.path.join(out, f"sync_g{{gen}}_w{{world}}_r{{rank}}"), "w") as f:
                f.write("ok")
            s.close()
            stop = os.path.join(out, "STOP")
            while not os.path.exists(stop):
                time.sleep(0.02)
            """,
        )
        port = free_port()
        spec = WorkerSpec(
            entrypoint=[script],
            nproc_per_node=4,  # MAX
            min_nproc=2,       # MIN — --nnodes=2:4 semantics
            max_restarts=3,
            monitor_interval_s=0.05,
            master_port=port,
            env={"OUT_DIR": str(tmp_path)},
        )
        agent = LocalElasticAgent(spec)
        result = {}

        def run():
            result["res"] = agent.run()

        t = threading.Thread(target=run)
        t.start()
        try:
            # generation 0: full gang of 4 rendezvoused
            self._wait_for(
                lambda: all(
                    (tmp_path / f"sync_g0_w4_r{r}").exists() for r in range(4)
                ),
                what="gen0 gang of 4",
            )
            # kill one worker hard: the gang must re-form at 3
            pid = int((tmp_path / "pid_g0_r3").read_text())
            os.kill(pid, signal.SIGKILL)
            self._wait_for(
                lambda: all(
                    (tmp_path / f"sync_g1_w3_r{r}").exists() for r in range(3)
                ),
                what="gen1 gang of 3 (shrunk)",
            )
            assert agent.active_nproc == 3
            # a late joiner asks in; admitted at the next generation
            request_join("127.0.0.1", port)
            self._wait_for(
                lambda: all(
                    (tmp_path / f"sync_g2_w4_r{r}").exists() for r in range(4)
                ),
                what="gen2 gang of 4 (rejoined)",
            )
            assert agent.active_nproc == 4
        finally:
            (tmp_path / "STOP").write_text("1")
            t.join(timeout=60)
        assert not t.is_alive()
        res = result["res"]
        assert res.state is WorkerState.SUCCEEDED, res
        # one failure re-form + one join re-form = 2 generations past 0
        assert res.restarts == 2, res
        # the failure budget was charged once (joins are free)
        assert agent._failure_restarts == 1

    def test_controller_resize_shrinks_then_grows(self, tmp_path):
        """`request_resize` (the serve autoscaler's
        out-of-process path) re-forms the LOCAL elastic gang at the
        requested size at a generation boundary — shrink 4 -> 2, then
        grow 2 -> 3 — with targets clamped to [min_nproc,
        nproc_per_node] and the resize key consumed (no respawn loop)."""
        import threading

        from tests._mp_util import free_port

        from pytorch_distributed_example_tpu_torch.elastic import request_resize

        script = _write(
            tmp_path,
            "worker.py",
            f"""
            import os, sys, time
            sys.path.insert(0, {REPO!r})
            from pytorch_distributed_example_tpu_torch.store import TCPStore

            out = os.environ["OUT_DIR"]
            gen = os.environ["TDX_RESTART_COUNT"]
            rank = os.environ["RANK"]
            world = int(os.environ["WORLD_SIZE"])
            host, port = os.environ["TDX_AGENT_STORE"].rsplit(":", 1)
            s = TCPStore(host, int(port), timeout=30.0)
            s.add(f"gen{{gen}}/arrived", 1)
            deadline = time.monotonic() + 30
            while s.add(f"gen{{gen}}/arrived", 0) < world:
                if time.monotonic() > deadline:
                    sys.exit(5)
                time.sleep(0.02)
            with open(os.path.join(out, f"sync_g{{gen}}_w{{world}}_r{{rank}}"), "w") as f:
                f.write("ok")
            s.close()
            stop = os.path.join(out, "STOP")
            while not os.path.exists(stop):
                time.sleep(0.02)
            """,
        )
        port = free_port()
        spec = WorkerSpec(
            entrypoint=[script],
            nproc_per_node=4,  # MAX
            min_nproc=2,       # MIN
            max_restarts=3,
            monitor_interval_s=0.05,
            master_port=port,
            env={"OUT_DIR": str(tmp_path)},
        )
        agent = LocalElasticAgent(spec)
        result = {}

        def run():
            result["res"] = agent.run()

        t = threading.Thread(target=run)
        t.start()
        try:
            self._wait_for(
                lambda: all(
                    (tmp_path / f"sync_g0_w4_r{r}").exists() for r in range(4)
                ),
                what="gen0 gang of 4",
            )
            # controller asks for 1 — clamped to min_nproc=2
            request_resize("127.0.0.1", port, 1)
            self._wait_for(
                lambda: all(
                    (tmp_path / f"sync_g1_w2_r{r}").exists() for r in range(2)
                ),
                what="gen1 gang of 2 (controller shrink, clamped)",
            )
            assert agent.active_nproc == 2
            # grow back up mid-flight
            request_resize("127.0.0.1", port, 3)
            self._wait_for(
                lambda: all(
                    (tmp_path / f"sync_g2_w3_r{r}").exists() for r in range(3)
                ),
                what="gen2 gang of 3 (controller grow)",
            )
            assert agent.active_nproc == 3
        finally:
            (tmp_path / "STOP").write_text("1")
            t.join(timeout=60)
        assert not t.is_alive()
        res = result["res"]
        assert res.state is WorkerState.SUCCEEDED, res
        # two controller resizes = two generations past 0, and neither
        # consumed the FAILURE budget
        assert res.restarts == 2, res
        assert agent._failure_restarts == 0

    def test_below_min_fails(self, tmp_path):
        """Losing workers past MIN cannot meet quorum -> job fails."""
        script = _write(
            tmp_path,
            "die.py",
            """
            import os, sys, time
            if os.environ["RANK"] != "0":
                sys.exit(3)  # 3 of 4 die every generation
            time.sleep(30)
            """,
        )
        spec = WorkerSpec(
            entrypoint=[script],
            nproc_per_node=4,
            min_nproc=2,
            max_restarts=3,
            monitor_interval_s=0.05,
        )
        res = LocalElasticAgent(spec).run()
        assert res.state is WorkerState.FAILED

    def test_spec_validation(self):
        with pytest.raises(ValueError, match="single-node"):
            WorkerSpec(entrypoint=["x.py"], nnodes=2, min_nproc=1)
        with pytest.raises(ValueError, match="min_nproc"):
            WorkerSpec(entrypoint=["x.py"], nproc_per_node=2, min_nproc=3)


class TestNodeElastic:
    """NODE-level --nnodes=MIN:MAX (torchelastic's real semantics,
    torch run.py:410 + elastic/agent/server/api.py:455): agents
    heartbeat through the store; a dead agent's staleness re-forms the
    gang with the survivors at reassigned node ranks; a late-started
    agent is admitted at the next generation boundary."""

    WORKER = """
        import os, sys, time
        out = os.environ["OUT_DIR"]
        gen = os.environ["TDX_RESTART_COUNT"]
        world = os.environ["WORLD_SIZE"]
        rank = os.environ["RANK"]
        with open(os.path.join(out, f"run_g{gen}_w{world}_r{rank}"), "w") as f:
            f.write(os.environ["GROUP_RANK"])
        stop = os.path.join(out, "STOP")
        while not os.path.exists(stop):
            time.sleep(0.02)
        """

    def _spec(self, tmp_path, port, node_rank, **kw):
        script = _write(tmp_path, f"worker{node_rank}.py", self.WORKER)
        kw.setdefault("nnodes", 2)
        return WorkerSpec(
            entrypoint=[script],
            nproc_per_node=1,
            min_nnodes=1,
            node_rank=node_rank,
            master_port=port,
            monitor_interval_s=0.05,
            node_settle_s=0.4,
            heartbeat_timeout_s=1.0,
            max_restarts=3,
            env={"OUT_DIR": str(tmp_path)},
            **kw,
        )

    def _wait_for(self, predicate, timeout=60.0, what="condition"):
        import time

        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            if predicate():
                return
            time.sleep(0.05)
        raise AssertionError(f"timed out waiting for {what}")

    @pytest.mark.slow
    def test_node_loss_shrinks_then_join_grows(self, tmp_path):
        import threading

        from tests._mp_util import free_port

        port = free_port()
        agents = {n: LocalElasticAgent(self._spec(tmp_path, port, n)) for n in (0, 1)}
        results = {}
        threads = {
            n: threading.Thread(target=lambda n=n: results.update({n: agents[n].run()}))
            for n in agents
        }
        threads[0].start()
        threads[1].start()
        try:
            # generation 0: both nodes in, world 2
            self._wait_for(
                lambda: (tmp_path / "run_g0_w2_r0").exists()
                and (tmp_path / "run_g0_w2_r1").exists(),
                what="gen0 two-node gang",
            )
            # node 1 dies abruptly (agent + worker): heartbeat goes stale
            agents[1].abort()
            # node 0 must re-form ALONE (world 1) within the hb timeout
            self._wait_for(
                lambda: any(
                    (tmp_path / f"run_g{g}_w1_r0").exists() for g in (1, 2, 3)
                ),
                timeout=90.0,
                what="solo re-form after node loss",
            )
            assert agents[0].members == [0]
            # a REPLACEMENT node 1 starts late: admitted at next boundary
            agents[2] = LocalElasticAgent(self._spec(tmp_path, port, 1))
            threads[2] = threading.Thread(
                target=lambda: results.update({2: agents[2].run()})
            )
            threads[2].start()
            self._wait_for(
                lambda: any(
                    (tmp_path / f"run_g{g}_w2_r1").exists() for g in (2, 3, 4, 5)
                ),
                timeout=90.0,
                what="rejoined two-node gang",
            )
            assert sorted(agents[0].members) == [0, 1]
        finally:
            (tmp_path / "STOP").write_text("1")
            for t in threads.values():
                t.join(timeout=60)
        assert results[0].state is WorkerState.SUCCEEDED, results
        assert results[2].state is WorkerState.SUCCEEDED, results
        # membership changes were free; no local worker ever failed
        assert agents[0]._failure_restarts == 0

    @pytest.mark.slow
    def test_store_host_loss_fails_over_to_standby(self, tmp_path):
        """Beyond-torch: losing the rendezvous-store HOST (node 0) is
        survivable. Every agent runs a cold-standby store and gossips
        its endpoint in heartbeats; survivors converge on the first
        live standby in node-id order and re-form the gang there."""
        import threading

        from tests._mp_util import free_port

        port = free_port()
        agents = {
            n: LocalElasticAgent(self._spec(tmp_path, port, n, nnodes=3))
            for n in (0, 1, 2)
        }
        results = {}
        threads = {
            n: threading.Thread(
                target=lambda n=n: results.update({n: agents[n].run()})
            )
            for n in agents
        }
        for t in threads.values():
            t.start()
        try:
            self._wait_for(
                lambda: all(
                    (tmp_path / f"run_g0_w3_r{r}").exists() for r in range(3)
                ),
                what="gen0 three-node gang",
            )
            # node 0 — THE STORE HOST — dies abruptly; its run() teardown
            # closes the daemon like a host loss would
            agents[0].abort()
            threads[0].join(timeout=60)
            assert not threads[0].is_alive(), "node 0 did not die"
            # survivors must re-form on a promoted standby: world 2,
            # fresh group ranks
            self._wait_for(
                lambda: any(
                    (tmp_path / f"run_g{g}_w2_r0").exists()
                    and (tmp_path / f"run_g{g}_w2_r1").exists()
                    for g in range(1, 8)
                ),
                timeout=120.0,
                what="re-form on the standby store",
            )
            assert sorted(agents[1].members) == [1, 2]
        finally:
            (tmp_path / "STOP").write_text("1")
            for t in threads.values():
                t.join(timeout=90)
        assert results[1].state is WorkerState.SUCCEEDED, results
        assert results[2].state is WorkerState.SUCCEEDED, results
        # both survivors actually moved off the dead endpoint
        for n in (1, 2):
            assert agents[n].failovers >= 1, f"node {n} never failed over"
            assert agents[n]._active_master != ("127.0.0.1", port)
        # failover was a membership event, not a worker failure
        assert agents[1]._failure_restarts == 0

    @pytest.mark.slow
    def test_multi_address_gang_fails_over_across_hosts(self, tmp_path):
        """Two-'host' proof without a second machine : each agent lives on its OWN loopback address (127.0.0.2/3/4
        — Linux answers for all of 127/8), so rendezvous, heartbeat
        gossip and standby adoption all cross real address boundaries:
        node 1 must dial node 0's store at 127.0.0.2 (not self), and
        after the store host dies, survivors must converge on the
        standby GOSSIPED at 127.0.0.3 — an address they can only have
        learned from the heartbeat endpoint, not from any local
        default. Models gloo's cross-host full-mesh
        (ProcessGroupGloo.hpp:48+) at the agent layer."""
        import threading

        from tests._mp_util import free_port

        port = free_port()
        hosts = {0: "127.0.0.2", 1: "127.0.0.3", 2: "127.0.0.4"}
        agents = {
            n: LocalElasticAgent(
                self._spec(
                    tmp_path, port, n, nnodes=3,
                    master_addr=hosts[0],
                    advertise_addr=hosts[n],
                )
            )
            for n in (0, 1, 2)
        }
        results = {}
        threads = {
            n: threading.Thread(
                target=lambda n=n: results.update({n: agents[n].run()})
            )
            for n in agents
        }
        for t in threads.values():
            t.start()
        try:
            self._wait_for(
                lambda: all(
                    (tmp_path / f"run_g0_w3_r{r}").exists() for r in range(3)
                ),
                what="gen0 gang across three loopback addresses",
            )
            # the whole gang rendezvoused on node 0's non-default address
            for n in (1, 2):
                assert agents[n]._active_master[0] == hosts[0]
            agents[0].abort()  # the store HOST at 127.0.0.2 dies
            threads[0].join(timeout=60)
            self._wait_for(
                lambda: any(
                    (tmp_path / f"run_g{g}_w2_r0").exists()
                    and (tmp_path / f"run_g{g}_w2_r1").exists()
                    for g in range(1, 8)
                ),
                timeout=120.0,
                what="re-form on the standby across addresses",
            )
        finally:
            (tmp_path / "STOP").write_text("1")
            for t in threads.values():
                t.join(timeout=90)
        for n in (1, 2):
            assert results[n].state is WorkerState.SUCCEEDED, results
            # survivors converged on node 1's ADVERTISED address — the
            # id-ordered adoption walk promotes the lowest live node's
            # standby, and its endpoint traveled via heartbeat gossip
            assert agents[n].failovers >= 1
            assert agents[n]._active_master[0] == hosts[1], (
                agents[n]._active_master
            )

    def test_spec_validation(self):
        with pytest.raises(ValueError, match="explicit master"):
            WorkerSpec(entrypoint=["x"], nnodes=2, min_nnodes=1)
        with pytest.raises(ValueError, match="nnodes"):
            WorkerSpec(
                entrypoint=["x"], nnodes=1, min_nnodes=1, master_port=1234
            )
        with pytest.raises(ValueError, match="ambiguous"):
            WorkerSpec(
                entrypoint=["x"],
                nnodes=2,
                min_nnodes=1,
                nproc_per_node=4,
                min_nproc=2,
                master_port=1234,
            )

    def test_cli_maps_rdzv_range_to_node_elastic(self):
        from pytorch_distributed_example_tpu_torch.elastic.run import parse_args

        a = parse_args(
            ["--nnodes", "1:4", "--rdzv-endpoint", "10.0.0.1:29500", "x.py"]
        )
        assert a.nnodes == (1, 4)

    def test_below_min_retries_within_grace_then_fatal(self, tmp_path):
        """min_nnodes=2 with only one node present: the agent keeps
        re-forming through the quorum grace window (peers may be mid-
        teardown) and only then declares the job fatal — torchelastic
        waits a join timeout for min nodes the same way."""
        import time

        from tests._mp_util import free_port

        script = _write(tmp_path, "w.py", "import time; time.sleep(60)\n")
        spec = WorkerSpec(
            entrypoint=[script],
            nproc_per_node=1,
            nnodes=2,
            min_nnodes=2,  # quorum of 2; only one agent will exist
            node_rank=0,
            master_port=free_port(),
            monitor_interval_s=0.05,
            node_settle_s=0.2,
            heartbeat_timeout_s=1.0,
            quorum_grace_s=2.0,
            env={"OUT_DIR": str(tmp_path)},
        )
        agent = LocalElasticAgent(spec)
        t0 = time.monotonic()
        res = agent.run()
        elapsed = time.monotonic() - t0
        assert res.state is WorkerState.FAILED
        # it kept retrying for ~the grace window, not instant-fatal
        assert elapsed >= 2.0, elapsed
        # and never started workers below quorum
        assert not agent._workers

    def test_stale_join_key_is_dropped_not_looping(self, tmp_path):
        """A join key from a crashed joiner (stale timestamp) must be
        garbage-collected by the leader, not trigger endless re-forms."""
        import threading
        import time

        from tests._mp_util import free_port

        from pytorch_distributed_example_tpu_torch.store import TCPStore

        script = _write(
            tmp_path,
            "w.py",
            """
            import os, time
            out = os.environ["OUT_DIR"]
            open(os.path.join(out,
                f"gen{os.environ['TDX_RESTART_COUNT']}"), "w").write("1")
            while not os.path.exists(os.path.join(out, "STOP")):
                time.sleep(0.02)
            """,
        )
        port = free_port()
        spec = WorkerSpec(
            entrypoint=[script],
            nproc_per_node=1,
            nnodes=2,
            min_nnodes=1,
            node_rank=0,
            master_port=port,
            monitor_interval_s=0.05,
            node_settle_s=0.2,
            heartbeat_timeout_s=1.0,
            env={"OUT_DIR": str(tmp_path)},
        )
        agent = LocalElasticAgent(spec)
        result = {}
        t = threading.Thread(target=lambda: result.update(r=agent.run()))
        t.start()
        try:
            deadline = time.monotonic() + 30
            while not (tmp_path / "gen0").exists():
                assert time.monotonic() < deadline
                time.sleep(0.05)
            # a "joiner" that died long ago: stale timestamp
            c = TCPStore("127.0.0.1", port, timeout=20.0)
            try:
                c.set("agent/join_node/1", str(time.time() - 3600))
                time.sleep(1.5)  # several monitor passes
                # leader dropped the stale key instead of re-forming
                assert not c.check(["agent/join_node/1"])
                assert agent.restart_count == 0, "stale join caused a re-form"
            finally:
                c.close()
        finally:
            (tmp_path / "STOP").write_text("1")
            t.join(timeout=30)
        assert result["r"].state is WorkerState.SUCCEEDED


@pytest.mark.slow
class TestElasticChurn:
    """Randomized kill/join churn against the worker-elastic agent: the
    gang must re-form after every event and the job must still complete.
    Catches liveness bugs the targeted shrink/grow tests can't."""

    def test_survives_randomized_churn(self, tmp_path):
        import random
        import signal
        import threading
        import time

        from tests._mp_util import free_port

        from pytorch_distributed_example_tpu_torch.elastic import request_join

        script = _write(
            tmp_path,
            "w.py",
            f"""
            import os, sys, time
            sys.path.insert(0, {REPO!r})
            from pytorch_distributed_example_tpu_torch.store import TCPStore

            out = os.environ["OUT_DIR"]
            gen = os.environ["TDX_RESTART_COUNT"]
            rank = os.environ["RANK"]
            world = int(os.environ["WORLD_SIZE"])
            with open(os.path.join(out, f"pid_g{{gen}}_r{{rank}}"), "w") as f:
                f.write(str(os.getpid()))
            host, port = os.environ["TDX_AGENT_STORE"].rsplit(":", 1)
            s = TCPStore(host, int(port), timeout=30.0)
            s.add(f"gen{{gen}}/in", 1)
            deadline = time.monotonic() + 30
            while s.add(f"gen{{gen}}/in", 0) < world:
                if time.monotonic() > deadline:
                    sys.exit(5)
                time.sleep(0.02)
            with open(os.path.join(out, f"sync_g{{gen}}_r{{rank}}"), "w") as f:
                f.write(str(world))
            s.close()
            while not os.path.exists(os.path.join(out, "STOP")):
                time.sleep(0.02)
            """,
        )
        port = free_port()
        spec = WorkerSpec(
            entrypoint=[script],
            nproc_per_node=4,
            min_nproc=2,
            max_restarts=10,
            monitor_interval_s=0.05,
            master_port=port,
            env={"OUT_DIR": str(tmp_path)},
        )
        agent = LocalElasticAgent(spec)
        result = {}
        t = threading.Thread(target=lambda: result.update(r=agent.run()))
        t.start()

        def gen_world(g):
            """world recorded by generation g's sync files (per-rank
            names: a shared file could be read mid-truncation)."""
            for p in tmp_path.glob(f"sync_g{g}_r*"):
                txt = p.read_text()
                if txt:
                    return int(txt)
            return None

        def wait_converged(after_gen, expect, timeout=45.0):
            """The gang must re-form at `expect` within a couple of
            generations (a churn event racing a re-form can legitimately
            consume two). Returns the generation that converged."""
            deadline = time.monotonic() + timeout
            seen = {}
            while time.monotonic() < deadline:
                for g in range(after_gen + 1, after_gen + 3):
                    w = gen_world(g)
                    if w is not None:
                        seen[g] = w
                        if w == expect:
                            return g
                time.sleep(0.05)
            raise AssertionError(
                f"no generation after {after_gen} converged to "
                f"{expect}; saw {seen}, agent gen {agent.restart_count}, "
                f"active {agent.active_nproc}"
            )

        rng = random.Random(7)
        try:
            deadline = time.monotonic() + 45
            while gen_world(0) is None:
                assert time.monotonic() < deadline
                time.sleep(0.05)
            world, gen = 4, 0
            for _ in range(4):
                if world > spec.min_nproc and (
                    world >= spec.nproc_per_node or rng.random() < 0.5
                ):
                    # kill a random live worker -> shrink
                    victim = rng.randrange(world)
                    pid = int((tmp_path / f"pid_g{gen}_r{victim}").read_text())
                    os.kill(pid, signal.SIGKILL)
                    expect = world - 1
                else:
                    # join -> grow
                    request_join("127.0.0.1", port)
                    expect = world + 1
                gen = wait_converged(gen, expect)
                world = expect
        finally:
            (tmp_path / "STOP").write_text("1")
            t.join(timeout=90)
        assert not t.is_alive()
        assert result["r"].state is WorkerState.SUCCEEDED, result


class TestElasticTrainingExample:
    """`examples/elastic.py` end to end: real DDP training under the
    elastic agent, a worker killed mid-run, the gang re-forms smaller,
    and training RESUMES from the checkpoint instead of restarting —
    the torchelastic canonical workflow."""

    def test_kill_resume_completes(self, tmp_path):
        import json
        import threading
        import time

        ckpt = tmp_path / "ckpt"
        spec = WorkerSpec(
            entrypoint=[
                "pytorch_distributed_example_tpu_torch.examples.elastic",
                "--steps", "60",
                "--ckpt-every", "10",
                "--ckpt", str(ckpt),
                "--batch-size", "8",
                "--cpu",
            ],
            module=True,
            nproc_per_node=2,
            min_nproc=1,
            max_restarts=3,
            monitor_interval_s=0.05,
            env={
                "PYTHONPATH": REPO + os.pathsep + os.environ.get("PYTHONPATH", ""),
                "OMP_NUM_THREADS": "1",
            },
        )
        agent = LocalElasticAgent(spec, log_dir=str(tmp_path / "logs"))
        result = {}
        t = threading.Thread(target=lambda: result.update(r=agent.run()))
        t.start()
        try:
            # wait for the first checkpoint, proving training progressed
            deadline = time.monotonic() + 240
            while time.monotonic() < deadline:
                if (ckpt / "meta.json").exists():
                    break
                time.sleep(0.2)
            assert (ckpt / "meta.json").exists(), "no checkpoint within 240s"
            # kill one worker hard mid-training
            victim = agent._workers[1].proc
            victim.kill()
        finally:
            t.join(timeout=420)
        assert not t.is_alive(), "elastic training did not finish"
        assert result["r"].state is WorkerState.SUCCEEDED, result
        # the job completed the FULL step target across generations
        meta = json.loads((ckpt / "meta.json").read_text())
        assert meta["step"] == 60, meta
        # and it actually took a restart to get there
        assert result["r"].restarts >= 1, result


class TestHangRecovery:
    """Watchdog → elastic composition : a worker
    wedged inside a collective must be aborted by the in-process
    watchdog (flight-recorder dump + nonzero exit), after which the
    agent re-forms the gang and training resumes from checkpoint —
    torch's ProcessGroupNCCL.hpp:676 watchdog abort composed with
    elastic/agent/server/api.py:952 restart."""

    WORKER = """
    import json, os, sys, time
    import torch
    import pytorch_distributed_example_tpu_torch as tdx

    out = os.environ["OUT_DIR"]
    tdx.init_process_group(backend="gloo", init_method="env://", device="cpu")
    rank, world = tdx.get_rank(), tdx.get_world_size()
    gen = int(os.environ["TDX_RESTART_COUNT"])
    # the elastic-agent default wiring, not a test-local setup:
    assert tdx.distributed._get_default_group().watchdog is not None, \\
        "watchdog not enabled by default under the elastic agent"

    ckpt = os.path.join(out, "ckpt.json")
    start = 0
    if os.path.exists(ckpt):
        with open(ckpt) as f:
            start = json.load(f)["step"]

    TARGET, HANG_AT = 10, 5
    for step in range(start, TARGET):
        if gen == 0 and rank == 1 and step == HANG_AT:
            # a WEDGED peer: stops participating but does not exit —
            # exactly the failure the PG timeout would otherwise sit on
            with open(os.path.join(out, "wedged.txt"), "w") as f:
                f.write("1")
            time.sleep(3600)
        t = tdx.DistTensor.from_process_local(torch.tensor([float(step)]))
        tdx.all_reduce(t)
        val = float(t.local_numpy()[0][0])
        assert val == step * world, (val, step, world)
        if rank == 0:
            with open(ckpt + ".tmp", "w") as f:
                json.dump({"step": step + 1}, f)
            os.replace(ckpt + ".tmp", ckpt)
    tdx.destroy_process_group()
    with open(os.path.join(out, f"done_r{rank}_g{gen}.txt"), "w") as f:
        f.write(str(start))
    """

    def test_hung_collective_aborts_and_gang_recovers(self, tmp_path):
        import glob
        import json

        script = _write(tmp_path, "hangworker.py", self.WORKER)
        dumps = tmp_path / "dumps"
        spec = WorkerSpec(
            entrypoint=[script],
            nproc_per_node=2,
            max_restarts=2,
            monitor_interval_s=0.1,
            env={
                "OUT_DIR": str(tmp_path),
                "PYTHONPATH": REPO + os.pathsep + os.environ.get("PYTHONPATH", ""),
                "OMP_NUM_THREADS": "1",
                # must beat the hang quickly but sit ABOVE a loaded
                # host's slowest healthy collective
                "TDX_WATCHDOG_TIMEOUT_S": "6",
                "TDX_DEBUG_DIR": str(dumps),
            },
        )
        res = LocalElasticAgent(spec, log_dir=str(tmp_path / "logs")).run()
        # the gang recovered and finished the full step target
        assert res.state is WorkerState.SUCCEEDED, res
        assert res.restarts >= 1, "no restart: the hang was never detected"
        with open(tmp_path / "ckpt.json") as f:
            assert json.load(f)["step"] == 10
        # generation 1 resumed FROM THE CHECKPOINT, not from scratch
        assert (tmp_path / "done_r0_g1.txt").read_text() == "5"
        assert (tmp_path / "wedged.txt").exists()
        # the aborting rank dumped the flight recorder naming the hang
        dump_files = glob.glob(str(dumps / "tdx_flight_*.json"))
        assert dump_files, "watchdog did not dump the flight recorder"
        reasons = [json.load(open(p)).get("reason", "") for p in dump_files]
        assert any("watchdog timeout" in r for r in reasons), reasons


class TestRunCLI:
    def test_tpurun_end_to_end(self, tmp_path):
        script = _write(
            tmp_path,
            "hello.py",
            """
            import os
            print("rank", os.environ["RANK"], "of", os.environ["WORLD_SIZE"])
            """,
        )
        out = subprocess.run(
            [
                sys.executable,
                "-m",
                "pytorch_distributed_example_tpu_torch.elastic.run",
                "--nproc-per-node",
                "2",
                script,
            ],
            capture_output=True,
            text=True,
            timeout=120,
            cwd=REPO,
        )
        assert out.returncode == 0, out.stderr

    def test_tpurun_missing_entrypoint(self):
        out = subprocess.run(
            [
                sys.executable,
                "-m",
                "pytorch_distributed_example_tpu_torch.elastic.run",
                "--nproc-per-node",
                "1",
            ],
            capture_output=True,
            text=True,
            timeout=60,
            cwd=REPO,
        )
        assert out.returncode == 2
        assert "missing entrypoint" in out.stderr


class TestMultiNodeLaunch:
    """torchrun --nnodes/--node-rank parity: two agents on one host play
    two nodes; global RANK/WORLD_SIZE spans both; node 0 hosts the store;
    workers run a real cross-process collective through
    init_process_group(env://)."""

    @pytest.mark.slow
    def test_two_node_launch_end_to_end(self, tmp_path):
        import threading

        from tests._mp_util import free_port

        script = _write(
            tmp_path,
            "worker.py",
            """
            import os
            import torch
            import pytorch_distributed_example_tpu_torch as tdx

            # env:// under the agent (launcher contract)
            tdx.init_process_group(backend="gloo", init_method="env://", device="cpu")
            rank, world = tdx.get_rank(), tdx.get_world_size()
            assert world == 2, world
            assert rank == int(os.environ["RANK"])
            t = tdx.DistTensor.from_process_local(torch.tensor([rank + 1.0]))
            tdx.all_reduce(t)
            assert t.local_numpy()[0][0] == 3.0, t.local_numpy()
            tdx.destroy_process_group()
            """,
        )
        port = free_port()
        results = {}

        def node(node_rank):
            spec = WorkerSpec(
                entrypoint=[script],
                nproc_per_node=1,
                nnodes=2,
                node_rank=node_rank,
                master_port=port,
                max_restarts=0,
                env={
                    "PYTHONPATH": REPO
                    + os.pathsep
                    + os.environ.get("PYTHONPATH", ""),
                    "OMP_NUM_THREADS": "1",
                },
            )
            results[node_rank] = LocalElasticAgent(
                spec, log_dir=str(tmp_path / f"logs{node_rank}")
            ).run()

        threads = [threading.Thread(target=node, args=(n,)) for n in (0, 1)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=180)
        for n in (0, 1):
            assert results[n].state is WorkerState.SUCCEEDED, (
                n,
                results[n],
                [
                    open(os.path.join(str(tmp_path / f"logs{n}"), f)).read()[-1500:]
                    for f in os.listdir(str(tmp_path / f"logs{n}"))
                ],
            )

    def test_node_rank_nonzero_requires_port(self):
        spec = WorkerSpec(entrypoint=["x.py"], nnodes=2, node_rank=1, master_port=0)
        agent = LocalElasticAgent(spec)
        with pytest.raises(ValueError, match="explicit master/rdzv port"):
            agent._ensure_store()

    def test_cli_flags_parse(self):
        from pytorch_distributed_example_tpu_torch.elastic.run import parse_args

        a = parse_args(
            [
                "--nnodes", "4", "--node-rank", "2",
                "--rdzv-endpoint", "10.0.0.1:29500",
                "--nproc-per-node", "8", "-m", "train.main", "--lr", "0.1",
            ]
        )
        assert a.nnodes == (4, 4) and a.node_rank == 2
        assert a.nproc_per_node == (8, 8)
        assert a.rdzv_endpoint == "10.0.0.1:29500"
        assert a.module and a.entrypoint == ["train.main", "--lr", "0.1"]

    def test_cli_elastic_range_parse(self):
        from pytorch_distributed_example_tpu_torch.elastic.run import parse_args

        a = parse_args(["--nnodes", "1:4", "x.py"])
        assert a.nnodes == (1, 4)
        a = parse_args(["--nproc-per-node", "2:8", "x.py"])
        assert a.nproc_per_node == (2, 8)

    @pytest.mark.slow
    def test_multi_node_restart_propagates(self, tmp_path):
        """A worker failure on ONE node must restart the WHOLE cluster
        (peers' workers are wedged in dead collectives); the gang succeeds
        on the retry and both agents agree on the generation."""
        import threading

        from tests._mp_util import free_port

        marker = tmp_path / "first_attempt_done"
        script = _write(
            tmp_path,
            "worker.py",
            """
            import os, sys
            import torch
            import pytorch_distributed_example_tpu_torch as tdx

            marker = os.environ["FAIL_MARKER"]
            rank = int(os.environ["RANK"])
            if rank == 1 and not os.path.exists(marker):
                open(marker, "w").write("x")
                sys.exit(7)  # first attempt: node 1's worker dies

            tdx.init_process_group(backend="gloo", init_method="env://", device="cpu")
            t = tdx.DistTensor.from_process_local(torch.tensor([tdx.get_rank() + 1.0]))
            tdx.all_reduce(t)
            assert t.local_numpy()[0][0] == 3.0
            tdx.destroy_process_group()
            """,
        )
        port = free_port()
        results = {}

        def node(node_rank):
            spec = WorkerSpec(
                entrypoint=[script],
                nproc_per_node=1,
                nnodes=2,
                node_rank=node_rank,
                master_port=port,
                max_restarts=2,
                monitor_interval_s=0.05,
                env={
                    "PYTHONPATH": REPO
                    + os.pathsep
                    + os.environ.get("PYTHONPATH", ""),
                    "OMP_NUM_THREADS": "1",
                    "FAIL_MARKER": str(marker),
                },
            )
            results[node_rank] = LocalElasticAgent(
                spec, log_dir=str(tmp_path / f"rlogs{node_rank}")
            ).run()

        threads = [threading.Thread(target=node, args=(n,)) for n in (0, 1)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=240)
        for n in (0, 1):
            assert results[n].state is WorkerState.SUCCEEDED, (n, results[n])
            assert results[n].restarts == 1, results[n]

    @pytest.mark.slow
    def test_peer_failure_after_local_success_rejoins(self, tmp_path):
        """A node whose workers already exited 0 must wait on the control
        plane and REJOIN the gang when a peer fails afterwards (it cannot
        tear down the shared store under the restart)."""
        import threading

        from tests._mp_util import free_port

        marker = tmp_path / "late_fail_done"
        script = _write(
            tmp_path,
            "worker.py",
            """
            import os, sys, time
            rank = int(os.environ["RANK"])
            marker = os.environ["FAIL_MARKER"]
            if rank == 0:
                sys.exit(0)  # node 0 finishes instantly, every generation
            # node 1: fail AFTER node 0 succeeded (gen 0 only)
            if not os.path.exists(marker):
                open(marker, "w").write("x")
                time.sleep(1.5)
                sys.exit(9)
            sys.exit(0)
            """,
        )
        port = free_port()
        results = {}

        def node(node_rank):
            spec = WorkerSpec(
                entrypoint=[script],
                nproc_per_node=1,
                nnodes=2,
                node_rank=node_rank,
                master_port=port,
                max_restarts=2,
                monitor_interval_s=0.05,
                env={"FAIL_MARKER": str(marker)},
            )
            results[node_rank] = LocalElasticAgent(spec).run()

        threads = [threading.Thread(target=node, args=(n,)) for n in (0, 1)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        for n in (0, 1):
            assert results[n].state is WorkerState.SUCCEEDED, (n, results[n])
            assert results[n].restarts == 1, results[n]
