"""The port's chaos matrix, held to the reference's `tests/test_chaos.py`:
drive the port's elastic agent through TDX_FAULT_PLAN scripts covering
four distinct fault classes —

  1. store connection resets      (transient: absorbed by client retry)
  2. rendezvous join timeout      (fatal for the worker: elastic restart)
  3. rank crash mid-step          (elastic restart + checkpoint resume)
  4. kill mid-checkpoint-write    (atomicity: last-good stays loadable)

— and assert the system recovers in each: the gang re-forms and training
resumes with EXACT loss continuity (the loss history rides the
checkpoint, so any skipped/replayed step would corrupt it), and a
corrupted checkpoint is detected by CRC with fallback to the last-good
copy.

Workers are real subprocesses running a deterministic mini training
loop: per step they publish/await store keys (store client traffic),
fire the `train.step` fault point, and rank 0 checkpoints params + the
loss history via the atomic integrity layer. Quick tier: the loop is
numpy-only, world size 2, seconds per scenario.

Then the serve plane's recovery contract (the reference's
`TestServeChaosRecovery`): a serving rank's crash, and a peer's crash
under a drain grace, both resize the gang 2 -> 1, and the merged
completions equal an uninterrupted run token for token, with one
measured restore. The port's engine serves in the worker and in the
in-process reference, from the same torch-seeded weights.
"""

import json
import os
import sys
import textwrap
import warnings

import numpy as np
import pytest

from pytorch_distributed_example_tpu_torch.checkpoint import (
    last_good_path,
    load_checkpoint,
    verify_checkpoint,
)
from pytorch_distributed_example_tpu_torch.elastic import (
    LocalElasticAgent,
    WorkerSpec,
    WorkerState,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEPS = 6


def _reference_losses():
    return [round(1.0 / (1 + s), 6) for s in range(STEPS)]


_WORKER = """
import json, os, sys
sys.path.insert(0, {repo!r})
import numpy as np
from pytorch_distributed_example_tpu_torch import faults
from pytorch_distributed_example_tpu_torch.checkpoint import (
    load_checkpoint, save_checkpoint,
)
from pytorch_distributed_example_tpu_torch.rendezvous import rendezvous

rank = int(os.environ["RANK"])
world = int(os.environ["WORLD_SIZE"])
out = os.environ["OUT_DIR"]
steps = int(os.environ["STEPS"])
ckpt = os.path.join(out, "ckpt")

# rendezvous through the agent-hosted store (fault point rendezvous.join)
store, _, _ = next(iter(rendezvous(
    "env://", rank, world,
    timeout=float(os.environ.get("RDZV_TIMEOUT", "30")),
)))

# rank 0 resumes from the (verified) checkpoint and publishes the start
# step; everyone else reads it — one resume decision per generation
params = {{"w": np.zeros(4)}}
history = []
if rank == 0:
    start = 0
    try:
        params, _, s, extra = load_checkpoint(ckpt, params)
        start = s + 1
        history = list(extra["history"])
    except FileNotFoundError:
        pass
    store.set("start", str(start).encode())
else:
    start = int(store.get("start").decode())

for step in range(start, steps):
    faults.fire("train.step", rank=rank)
    loss = round(1.0 / (1 + step), 6)
    # per-step store traffic (fault points store.set / store.check)
    store.set(f"step/{{step}}/{{rank}}", str(loss).encode())
    store.wait([f"step/{{step}}/{{r}}" for r in range(world)], 30.0)
    if rank == 0:
        history.append(loss)
        params = {{"w": params["w"] + loss}}
        save_checkpoint(ckpt, params, step=step,
                        extra={{"history": history}})

if rank == 0:
    with open(os.path.join(out, "final_history.json"), "w") as f:
        json.dump(history, f)
store.close()
"""


def _run_gang(tmp_path, plan, max_restarts=2, extra_env=None):
    script = tmp_path / "worker.py"
    script.write_text(textwrap.dedent(_WORKER.format(repo=REPO)))
    env = {
        "OUT_DIR": str(tmp_path),
        "STEPS": str(STEPS),
        "TDX_FAULT_PLAN": json.dumps(plan),
        "PYTHONPATH": REPO + os.pathsep + os.environ.get("PYTHONPATH", ""),
        "OMP_NUM_THREADS": "1",
    }
    env.update(extra_env or {})
    spec = WorkerSpec(
        entrypoint=[str(script)],
        nproc_per_node=2,
        max_restarts=max_restarts,
        env=env,
    )
    agent = LocalElasticAgent(spec)
    res = agent.run()
    return res


def _final_history(tmp_path):
    with open(tmp_path / "final_history.json") as f:
        return json.load(f)


class TestChaosMatrix:
    def test_store_connection_reset_absorbed_by_retry(self, tmp_path):
        """Transient resets on rank 1's store ops: the retry layer
        recovers in-place — training completes with ZERO restarts."""
        res = _run_gang(
            tmp_path,
            [{"point": "store.check", "rank": 1, "after": 2, "times": 3,
              "action": "reset"}],
        )
        assert res.state is WorkerState.SUCCEEDED
        assert res.restarts == 0  # recovery below the elastic layer
        assert _final_history(tmp_path) == pytest.approx(_reference_losses())

    def test_rendezvous_join_timeout_recovered_by_restart(self, tmp_path):
        """Rank 1's rendezvous joins all drop in generation 0: its join
        retries back off until the deadline, it fails fast, and the
        agent re-forms the gang; generation 1 joins cleanly."""
        res = _run_gang(
            tmp_path,
            [{"point": "rendezvous.join", "rank": 1, "action": "drop",
              "times": -1, "restart_lt": 1}],
            extra_env={"RDZV_TIMEOUT": "2"},
        )
        assert res.state is WorkerState.SUCCEEDED
        assert res.restarts >= 1
        assert _final_history(tmp_path) == pytest.approx(_reference_losses())

    def test_rank_crash_mid_step_resumes_from_checkpoint(self, tmp_path):
        """Rank 1 crashes on its 3rd training step in generation 0; the
        re-formed gang resumes from rank 0's checkpoint and the loss
        history is EXACTLY the no-fault sequence (continuity)."""
        res = _run_gang(
            tmp_path,
            [{"point": "train.step", "rank": 1, "after": 3,
              "action": "crash", "restart_lt": 1}],
        )
        assert res.state is WorkerState.SUCCEEDED
        assert res.restarts >= 1
        assert _final_history(tmp_path) == pytest.approx(_reference_losses())

    def test_kill_mid_checkpoint_write_then_corruption_fallback(self, tmp_path):
        """Rank 0 is killed during its second checkpoint's finalize
        (atomic-rename pending): the live checkpoint stays the verified
        first save, the gang re-forms and finishes with exact
        continuity. Then the live checkpoint is byte-corrupted and a
        load detects it by CRC, quarantines it, and falls back to the
        last-good copy."""
        res = _run_gang(
            tmp_path,
            [{"point": "checkpoint.finalize", "rank": 0, "after": 2,
              "action": "crash", "restart_lt": 1}],
        )
        assert res.state is WorkerState.SUCCEEDED
        assert res.restarts >= 1
        assert _final_history(tmp_path) == pytest.approx(_reference_losses())
        # the killed write's tmp dir was left behind and never loaded
        assert any(".tmp." in n for n in os.listdir(tmp_path))

        ckpt = str(tmp_path / "ckpt")
        ok, detail = verify_checkpoint(ckpt)
        assert ok, detail
        # corrupt the live checkpoint -> CRC detection + .prev fallback
        with open(os.path.join(ckpt, "arrays.npz"), "r+b") as f:
            f.seek(40)
            f.write(b"\xde\xad\xbe\xef")
        assert os.path.isdir(last_good_path(ckpt))
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            _, _, step, extra = load_checkpoint(ckpt, {"w": np.zeros(4)})
        assert step == STEPS - 2  # last-good = one checkpoint interval back
        assert extra["history"] == pytest.approx(_reference_losses()[:-1])
        assert any("corrupt" in str(x.message) for x in w)
        assert any("quarantine" in n for n in os.listdir(tmp_path))


_SERVE_WORKER = """
import json, os, sys, time
sys.path.insert(0, {repo!r})
import numpy as np

rank = int(os.environ["RANK"])
world = int(os.environ["WORLD_SIZE"])
out = os.environ["OUT_DIR"]
gen = int(os.environ.get("TDX_RESTART_COUNT", "0"))

from pytorch_distributed_example_tpu_torch import faults
from pytorch_distributed_example_tpu_torch.rendezvous import rendezvous

store, _, _ = next(iter(rendezvous("env://", rank, world, timeout=30.0)))

if rank != 0:
    # non-serving gang member. Wait until the serving rank has cut its
    # first checkpoint before firing train.step (the drain scenario's
    # crash target): a peer crash during rank 0's cold compile would
    # exhaust the drain grace before there is anything to drain, and
    # the scenario under test is "drain DURING live serving".
    while not store.check(["serve/started"]):
        if store.check(["serve/all_done"]):
            store.close()
            sys.exit(0)
        time.sleep(0.05)
    while True:
        faults.fire("train.step", rank=rank)
        if store.check(["serve/all_done"]):
            store.close()
            sys.exit(0)
        time.sleep(0.05)

# rank 0: the serving plane. torch's serving stack only here.
from pytorch_distributed_example_tpu_torch.serve import ServeEngine
from pytorch_distributed_example_tpu_torch.serve.elastic import (
    drain_requested, load_serve_state, restore_into, save_serve_state,
)
sys.path.insert(0, os.path.join({repo!r}, "tests"))
from test_torch_chaos import serve_model

engine = ServeEngine(serve_model(), slots=2, min_bucket=4,
                     clock=time.time)

state, from_gen = load_serve_state(store)
if state is not None:
    # re-formed gang (possibly at a DIFFERENT world size): serve the
    # checkpointed queue, never resubmit
    restore_into(engine, state, generation=from_gen)
else:
    gen0 = np.random.default_rng(42)
    for i, (L, budget) in enumerate(
        [(5, 5), (7, 4), (4, 6), (6, 5), (8, 4), (5, 6)]
    ):
        engine.submit(gen0.integers(0, 64, (L,)).astype(np.int32),
                      budget, rid=f"r{{i}}", seed=i,
                      klass="")

done = set()
comp_path = os.path.join(out, "completions.jsonl")

def flush_completions():
    with open(comp_path, "a") as f:
        for rid, c in engine.completions.items():
            if rid not in done:
                done.add(rid)
                f.write(json.dumps({{"rid": rid, "tokens": c.tokens,
                                     "gen": gen}}) + "\\n")

while True:
    worked = engine.step()
    # pace the loop: the eager tiny model serves the whole trace in well
    # under the peer's crash delay, and the scenario is a drain DURING
    # live serving
    time.sleep(0.05)
    flush_completions()
    # periodic incarnation-scoped checkpoint: a crash between
    # checkpoints costs only the replay the snapshot already covers
    save_serve_state(store, gen, engine.snapshot_state())
    store.set("serve/started", b"1")  # distlint: disable=R007 -- test-gang sequencing marker, store is throwaway
    if drain_requested(store, gen):
        save_serve_state(store, gen, engine.drain())
        store.close()
        sys.exit(0)  # drained: the agent re-forms the gang
    if not worked:
        break

with open(os.path.join(out, "metrics.json"), "w") as f:
    json.dump(engine.metrics.snapshot(), f)
store.set("serve/all_done", b"1")  # distlint: disable=R007 -- terminal success marker for this throwaway test gang
store.close()
"""


def serve_model():
    """The serving rank's model: the same torch-seeded weights in the
    worker and in the in-process reference."""
    import torch

    from pytorch_distributed_example_tpu_torch.models import (
        TransformerConfig,
        TransformerLM,
    )

    cfg = TransformerConfig(
        vocab_size=64, d_model=32, n_layers=2, n_heads=4,
        max_seq_len=32, use_flash=False, dtype=torch.float32,
    )
    return TransformerLM(
        cfg, device="cpu", generator=torch.Generator().manual_seed(0)
    )


def _serve_reference():
    """The uninterrupted run's tokens, computed in-process with the
    worker's exact model/traffic recipe (same seeds -> same params)."""
    from pytorch_distributed_example_tpu_torch.serve import ServeEngine

    eng = ServeEngine(serve_model(), slots=2, min_bucket=4)
    gen0 = np.random.default_rng(42)
    for i, (L, budget) in enumerate(
        [(5, 5), (7, 4), (4, 6), (6, 5), (8, 4), (5, 6)]
    ):
        eng.submit(
            gen0.integers(0, 64, (L,)).astype(np.int32), budget,
            rid=f"r{i}", seed=i,
        )
    return {r: c.tokens for r, c in eng.run(max_steps=500).items()}


def _run_serve_gang(tmp_path, plan, drain_grace=0.0):
    script = tmp_path / "serve_worker.py"
    script.write_text(textwrap.dedent(_SERVE_WORKER.format(repo=REPO)))
    env = {
        "OUT_DIR": str(tmp_path),
        "TDX_FAULT_PLAN": json.dumps(plan),
        "PYTHONPATH": REPO + os.pathsep + os.environ.get("PYTHONPATH", ""),
        "OMP_NUM_THREADS": "1",
    }
    spec = WorkerSpec(
        entrypoint=[str(script)],
        nproc_per_node=2,
        min_nproc=1,  # elastic: a worker loss RESIZES the gang (2 -> 1)
        max_restarts=2,
        serve_drain_grace_s=drain_grace,
        env=env,
    )
    agent = LocalElasticAgent(spec)
    return agent, agent.run()


def _merged_completions(tmp_path):
    """rid -> tokens across generations; duplicate deliveries (requests
    in flight at the checkpoint that also completed pre-kill) must be
    token-identical — that duplicate-consistency IS replay determinism."""
    merged = {}
    with open(tmp_path / "completions.jsonl") as f:
        for line in f:
            rec = json.loads(line)
            if rec["rid"] in merged:
                assert merged[rec["rid"]] == rec["tokens"], rec["rid"]
            merged[rec["rid"]] = rec["tokens"]
    return merged


class TestServeChaosRecovery:
    """An elastic-agent restart (with a world-size
    RESIZE, 2 -> 1) during live serving recovers every interrupted
    request token-identically from the incarnation-scoped serve
    checkpoint, with a measured recovery-time metric."""

    def test_serving_rank_crash_mid_traffic_recovers_token_exact(
        self, tmp_path
    ):
        """The serving rank is killed mid-decode (serve.step crash, no
        drain): the re-formed SMALLER gang restores the last periodic
        checkpoint and finishes; all outputs match the uninterrupted
        reference exactly; the recovery row is measured and bounded."""
        ref = _serve_reference()
        agent, res = _run_serve_gang(
            tmp_path,
            [{"point": "serve.step", "rank": 0, "after": 3,
              "action": "crash", "restart_lt": 1}],
        )
        assert res.state is WorkerState.SUCCEEDED
        assert res.restarts >= 1
        assert agent.active_nproc == 1  # the gang RESIZED, not just restarted
        merged = _merged_completions(tmp_path)
        assert merged == ref
        with open(tmp_path / "metrics.json") as f:
            snap = json.load(f)
        rec = snap["recovery"]
        assert rec["restores"] == 1
        assert rec["requests_restored"] >= 1
        # wall-clock window: checkpoint stamp -> first token on the new
        # gang (includes re-form + torch import + model build); bounded well
        # below the agent's own teardown ceilings
        assert 0.0 < rec["last_recovery_s"] < 300.0

    def test_drain_grace_checkpoints_before_teardown(self, tmp_path):
        """A PEER rank crashes; the agent publishes the drain key and
        the serving rank checkpoints through `drain()` within the grace
        window (no serve-side fault at all) — the resized gang restores
        and the outputs stay token-exact."""
        ref = _serve_reference()
        agent, res = _run_serve_gang(
            tmp_path,
            [{"point": "train.step", "rank": 1, "after": 3,
              "action": "crash", "restart_lt": 1}],
            drain_grace=10.0,
        )
        assert res.state is WorkerState.SUCCEEDED
        assert res.restarts >= 1
        assert agent.active_nproc == 1
        merged = _merged_completions(tmp_path)
        assert merged == ref
        with open(tmp_path / "metrics.json") as f:
            snap = json.load(f)
        assert snap["recovery"]["restores"] == 1
        assert 0.0 < snap["recovery"]["last_recovery_s"] < 300.0


class TestAgentHeartbeatFaults:
    def test_missed_beats_leave_no_heartbeat_key(self):
        """The agent.heartbeat fault point: injected drops are missed
        beats (no store write), recovery resumes beating."""
        from pytorch_distributed_example_tpu_torch import faults
        from pytorch_distributed_example_tpu_torch.store import HashStore

        spec = WorkerSpec(entrypoint=["x.py"], nproc_per_node=1)
        agent = LocalElasticAgent(spec)
        ctrl = HashStore(timeout=1.0)
        faults.install_plan(
            [{"point": "agent.heartbeat", "rank": 0, "times": 2,
              "action": "drop"}],
            export_env=False,
        )
        try:
            agent._heartbeat(ctrl)  # dropped
            agent._heartbeat(ctrl)  # dropped
            assert not ctrl.check([agent._hb_key(0)])
            agent._heartbeat(ctrl)  # budget spent: beats again
            assert ctrl.check([agent._hb_key(0)])
            ts, ep = agent._hb_parse(ctrl.get(agent._hb_key(0)))
            assert ts > 0 and ep is None
        finally:
            faults.clear_plan()
