"""The port's sharded checkpoint (`checkpoint_sharded.py`, over
torch.distributed.checkpoint) against the reference's (over orbax).

Mirrors the contracts of `TestShardedManifest` (tests/test_checkpoint_
integrity.py), `TestShardedCheckpoint` (tests/test_join_checkpoint.py) and
`TestShardedCheckpointResharding` (tests/test_zero_update.py): the CRC
manifest caps a DCP directory (here with `.metadata` in it) and a flipped
byte refuses the load; the manager keeps the last k steps, quarantines a
corrupt step and falls back to the newest earlier one; a save restores
into the same layout, into a replicated one, and across world sizes
(2 -> 1 and 1 -> 2) bitwise, also through `resharded_template`;
`dcp_async_save`'s handle flips `done()` by itself. The reference's own
reshard runs on the same seeded values, and both restore them byte for
byte. Beyond the reference: an fsdp 2 x tp 2 layout with leaves sharded
on other dims and replicated on an axis goes 4 -> 1 and 1 -> 4, each
rank's shard is its own DCP entry, and a 2-process gloo gang writes each
process's own shards, reads them back, and agrees on GradScaler's
verdict and the global clip norm.
"""

import json
import os
import pickle
import subprocess
import sys
import textwrap
import time
import warnings

import numpy as np
import pytest
import torch

import pytorch_distributed_example_tpu_torch as tdx
from pytorch_distributed_example_tpu_torch import checkpoint_sharded as cs
from pytorch_distributed_example_tpu_torch.checkpoint import CheckpointCorruptError
from pytorch_distributed_example_tpu_torch.dtensor import (
    DTensor,
    Replicate,
    Shard,
    distribute_tensor,
    redistribute_tree,
)
from pytorch_distributed_example_tpu_torch.mesh import DeviceMesh
from pytorch_distributed_example_tpu_torch.tensor import DistTensor
from tests._mp_util import REPO
from tests._torch_gang import gang_env, gang_port

W = 8
GANG_TIMEOUT_S = 120


def _mesh(n, axis="_ranks"):
    return DeviceMesh(["cpu"] * n, (n,), (axis,))


def _sharded_tree(world=W):
    mesh = _mesh(world)
    x = torch.arange(world * 4, dtype=torch.float32).reshape(world, 4)
    return {"w": distribute_tensor(x, mesh, [Shard(0)]), "b": torch.tensor(7.5)}


def _bits(t):
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return t.numpy().tobytes()


def _same(a, b):
    """Bitwise equal values and layouts."""
    if isinstance(a, DTensor):
        assert isinstance(b, DTensor) and a.placements == b.placements
        assert a.device_mesh == b.device_mesh
        assert _bits(a._local) == _bits(b._local)
    else:
        assert a.dtype == b.dtype and _bits(a) == _bits(b)


def _corrupt_one(path, name=None):
    victim = None
    for root, _, names in os.walk(path):
        for n in sorted(names):
            if n != "manifest.json" and (name is None or n == name):
                if os.path.getsize(os.path.join(root, n)) > 8:
                    victim = os.path.join(root, n)
                    break
        if victim:
            break
    with open(victim, "r+b") as f:
        f.seek(0)
        f.write(b"\x00CORRUPT")
    return victim


class TestShardedManifest:
    @pytest.mark.parametrize("victim", ["__0_0.distcp", ".metadata"])
    def test_dcp_save_writes_manifest_and_load_verifies(self, tmp_path, victim):
        state = {"w": torch.ones(2, 2)}
        path = tdx.dcp_save(state, str(tmp_path / "dcp"))
        with open(os.path.join(path, "manifest.json")) as f:
            files = set(json.load(f)["files"])
        assert {".metadata", "__0_0.distcp", cs.LAYOUT} <= files
        assert float(tdx.dcp_load(state, path)["w"][0, 0]) == 1.0
        _corrupt_one(path, victim)
        with pytest.raises(CheckpointCorruptError):
            tdx.dcp_load(state, path)

    def test_manager_falls_back_to_earlier_step(self, tmp_path):
        mgr = tdx.DCPCheckpointer(str(tmp_path / "mgr"), max_to_keep=3)
        mgr.save(0, {"w": torch.ones(2, 2)})
        mgr.save(1, {"w": torch.ones(2, 2) * 2})
        _corrupt_one(os.path.join(str(tmp_path / "mgr"), "1"))
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            restored = mgr.restore(template={"w": torch.zeros(2, 2)})
        assert float(restored["w"][0, 0]) == 1.0  # step 0
        assert any("corrupt" in str(x.message) for x in w)
        assert any("quarantine" in n for n in os.listdir(tmp_path))
        assert mgr.all_steps() == [0]
        mgr.close()


class TestShardedCheckpoint:
    def test_save_and_restore_same_sharding(self, tmp_path):
        state = _sharded_tree()
        restored = tdx.dcp_load(state, tdx.dcp_save(state, str(tmp_path / "ckpt")))
        _same(state["w"], restored["w"])
        _same(state["b"], restored["b"])

    def test_each_ranks_shard_is_its_own_entry(self, tmp_path):
        from torch.distributed.checkpoint import FileSystemReader

        path = tdx.dcp_save(_sharded_tree(), str(tmp_path / "e"))
        keys = sorted(FileSystemReader(path).read_metadata().state_dict_metadata)
        assert keys == sorted([f"leaf_1/{r}" for r in range(W)] + ["leaf_0"])
        with open(os.path.join(path, cs.LAYOUT)) as f:
            rec = json.load(f)["leaves"][1]
        assert rec["path"] == "['w']" and rec["placements"] == ["S0"]
        assert [c["offsets"] for c in rec["chunks"]] == [[r, 0] for r in range(W)]

    def test_async_save_roundtrip(self, tmp_path):
        state = _sharded_tree()
        handle = cs.dcp_async_save(state, str(tmp_path / "ackpt"))
        deadline = time.time() + 60
        while not handle.done() and time.time() < deadline:  # flips on its own
            time.sleep(0.02)
        assert handle.done()
        restored = tdx.dcp_load(state, handle.result(timeout=5))
        _same(state["w"], restored["w"])

    def test_async_snapshot_is_taken_before_return(self, tmp_path):
        """Training may overwrite the state as soon as the call returns."""
        state = _sharded_tree()
        want = _bits(state["w"]._local)
        handle = cs.dcp_async_save(state, str(tmp_path / "snap"))
        state["w"]._local.add_(1.0)
        restored = tdx.dcp_load(_sharded_tree(), handle.result(timeout=60))
        assert _bits(restored["w"]._local) == want

    def test_manager_async_save(self, tmp_path):
        state = _sharded_tree()
        mgr = tdx.DCPCheckpointer(str(tmp_path / "amgr"), max_to_keep=2)
        assert mgr.save(1, state, wait=False)
        mgr.wait_until_finished()
        _same(state["w"], mgr.restore(1, template=state)["w"])
        mgr.close()

    def test_reshard_on_load(self, tmp_path):
        """Saved sharded over the ranks, restored REPLICATED."""
        state = _sharded_tree()
        path = tdx.dcp_save(state, str(tmp_path / "ckpt2"))
        template = tdx.resharded_template(state, _mesh(W))
        restored = tdx.dcp_load(template, path)
        assert restored["w"].placements == (Replicate(),)
        assert restored["w"]._local.shape == (1, W, 4)
        assert _bits(restored["w"].full_tensor()) == _bits(state["w"].full_tensor())
        assert _bits(restored["b"].full_tensor()) == _bits(state["b"])

    def test_manager_keep_last_k_and_resume(self, tmp_path):
        mgr = tdx.DCPCheckpointer(str(tmp_path / "run"), max_to_keep=2)
        state = _sharded_tree()
        for step in (1, 2, 3):
            bumped = {"w": state["w"] + step, "b": state["b"] + step}
            assert mgr.save(step, bumped)
        assert mgr.latest_step() == 3
        assert mgr.all_steps() == [2, 3]  # keep-last-2
        restored = mgr.restore(template=state)
        assert _bits(restored["w"].full_tensor()) == _bits(state["w"].full_tensor() + 3)
        whole = mgr.restore()  # no template: global values as saved
        assert _bits(whole["w"]) == _bits(state["w"].full_tensor() + 3)
        mgr.close()

    @pytest.mark.parametrize("template,match", [
        ({"w": torch.zeros(W, 4)}, "structure mismatch"),
        ({"w": torch.zeros(W, 5), "b": torch.tensor(0.0)}, "shape"),
        ({"w": torch.zeros(W, 4, dtype=torch.bfloat16), "b": torch.tensor(0.0)}, "dtype"),
    ])
    def test_mismatch_raises(self, tmp_path, template, match):
        path = tdx.dcp_save(_sharded_tree(), str(tmp_path / "m"))
        with pytest.raises(ValueError, match=match):
            tdx.dcp_load(template, path)


def _ref_tree(seed=0):
    gen = np.random.default_rng(seed)
    return {"w": gen.standard_normal((8, 6)).astype(np.float32),
            "v": gen.standard_normal((16,)).astype(np.float32)}


@pytest.mark.parametrize("w_from,w_to", [(2, 1), (1, 2)])
def test_save_restore_across_world_change_bitwise(world, tmp_path, w_from, w_to):
    """The reference's TestShardedCheckpointResharding: a dim-0-sharded
    checkpoint written at world `w_from` restores at `w_to` through
    `resharded_template` and redistributes to the full values bitwise; the
    reference's own orbax reshard of the same values gives the same bytes."""
    import jax
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    from pytorch_distributed_example_tpu import dcp_load as jload, dcp_save as jsave
    from pytorch_distributed_example_tpu import resharded_template as jtemplate

    ref = _ref_tree()
    specs = {"w": ("fsdp",), "v": ("fsdp",)}
    mesh_from, mesh_to = _mesh(w_from, "fsdp"), _mesh(w_to, "fsdp")
    sharded = redistribute_tree({k: torch.from_numpy(v) for k, v in ref.items()}, mesh_from,
                                specs)
    path = tdx.dcp_save(sharded, str(tmp_path / f"ck{w_from}to{w_to}"))
    restored = tdx.dcp_load(tdx.resharded_template(sharded, mesh_to, specs=specs), path)

    jmesh = lambda n: Mesh(np.array(jax.devices()[:n]), ("fsdp",))  # noqa: E731
    jsharded = {k: jax.device_put(v, NamedSharding(jmesh(w_from), P("fsdp")))
                for k, v in ref.items()}
    jpath = jsave(jsharded, str(tmp_path / f"ref{w_from}to{w_to}"))
    jrestored = jload(jtemplate(jsharded, jmesh(w_to), specs={k: P("fsdp") for k in ref}),
                      jpath)
    for k in ref:
        assert restored[k].device_mesh.shape == (w_to,)
        assert restored[k].placements == (Shard(0),)
        full = restored[k].redistribute([Replicate()]).to_global()
        assert full.numpy().tobytes() == ref[k].tobytes()
        assert np.asarray(jrestored[k]).tobytes() == full.numpy().tobytes()
        again = restored[k].redistribute([Shard(0)]).to_global()
        assert again.numpy().tobytes() == ref[k].tobytes()


def _fsdp_tp_state(mesh):
    gen = torch.Generator().manual_seed(0)
    full = {"embed": torch.randn(16, 8, generator=gen),
            "q": torch.randn(8, 8, generator=gen).to(torch.bfloat16),
            "norm": torch.randn(8, generator=gen),
            "step": torch.tensor(3, dtype=torch.int64)}
    specs = {"embed": ("fsdp",), "q": ("tp", "fsdp"), "norm": (), "step": ()}
    return full, specs, {"params": redistribute_tree(full, mesh, specs), "lr": 0.5,
                         "betas": (0.9, 0.95)}


def test_fsdp_tp_layout_reshards_4_to_1_and_1_to_4_bitwise(tmp_path, monkeypatch):
    monkeypatch.setattr(cs, "LOAD_BATCH_BYTES", 0)  # one leaf a read: the host holds one
    mesh4 = DeviceMesh(["cpu"] * 4, (2, 2), ("fsdp", "tp"))
    mesh1 = DeviceMesh(["cpu"], (1, 1), ("fsdp", "tp"))
    full, specs, state = _fsdp_tp_state(mesh4)
    path = tdx.dcp_save(state, str(tmp_path / "four"))
    same = tdx.dcp_load(state, path)
    for k in full:
        _same(state["params"][k], same["params"][k])
    assert same["lr"] == 0.5 and same["betas"] == (0.9, 0.95)
    # 4 -> 1: the single-card layout, the global values bitwise
    stats = {}
    one = tdx.dcp_load({"params": tdx.resharded_template(state["params"], mesh1, specs=specs),
                        "lr": 0.0, "betas": (0.0, 0.0)}, path, stats=stats)
    for k in full:
        assert _bits(one["params"][k].full_tensor()) == _bits(full[k]), k
    assert stats["peak_host_bytes"] <= 2 * max(
        t.numel() * t.element_size() for t in full.values())
    # 1 -> 4: a single-card save into fsdp 2 x tp 2, bitwise the live layout
    path1 = tdx.dcp_save(one, str(tmp_path / "one"))
    four = tdx.dcp_load(state, path1)
    for k in full:
        _same(state["params"][k], four["params"][k])
    # a plain-tensor template takes the global value
    plain = tdx.dcp_load({"params": {k: torch.zeros_like(v)
                                     for k, v in full.items()}, "lr": 0.0, "betas": (0.0, 0.0)},
                         path)
    for k in full:
        assert _bits(plain["params"][k]) == _bits(full[k]), k


def test_rules_template_and_rows(tmp_path):
    """`resharded_template(rules=)` lays leaves out by a rule table, and a
    DistTensor's rows round-trip as Shard(0) of their concatenation."""
    from pytorch_distributed_example_tpu_torch.parallel.sharding import fsdp_rules

    mesh2 = _mesh(2, "fsdp")
    tpl = tdx.resharded_template({"a": torch.zeros(4, 3), "b": torch.zeros(3)}, mesh2,
                                 rules=fsdp_rules("fsdp"))
    assert tpl["a"].placements == (Shard(0),) and tpl["b"].placements == (Replicate(),)
    pg = tdx.init_process_group(world_size=4, device="cpu")
    try:
        rows = DistTensor.wrap(torch.arange(12.0).reshape(4, 3), pg)
        path = tdx.dcp_save({"rows": rows}, str(tmp_path / "rows"))
        back = tdx.dcp_load({"rows": DistTensor.wrap(torch.zeros(4, 3), pg)}, path)
        assert _bits(back["rows"].tensor) == _bits(rows.tensor)
        whole = tdx.dcp_load(None, path)
        assert _bits(whole["rows"]) == _bits(rows.tensor.reshape(-1))
    finally:
        tdx.destroy_process_group()


# ---------------------------------------------------------------------------
# a 2-process gloo gang
# ---------------------------------------------------------------------------

GANG_WORKER = textwrap.dedent(
    """
    import pickle, sys
    rank, world, port, path, out = (int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]),
                                     sys.argv[4], sys.argv[5])
    import torch
    import pytorch_distributed_example_tpu_torch as tdx
    from pytorch_distributed_example_tpu_torch import amp
    from pytorch_distributed_example_tpu_torch.nn.utils import clip_grad_norm_
    from pytorch_distributed_example_tpu_torch.tensor import DistTensor

    g = tdx.init_process_group(backend="gloo", init_method=f"tcp://127.0.0.1:{port}",
                               rank=rank, world_size=world, device="cpu", timeout=60)
    row = torch.arange(6.0).reshape(1, 6) + 10 * rank  # this rank's shard
    state = {"rows": DistTensor.wrap(row, g), "shared": torch.ones(3), "step": 4}
    tdx.dcp_save(state, path)
    back = tdx.dcp_load({"rows": DistTensor.wrap(torch.zeros(1, 6), g),
                         "shared": torch.zeros(3), "step": 0}, path)
    handle = tdx.checkpoint_sharded.dcp_async_save(state, path + "_async")
    handle.result(timeout=60)
    res = {"rows": back["rows"].tensor.numpy(), "shared": back["shared"].numpy(),
           "step": back["step"]}
    # GradScaler: only rank 1's gradient overflows; both ranks must skip
    scaler = amp.GradScaler(init_scale=2.0)
    g_row = torch.ones(1, 3)
    if rank == 1:
        g_row[0, 1] = float("inf")
    _, finite = scaler.unscale({"g": g_row}, scaler.init(), group=g)
    res["finite"] = bool(finite)
    _, res["norm"] = clip_grad_norm_({"g": torch.full((1, 4), float(rank + 1))}, 1.0, group=g)
    res["norm"] = float(res["norm"])
    tdx.destroy_process_group()
    with open(out, "wb") as f:
        pickle.dump(res, f)
    """
)


@pytest.fixture(scope="module")
def gang(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dcp_gang")
    script = tmp / "worker.py"
    script.write_text(GANG_WORKER)
    port = gang_port()
    path = str(tmp / "ckpt")
    procs = [subprocess.Popen([sys.executable, str(script), str(r), "2", str(port), path,
                               str(tmp / f"rank{r}.pkl")],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=gang_env(),
                              cwd=REPO)
             for r in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=GANG_TIMEOUT_S)[0].decode())
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} failed:\n{out}"
    results = []
    for r in range(2):
        with open(tmp / f"rank{r}.pkl", "rb") as f:
            results.append(pickle.load(f))
    return path, results


def test_gang_writes_each_processs_own_shards(gang):
    from torch.distributed.checkpoint import FileSystemReader

    path, results = gang
    for saved in (path, path + "_async"):
        md = FileSystemReader(saved).read_metadata()
        files = {k.fqn: v.relative_path for k, v in md.storage_data.items()}
        assert files["leaf_0/0"] == "__0_0.distcp" and files["leaf_0/1"] == "__1_0.distcp"
        ok, detail = tdx.checkpoint.verify_checkpoint(saved)
        assert ok and detail == "ok", detail
    for rank, res in enumerate(results):
        np.testing.assert_array_equal(res["rows"], np.arange(6.0)[None] + 10 * rank)
        np.testing.assert_array_equal(res["shared"], np.ones(3))
        assert res["step"] == 4
    # a driver-mode process reads the gang's checkpoint: every rank's row
    pg = tdx.init_process_group(world_size=2, device="cpu")
    try:
        both = tdx.dcp_load({"rows": DistTensor.wrap(torch.zeros(2, 6), pg),
                             "shared": torch.zeros(3), "step": 0}, path)
        np.testing.assert_array_equal(both["rows"].tensor.numpy(),
                                      np.arange(6.0)[None] + np.array([[0.0], [10.0]]))
    finally:
        tdx.destroy_process_group()


def test_gang_agrees_on_overflow_and_clip_norm(gang):
    _, results = gang
    assert [r["finite"] for r in results] == [False, False]
    want = float(np.sqrt(4 * 1.0 + 4 * 4.0))
    for res in results:
        assert res["norm"] == pytest.approx(want, rel=1e-6)


def test_fsdp_trainer_state_round_trips_through_dcp(tmp_path, monkeypatch):
    """The sharded trainer's state (`FSDPModule.state_dict`: params and AdamW
    moments in their fsdp 2 x tp 2 layout) goes 4 -> 1 -> 4 through DCP
    bitwise, and a step from the restored state (`load_state_dict`) is
    bitwise the step from the live one: chip_smoke's `[ckpt]` at a small
    width on the CPU."""
    from pytorch_distributed_example_tpu_torch.examples import lm

    monkeypatch.setenv("TDX_EXAMPLES_CPU_DEVICES", "4")
    args = lm.parse_args(["--cpu", "--tp", "2", "--vocab-size", "64", "--d-model", "32",
                          "--n-layers", "2", "--n-heads", "4", "--seq", "16", "--batch-size", "4"])
    mod, opt, next_tokens = lm.build(args, world=4)
    lm.train_step(mod, opt, next_tokens())
    state = mod.state_dict(opt)
    specs = {"params": dict(mod.param_specs),
             "optim": {k: {kk: mod.param_specs[k] if isinstance(vv, DTensor) else ()
                           for kk, vv in v.items()} for k, v in state["optim"].items()}}
    path4 = tdx.dcp_save(state, str(tmp_path / "four"))
    mesh1 = DeviceMesh(["cpu"], (1, 1), ("fsdp", "tp"))
    one = tdx.dcp_load(tdx.resharded_template(state, mesh1, specs=specs), path4)
    for k, v in state["params"].items():
        assert _bits(one["params"][k].full_tensor()) == _bits(v.full_tensor()), k
    back = tdx.dcp_load(state, tdx.dcp_save(one, str(tmp_path / "one")))
    for k, v in state["params"].items():
        _same(v, back["params"][k])
        _same(state["optim"][k]["exp_avg"], back["optim"][k]["exp_avg"])
    tokens = next_tokens()
    want_loss = lm.train_step(mod, opt, tokens)
    want = {k: v._local.detach().clone() for k, v in mod.params.items()}
    mod.load_state_dict(back, opt)
    got_loss = lm.train_step(mod, opt, tokens)
    assert _bits(got_loss) == _bits(want_loss)
    for k, v in mod.params.items():
        assert _bits(v._local) == _bits(want[k]), k
