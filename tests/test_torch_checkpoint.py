"""The port's rank-0 checkpoint (`checkpoint.py`) against the reference's.

Mirrors the contracts of the reference's `tests/test_checkpoint_integrity.py`
and of `TestCheckpoint` in `tests/test_join_checkpoint.py`: atomic writes,
the CRC manifest, quarantine and last-good fallback, the mid-write kill,
the structure and shape checks. Across the packages, on the same seeded
numpy values:

* the reference's checkpoint of a float32 / int32 / bfloat16 tree loads in
  the port with the same bytes (bfloat16 compared as uint16 words), and
  the port's of float32 / int32 leaves loads in the reference bitwise;
* the port's leaf paths equal the reference's jax flattener's for dict,
  list, tuple, namedtuple and None trees.

Within the port every contract is bitwise (`@numerics_contract("bitwise")`
on save and load): a bf16 / f32 / int tree and a `torch.optim`
`state_dict()` round-trip byte for byte, and the DDP-MNIST step resumed
from a checkpoint equals the uninterrupted step at world 8, and across
world 4 -> 2 and 2 -> 4 with ZeRO "auto" and adam (the state saved as the
reference's per-leaf padded flats).
"""

import collections
import json
import os
import subprocess
import sys
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import pytorch_distributed_example_tpu_torch as tdx
from pytorch_distributed_example_tpu import checkpoint as jck
from pytorch_distributed_example_tpu_torch import checkpoint as ck
from pytorch_distributed_example_tpu_torch import faults, numerics, optim
from pytorch_distributed_example_tpu_torch.checkpoint import (
    CheckpointCorruptError,
    last_good_path,
    load_checkpoint,
    save_checkpoint,
    verify_checkpoint,
)
from pytorch_distributed_example_tpu_torch.models import ConvNet
from tests import _ddp_cases as cases
from tests._mp_util import REPO, worker_env


def _params(v=0.0):
    return {"w": torch.full((2, 3), v), "b": torch.zeros(3)}


def _bits(t: torch.Tensor) -> bytes:
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return t.numpy().tobytes()


def _assert_tree_bitwise(a, b):
    pa, la = ck._flatten_with_paths(a)
    pb, lb = ck._flatten_with_paths(b)
    assert pa == pb
    for p, x, y in zip(pa, la, lb):
        if isinstance(x, torch.Tensor):
            assert isinstance(y, torch.Tensor) and x.dtype == y.dtype and x.shape == y.shape, p
            assert x.device == y.device, p
            assert _bits(x) == _bits(y), p
        else:
            assert type(x) is type(y) and x == y, p


class TestAtomicWrite:
    def test_save_writes_manifest_and_verifies(self, tmp_path):
        p = str(tmp_path / "ck")
        save_checkpoint(p, _params(), step=3)
        assert os.path.exists(os.path.join(p, "manifest.json"))
        ok, detail = verify_checkpoint(p)
        assert ok, detail
        with open(os.path.join(p, "manifest.json")) as f:
            doc = json.load(f)
        assert set(doc["files"]) == {"arrays.npz", "meta.json"}

    def test_second_save_keeps_prev_as_last_good(self, tmp_path):
        p = str(tmp_path / "ck")
        save_checkpoint(p, _params(1.0), step=1)
        save_checkpoint(p, _params(2.0), step=2)
        assert os.path.isdir(last_good_path(p))
        params, _, step, _ = load_checkpoint(last_good_path(p), _params())
        assert step == 1 and params["w"][0, 0] == 1.0

    def test_no_tmp_left_behind(self, tmp_path):
        p = str(tmp_path / "ck")
        save_checkpoint(p, _params(), step=0)
        save_checkpoint(p, _params(), step=1)
        assert [n for n in os.listdir(tmp_path) if ".tmp." in n] == []

    def test_mid_write_kill_never_leaves_loadable_corruption(self, tmp_path):
        """Kill the writer at checkpoint.finalize on its SECOND save: the live
        checkpoint must still be the first save, fully verified."""
        p = str(tmp_path / "ck")
        code = f"""
import torch
from pytorch_distributed_example_tpu_torch import faults
from pytorch_distributed_example_tpu_torch.checkpoint import save_checkpoint
faults.install_plan([{{"point": "checkpoint.finalize", "after": 2,
                       "action": "crash"}}], export_env=False)
save_checkpoint({p!r}, {{"w": torch.ones(4)}}, step=1)
save_checkpoint({p!r}, {{"w": torch.ones(4) * 2}}, step=2)  # killed here
print("UNREACHABLE")
"""
        r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                           timeout=120, env=worker_env(), cwd=REPO)
        assert r.returncode == 13, (r.returncode, r.stderr)
        assert "UNREACHABLE" not in r.stdout
        ok, detail = verify_checkpoint(p)
        assert ok, detail
        params, _, step, _ = load_checkpoint(p, {"w": torch.zeros(4)})
        assert step == 1 and params["w"][0] == 1.0
        assert [n for n in os.listdir(tmp_path) if ".tmp." in n], "expected the killed tmp dir"


    def test_timings_fill_the_callers_dict(self, tmp_path):
        p = str(tmp_path / "ck")
        saved, loaded = {}, {}
        save_checkpoint(p, _params(1.0), step=1, timings=saved)
        load_checkpoint(p, _params(), timings=loaded)
        assert set(saved) == {"to_host", "write", "seal"}
        assert set(loaded) == {"verify", "read", "to_device"}
        assert all(v >= 0 for v in [*saved.values(), *loaded.values()])


class TestCorruptionDetection:
    def test_corrupt_payload_detected_and_falls_back(self, tmp_path):
        p = str(tmp_path / "ck")
        save_checkpoint(p, _params(1.0), step=1)
        save_checkpoint(p, _params(2.0), step=2)
        with open(os.path.join(p, "arrays.npz"), "r+b") as f:
            f.seek(40)
            f.write(b"\xde\xad\xbe\xef")
        ok, detail = verify_checkpoint(p)
        assert not ok and "crc32" in detail
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            params, _, step, _ = load_checkpoint(p, _params())
        assert step == 1 and params["w"][0, 0] == 1.0
        assert any("corrupt" in str(x.message) for x in w)
        assert len([n for n in os.listdir(tmp_path) if "quarantine" in n]) == 1

    def test_injected_finalize_corruption_caught_by_crc(self, tmp_path):
        p = str(tmp_path / "ck")
        save_checkpoint(p, _params(1.0), step=1)
        faults.install_plan([{"point": "checkpoint.finalize", "action": "corrupt"}],
                            export_env=False)
        try:
            save_checkpoint(p, _params(2.0), step=2)
        finally:
            faults.clear_plan()
        ok, detail = verify_checkpoint(p)
        assert not ok and "crc32" in detail
        with warnings.catch_warnings(record=True):
            warnings.simplefilter("always")
            _, _, step, _ = load_checkpoint(p, _params())
        assert step == 1  # fell back to last-good

    def test_no_fallback_raises_corrupt_error(self, tmp_path):
        p = str(tmp_path / "ck")
        save_checkpoint(p, _params(), step=0)  # no .prev yet
        with open(os.path.join(p, "meta.json"), "ab") as f:
            f.write(b"garbage")
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            with pytest.raises(CheckpointCorruptError):
                load_checkpoint(p, _params())

    def test_missing_checkpoint_raises_file_not_found(self, tmp_path):
        with pytest.raises(FileNotFoundError):
            load_checkpoint(str(tmp_path / "nope"), _params())

    @pytest.mark.parametrize("template,match", [
        ({"other": torch.zeros(2)}, "structure mismatch"),
        ({"w": torch.zeros(5, 3), "b": torch.zeros(3)}, "shape mismatch"),
    ])
    def test_mismatch_raises_value_error(self, tmp_path, template, match):
        p = str(tmp_path / "ck")
        save_checkpoint(p, _params(), step=0)
        with pytest.raises(ValueError, match=match):
            load_checkpoint(p, template)

    def test_write_fault_point_fires_before_any_bytes(self, tmp_path):
        p = str(tmp_path / "ck")
        faults.install_plan([{"point": "checkpoint.write", "action": "error"}],
                            export_env=False)
        try:
            with pytest.raises(tdx.DistError):
                save_checkpoint(p, _params(), step=0)
        finally:
            faults.clear_plan()
        assert os.listdir(tmp_path) == []

    def test_contracts_are_the_references(self):
        from pytorch_distributed_example_tpu import numerics as jnumerics

        for fn, jfn in ((save_checkpoint, jck.save_checkpoint),
                        (load_checkpoint, jck.load_checkpoint)):
            assert numerics.contract_of(fn)["tier"] == "bitwise"
            assert jnumerics.contract_of(jfn)["tier"] == "bitwise"


State = collections.namedtuple("State", ["mu", "nu"])


def _jax_paths(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return ["/".join(str(k) for k in path) for path, _ in flat]


class TestPaths:
    @pytest.mark.parametrize("tree", [
        {"params": {"b": np.zeros(2), "a": [np.ones(1), np.ones(1)]}},
        {"opt": State(mu=np.ones(2), nu=np.zeros(2)), "none": None},
        {"state": {0: {"m": np.ones(2)}, 11: {"m": np.ones(1)}, 2: {"m": np.ones(3)}},
         "groups": [{"lr": 1.0, "betas": (0.9, 0.99), "params": [0, 2, 11]}]},
    ], ids=["dict_list", "namedtuple_none", "optimizer"])
    def test_paths_match_the_jax_flattener(self, tree):
        assert [p for p, _ in ck._py_flatten(tree)] == _jax_paths(tree)

    def test_namedtuple_and_none_rebuild(self):
        tree = {"opt": State(mu=torch.ones(2), nu=torch.zeros(2)), "none": None}
        rebuilt = ck._py_unflatten(tree, [v for _, v in ck._py_flatten(tree)])
        assert isinstance(rebuilt["opt"], State) and rebuilt["none"] is None
        assert torch.equal(rebuilt["opt"].mu, torch.ones(2))


def _mixed_tree(seed=0):
    gen = np.random.default_rng(seed)
    return {"w": gen.standard_normal((2, 3)).astype(np.float32),
            "b": gen.standard_normal((3,)).astype(np.float32),
            "n": np.asarray(gen.integers(-9, 9), np.int32),
            "h": gen.standard_normal((4, 5)).astype(np.float32)}


class TestAcrossPackages:
    def test_reference_checkpoint_loads_in_the_port_bytewise(self, tmp_path):
        """float32, int32 and bfloat16 (the reference writes bf16 as 2-byte
        voids; the port restores torch.bfloat16 from meta's dtypes)."""
        src = _mixed_tree()
        jtree = {"w": jnp.asarray(src["w"]), "b": jnp.asarray(src["b"]),
                 "n": jnp.asarray(src["n"]), "h": jnp.asarray(src["h"], jnp.bfloat16)}
        p = str(tmp_path / "ref")
        jck.save_checkpoint(p, jtree, step=7, extra={"lr": 0.1})
        template = {"w": torch.zeros(2, 3), "b": torch.zeros(3),
                    "n": torch.zeros((), dtype=torch.int32),
                    "h": torch.zeros(4, 5, dtype=torch.bfloat16)}
        got, _, step, extra = load_checkpoint(p, template)
        assert step == 7 and extra == {"lr": 0.1}
        for k in ("w", "b", "n"):
            assert got[k].dtype == template[k].dtype
            assert got[k].numpy().tobytes() == np.asarray(jtree[k]).tobytes(), k
        assert got["h"].dtype == torch.bfloat16
        want_words = np.asarray(jtree["h"]).view(np.uint16)
        assert np.array_equal(got["h"].view(torch.int16).numpy().view(np.uint16), want_words)

    def test_reference_bf16_round_trip_returns_raw_voids(self, tmp_path):
        """The reference's own round trip does not keep bfloat16, against its
        contract note ("leaf dtypes are recorded in the manifest and
        restored on load", checkpoint.py:261-265): its load returns 2-byte
        voids. The port holds the stated contract on the same file."""
        h = jnp.asarray(_mixed_tree()["h"], jnp.bfloat16)
        p = str(tmp_path / "bf")
        jck.save_checkpoint(p, {"h": h})
        with open(os.path.join(p, "meta.json")) as f:
            assert json.load(f)["dtypes"] == ["bfloat16"]
        jparams, _, _, _ = jck.load_checkpoint(p, {"h": np.zeros((4, 5), np.float32)})
        assert np.asarray(jparams["h"]).dtype == np.dtype("V2")  # not bfloat16
        got, _, _, _ = load_checkpoint(p, {"h": torch.zeros(4, 5, dtype=torch.bfloat16)})
        assert got["h"].dtype == torch.bfloat16
        assert got["h"].view(torch.int16).numpy().tobytes() == np.asarray(h).tobytes()

    def test_port_checkpoint_loads_in_the_reference_bitwise(self, tmp_path):
        src = _mixed_tree(1)
        tree = {k: torch.from_numpy(v) for k, v in src.items()}
        opt = {"count": torch.tensor(3, dtype=torch.int32), "mu": {"w": tree["w"] * 2}}
        p = str(tmp_path / "port")
        save_checkpoint(p, tree, opt, step=5, extra={"note": "x"})
        jparams, jopt, step, extra = jck.load_checkpoint(
            p, {k: np.zeros_like(v) for k, v in src.items()},
            {"count": np.zeros((), np.int32), "mu": {"w": np.zeros((2, 3), np.float32)}})
        assert step == 5 and extra == {"note": "x"}
        for k, v in src.items():
            assert np.asarray(jparams[k]).dtype == v.dtype
            assert np.asarray(jparams[k]).tobytes() == v.tobytes(), k
        assert int(jopt["count"]) == 3
        assert np.asarray(jopt["mu"]["w"]).tobytes() == (src["w"] * 2).tobytes()

    def test_reference_zero_padded_flats_strip_into_the_port(self, tmp_path):
        """The ZeRO coercion rule as written: optimizer-state padded flats
        load into an unsharded template; a mis-sized param still raises."""
        w = np.arange(6, dtype=np.float32).reshape(2, 3)
        flat = np.concatenate([w.reshape(-1), np.zeros(2, np.float32)])  # W 4: 4 * 2
        p = str(tmp_path / "z")
        jck.save_checkpoint(p, {"w": w}, {"mu": {"w": flat}}, step=1)
        params, opt, _, _ = load_checkpoint(p, {"w": torch.zeros(2, 3)},
                                            {"mu": {"w": torch.zeros(2, 3)}})
        assert opt["mu"]["w"].numpy().tobytes() == w.tobytes()
        jck.save_checkpoint(p, {"w": flat}, step=2)
        with pytest.raises(ValueError, match="shape mismatch"):
            load_checkpoint(p, {"w": torch.zeros(2, 3)})


class TestRoundTrip:
    def test_bf16_f32_int_tree_round_trips_bitwise(self, tmp_path):
        gen = torch.Generator().manual_seed(0)
        tree = {"bf": torch.randn(3, 4, generator=gen).to(torch.bfloat16),
                "f": torch.randn(5, generator=gen),
                "i": torch.randint(-100, 100, (2, 2), generator=gen, dtype=torch.int64),
                "u": torch.randint(0, 255, (3,), generator=gen, dtype=torch.uint8),
                "flag": torch.tensor([True, False]),
                "half": torch.randn(2, generator=gen).to(torch.float16)}
        p = save_checkpoint(str(tmp_path / "t"), tree, step=1)
        with open(os.path.join(p, "meta.json")) as f:
            assert json.load(f)["dtypes"][0] == "bfloat16"  # sorted: "bf" first
        template = {k: torch.empty_like(v) for k, v in tree.items()}
        got, _, _, _ = load_checkpoint(p, template)
        _assert_tree_bitwise(tree, got)

    def test_torch_optimizer_state_dict_round_trips(self, tmp_path):
        """Integer keys flatten as [0]; lr, betas, bools and the params list
        come back as Python values; the restored AdamW takes the next step
        bitwise as the live one."""
        def make(seed):
            torch.manual_seed(seed)
            model = torch.nn.Sequential(torch.nn.Linear(4, 8), torch.nn.Tanh(),
                                        torch.nn.Linear(8, 2))
            return model, torch.optim.AdamW(model.parameters(), lr=1e-2, weight_decay=1e-4)

        x = torch.randn(16, 4, generator=torch.Generator().manual_seed(1))

        def step(model, opt):
            opt.zero_grad()
            loss = model(x).square().mean()
            loss.backward()
            opt.step()
            return loss.detach()

        model, opt = make(0)
        for _ in range(2):
            step(model, opt)
        p = save_checkpoint(str(tmp_path / "o"), model.state_dict(), opt.state_dict(), step=2)
        assert "['opt_state']/['state']/[0]/['exp_avg']" in json.load(
            open(os.path.join(p, "meta.json")))["paths"]
        saved = ({k: v.clone() for k, v in model.state_dict().items()},
                 {"state": {i: {k: v.clone() for k, v in s.items()}
                            for i, s in opt.state_dict()["state"].items()}})
        want_loss = step(model, opt)

        model2, opt2 = make(1)
        step(model2, opt2)  # gives the fresh optimizer its state's structure
        params, ostate, s, _ = load_checkpoint(p, model2.state_dict(), opt2.state_dict())
        assert s == 2
        _assert_tree_bitwise(saved[0], params)
        _assert_tree_bitwise(saved[1]["state"], ostate["state"])
        assert ostate["param_groups"][0]["betas"] == (0.9, 0.999)
        assert isinstance(ostate["param_groups"][0]["lr"], float)
        assert ostate["param_groups"][0]["params"] == [0, 1, 2, 3]
        model2.load_state_dict(params)
        opt2.load_state_dict(ostate)
        got_loss = step(model2, opt2)
        assert _bits(got_loss) == _bits(want_loss)
        for (n, a), b in zip(model.state_dict().items(), model2.state_dict().values()):
            assert _bits(a) == _bits(b), n


# ---------------------------------------------------------------------------
# resume of the DDP-MNIST step
# ---------------------------------------------------------------------------


@pytest.fixture
def port_group(request):
    pg = tdx.init_process_group(world_size=request.param, device="cpu")
    yield pg
    tdx.destroy_process_group()


def _mnist_step(opt, mode="auto", has_rng=True):
    model = ConvNet(device="cpu", generator=torch.Generator().manual_seed(0))
    ddp = tdx.DistributedDataParallel(model)
    step = ddp.make_train_step(opt, F.cross_entropy, has_rng=has_rng, shard_weight_update=mode)
    return ddp, step


def _batch(world):
    x, y = cases.global_batch(world)
    return (torch.from_numpy(x.transpose(0, 3, 1, 2).copy()), torch.from_numpy(y).long())


@pytest.mark.parametrize("port_group", [8], indirect=True)
def test_resume_of_the_ddp_step_is_bitwise_at_world_8(port_group, tmp_path):
    """The reference's `test_resume_training_continues` (sgd, momentum 0.9,
    dropout on), held bitwise: the step resumed from a checkpoint equals
    the uninterrupted one."""
    opt = optim.sgd(0.05, momentum=0.9)
    ddp, step = _mnist_step(opt)
    x, y = _batch(8)
    p, o = ddp.params, step.init_opt_state(ddp.params)
    p, o, _ = step(p, o, x, y, 0)
    save_checkpoint(str(tmp_path / "mid"), p, step.checkpoint_opt_state(p, o), step=1)
    p_next, _, loss_a = step(p, o, x, y, 1)

    template = {n: torch.zeros_like(t) for n, t in ddp.params.items()}
    pr, orr, s, _ = load_checkpoint(str(tmp_path / "mid"), template, opt.init(template))
    assert s == 1
    ddp2, step2 = _mnist_step(opt)
    p2_next, _, loss_b = step2(pr, orr, x, y, 1)
    assert _bits(loss_a) == _bits(loss_b)
    for n in p_next:
        assert _bits(p_next[n]) == _bits(p2_next[n]), n


@pytest.mark.parametrize("w_from,w_to", [(4, 2), (2, 4)])
def test_zero_adam_resume_across_world_sizes_is_bitwise(tmp_path, w_from, w_to):
    """ZeRO "auto" with adam: the world-`w_from` state, checkpointed as the
    reference's per-leaf padded flats, resumes at world `w_to` bitwise as
    the same state handed over in memory (unsharded); at the same world a
    padded-flat template loads back into the step's own layout."""
    opt = optim.adam(1e-3)
    tdx.init_process_group(world_size=w_from, device="cpu")
    try:
        ddp, step = _mnist_step(opt, has_rng=False)
        x, y = _batch(w_from)
        p, o = ddp.params, step.init_opt_state(ddp.params)
        for _ in range(2):
            p, o, _ = step(p, o, x, y)
        flats = step.checkpoint_opt_state(p, o)
        save_checkpoint(str(tmp_path / "z"), p, flats, step=2)
        full = step.unshard_opt_state(p, o)
        _, same, _, _ = load_checkpoint(str(tmp_path / "z"), p, pytree_zeros(flats))
        _assert_tree_bitwise(o, step.shard_opt_state(p, same))
        p_live = {n: t.clone() for n, t in p.items()}
    finally:
        tdx.destroy_process_group()

    tdx.init_process_group(world_size=w_to, device="cpu")
    try:
        template = {n: torch.zeros_like(t) for n, t in p_live.items()}
        pr, orr, _, _ = load_checkpoint(str(tmp_path / "z"), template, opt.init(template))
        _assert_tree_bitwise(full, orr)
        x, y = _batch(w_to)
        _, step_a = _mnist_step(opt, has_rng=False)
        pa, _, la = step_a(pr, orr, x, y)
        _, step_b = _mnist_step(opt, has_rng=False)
        pb, _, lb = step_b(p_live, full, x, y)
        assert step_a.weight_update_sharded
        assert _bits(la) == _bits(lb)
        for n in pa:
            assert _bits(pa[n]) == _bits(pb[n]), n
    finally:
        tdx.destroy_process_group()


def pytree_zeros(tree):
    from torch.utils import _pytree as pytree

    return pytree.tree_map(torch.zeros_like, tree)
