"""The port's proglint (`pytorch_distributed_example_tpu_torch/tools/proglint.py`).

* The collector: the two seams (`ProcessGroup._dispatch` and
  `nn/functional.py`'s axis collectives) list each collective once, in
  the reference's vocabulary, with one rank's shape; a c10d op the
  planner lowers is listed as the op, not its schedule.
* The rules J001, J002 and J004 on hand-built programs; J003 is not
  owed, and asking for it fails with its reason.
* The seams: under `TDX_PROGLINT=1` the serve, DDP and planner programs
  fingerprint on their first call only; unset, they are returned as
  they are.
* J005 in a 2-process gloo gang: agreeing ranks run (and fingerprint as
  driver mode does); a skewed rank raises `ProgramScheduleMismatchError`
  on both ranks, naming the first divergent collective.
* Against the reference's corpus (`tests/fixtures/proglint/`): the
  `plan.*` fingerprints' canonical `eqns` are the reference's. The port's
  ZeRO step packs every leaf into one flat buffer, so
  `ddp.train_step.zero` is the reference's after its per-leaf
  collectives of one op are merged: its `psum_scatter` of 4 and 12 (b
  padded to 4, w's 12) are one of 16, its `all_gather` of 2 and 6 one
  of 8.
* The drift gate: `corpus_diff` is empty against
  `tests/fixtures/proglint_torch/`.
* The quantized wire: the port's quantized all-reduce moves int8
  payloads and is clean under the J004 helper (the reference's
  `tests/test_quant.py` pin).
"""

import json
import os
import re
import subprocess
import sys
import textwrap

import pytest
import torch

from pytorch_distributed_example_tpu_torch import distributed as tdist
from pytorch_distributed_example_tpu_torch.nn import functional as nnf
from pytorch_distributed_example_tpu_torch.tensor import DistTensor
from pytorch_distributed_example_tpu_torch.tools import _lintcore
from pytorch_distributed_example_tpu_torch.tools import proglint as pl
from pytorch_distributed_example_tpu_torch.tools.distlint import NotOwedRuleError
from pytorch_distributed_example_tpu_torch.types import ReduceOp

from tests._mp_util import REPO
from tests._torch_gang import run_gang
from tests.test_torch_imports import HOOK

REF_CORPUS = os.path.join(REPO, "tests", "fixtures", "proglint")
PORT_CORPUS = os.path.join(REPO, "tests", "fixtures", "proglint_torch")
PLAN = ["plan.all_reduce.ring", "plan.all_reduce.rhd", "plan.all_gather.ring",
        "plan.reduce_scatter.ring"]


@pytest.fixture(scope="module")
def programs():
    return {fp.name: (fp, meta) for fp, meta in pl.build_repo_programs()}


@pytest.fixture(scope="module")
def axes():
    return pl.harvested_mesh_axes(REPO)


@pytest.fixture
def group():
    owned = not tdist.is_initialized()
    if owned:
        tdist.init_process_group(world_size=2, device="cpu")
    g = tdist._get_default_group()
    yield g if g.size() == 2 else tdist.new_group([0, 1])
    if owned:
        tdist.destroy_process_group()


@pytest.fixture
def clean_registry():
    pl.registry().clear()
    yield pl.registry()
    pl.registry().clear()


def _fp_with(eqns, **kw):
    return pl.ProgramFingerprint(name="synthetic", eqns=tuple(eqns), **kw)


def _ref_eqns(name):
    with open(os.path.join(REF_CORPUS, name + ".json"), encoding="utf-8") as fh:
        return json.load(fh)["eqns"]


class TestCollector:
    def test_axis_collectives_in_the_reference_vocabulary(self):
        x = torch.zeros(2, 8)
        eqns, _ = pl.collect_collectives(lambda: (
            nnf.all_reduce(x, "SUM", "dp"),
            nnf.all_reduce(x, ReduceOp.MAX, "dp"),
            nnf.reduce_scatter(x, "dp", 0),
            nnf.all_gather(x, "dp", 0, tiled=False),
            nnf.ppermute(x, "dp", [(0, 1), (1, 0)]),
            nnf.all_to_all(torch.zeros(2, 4, 2), "dp", 0, 1),
        ))
        assert [e.descriptor() for e in eqns] == [
            "psum|axes=dp|float32[8]",
            "pmax|axes=dp|float32[8]",
            "psum_scatter|axes=dp|float32[8]|scatter_dimension=0|tiled=True",
            "all_gather|axes=dp|float32[8]|all_gather_dimension=0",
            "ppermute|axes=dp|float32[8]|perm=0>1;1>0",
            "all_to_all|axes=dp|float32[4x2]|split_axis=0|concat_axis=1",
        ]
        assert [e.index for e in eqns] == list(range(6))

    def test_c10d_collectives_one_rank_shapes(self, group):
        eqns, _ = pl.collect_collectives(lambda: (
            tdist.all_reduce(DistTensor.wrap(torch.zeros(2, 3), group), ReduceOp.AVG, group),
            tdist.reduce_scatter(DistTensor.wrap(torch.zeros(2, 2, 3), group), ReduceOp.SUM,
                                 group),
            tdist.all_gather(DistTensor.wrap(torch.zeros(2, 3, dtype=torch.int8), group), group),
            tdist.permute(DistTensor.wrap(torch.zeros(2, 3), group), [(0, 1), (1, 0)], group),
            tdist.broadcast(DistTensor.wrap(torch.zeros(2, 3), group), 1, group),
        ))
        assert [e.descriptor() for e in eqns] == [
            "psum|axes=_ranks|float32[3]",
            "psum_scatter|axes=_ranks|float32[6]|scatter_dimension=0|tiled=True",
            "all_gather|axes=_ranks|int8[3]|all_gather_dimension=0|tiled=True",
            "ppermute|axes=_ranks|float32[3]|perm=0>1;1>0",
            "broadcast|axes=_ranks|float32[3]|detail=src=1",
        ]

    def test_a_planned_c10d_op_is_listed_once(self, group, monkeypatch, tmp_path):
        # the planner's ring schedule runs nn.functional collectives inside
        # the c10d dispatch; the program still issued ONE all-reduce
        from pytorch_distributed_example_tpu_torch import plan

        monkeypatch.setenv("TDX_PLANNER_FORCE", "ring")
        monkeypatch.setenv("TDX_PLANNER_PROBE_CACHE", str(tmp_path / "probe.json"))
        plan.enable_for_group(group, True)
        try:
            t = DistTensor.wrap(torch.arange(2 * 64, dtype=torch.float32).reshape(2, 64), group)
            eqns, _ = pl.collect_collectives(tdist.all_reduce, t, ReduceOp.SUM, group)
        finally:
            plan.enable_for_group(group, False)
        assert [e.descriptor() for e in eqns] == ["psum|axes=_ranks|float32[64]"]
        assert torch.equal(t.tensor[0], torch.arange(128.).reshape(2, 64).sum(0))

    def test_other_threads_are_not_collected(self):
        import threading

        x = torch.zeros(2, 4)
        with pl.collecting() as eqns:
            th = threading.Thread(target=lambda: nnf.all_reduce(x, "SUM", "dp"))
            th.start()
            th.join()
        assert eqns == []


class TestRules:
    def test_j001_unknown_axis_flagged_known_axis_clean(self):
        eq = pl.CollectiveEqn(0, "psum", ("ghost",), (("float32", (4,)),))
        fp = _fp_with([eq], mesh_axes=("dp",))
        bad = pl.check_fingerprint(fp, registry_axes=frozenset({"tp"}))
        assert [f.rule for f in bad] == ["J001"] and "'ghost'" in bad[0].message
        # either the binding mesh or the registry satisfies the rule
        assert not pl.check_fingerprint(fp, registry_axes=frozenset({"ghost"}))
        assert not pl.check_fingerprint(_fp_with([eq], mesh_axes=("ghost",)))

    def test_j001_reads_distlints_harvest(self, axes):
        assert {"tp", "dp", "fsdp"} <= axes

    def test_j002_structural_invalid_perms(self):
        dup_src = pl.CollectiveEqn(0, "ppermute", ("dp",), (("float32", (4,)),),
                                   perm=((0, 1), (0, 0)))
        out_of_range = pl.CollectiveEqn(1, "ppermute", ("dp",), (("float32", (4,)),),
                                        perm=((0, 1), (1, 5)))
        findings = pl.check_fingerprint(
            _fp_with([dup_src, out_of_range], mesh_axes=("dp",), world=2))
        assert [f.rule for f in findings] == ["J002", "J002"]
        assert "duplicate sources" in findings[0].message
        assert "outside world 2" in findings[1].message

    def test_j002_plan_artifact_consistency(self):
        from pytorch_distributed_example_tpu_torch.plan import schedules, topology

        topo = topology.Topology(2, ((0, 1),), "cpu")
        want = pl.expected_perms_from_plan(schedules.synthesize("all_reduce", "rhd", 2, 8, topo))
        assert len(want) == 2  # one halving + one doubling round at W=2
        good = [pl.CollectiveEqn(i, "ppermute", ("dp",), (("float32", (4,)),),
                                 perm=((0, 1), (1, 0))) for i in range(2)]
        assert not pl.check_fingerprint(_fp_with(good, mesh_axes=("dp",), world=2),
                                        expected_perms=want)
        bad = [good[0], pl.CollectiveEqn(1, "ppermute", ("dp",), (("float32", (4,)),),
                                         perm=((0, 0), (1, 1)))]
        findings = pl.check_fingerprint(_fp_with(bad, mesh_axes=("dp",), world=2),
                                        expected_perms=want)
        j002 = [f for f in findings if "artifact" in f.message]
        assert j002 and "round 2" in j002[0].message

    def test_j004_seeded_f32_payload_regression(self):
        x = torch.zeros(2, 512)
        # a "quantized" all-reduce that forgot to quantize
        eqns, _ = pl.collect_collectives(nnf.all_reduce, x, "SUM", "dp")
        assert pl.quantized_wire_violations(eqns)
        findings = pl.check_fingerprint(_fp_with(eqns, mesh_axes=("dp",), world=2),
                                        quantized_wire=True)
        assert [f.rule for f in findings] == ["J004"] and "float32" in findings[0].message

    def test_j004_scale_sidecars_are_exempt(self):
        eqns = [pl.CollectiveEqn(0, "all_to_all", ("dp",), (("int8", (2, 256)),)),
                pl.CollectiveEqn(1, "all_to_all", ("dp",), (("float32", (2, 1)),)),
                pl.CollectiveEqn(2, "all_gather", ("dp",), (("bfloat16", (512,)),))]
        viols = pl.quantized_wire_violations(eqns)
        assert [(e.index, d) for e, (d, _), _ in viols] == [(2, "bfloat16")]

    def test_suppression_marks_not_drops(self):
        eq = pl.CollectiveEqn(0, "psum", ("ghost",), (("float32", (4,)),))
        findings = pl.check_fingerprint(_fp_with([eq]), suppress=(("J001", "synthetic"),))
        assert len(findings) == 1 and findings[0].suppressed

    def test_severity_off_and_warning(self):
        eq = pl.CollectiveEqn(0, "psum", ("ghost",), (("float32", (4,)),))
        assert not pl.check_fingerprint(_fp_with([eq]), severity={"J001": "off"})
        warn = pl.check_fingerprint(_fp_with([eq]), severity={"J001": "warning"})
        assert warn and warn[0].severity == "warning"


class TestJ003NotOwed:
    def test_explain_fails_with_the_reason(self):
        with pytest.raises(NotOwedRuleError, match="donate="):
            pl.explain_rule("J003")
        assert pl.explain_rule("j002").startswith("J002: ppermute")
        assert "J003" not in pl.RULES

    def test_severity_entry_fails_with_the_reason(self, tmp_path):
        cfg = tmp_path / _lintcore.CONFIG_PATH
        cfg.parent.mkdir(parents=True)
        cfg.write_text('[tool.proglint.severity]\nJ003 = "off"\n')
        with pytest.raises(NotOwedRuleError, match="not owed"):
            pl.load_config(str(tmp_path))
        assert pl.main(["--root", str(tmp_path)]) == 2

    def test_cli_explain(self, capsys):
        assert pl.main(["--explain", "J003"]) == 2
        assert "ignores it" in capsys.readouterr().err
        assert "donated" not in json.dumps(pl.ProgramFingerprint(name="p").canonical())


class TestSeams:
    def test_off_returns_the_programs_as_they_are(self, monkeypatch, group):
        monkeypatch.delenv("TDX_PROGLINT", raising=False)
        from pytorch_distributed_example_tpu_torch.plan import driver

        prog = driver.compiled_body("all_reduce", "ring", 2)
        assert not hasattr(prog, "_proglint_wrapped")
        f = lambda t: t  # noqa: E731
        assert pl.instrument("t", f) is f

    def test_the_three_seams_fingerprint_on_the_first_call_only(
            self, monkeypatch, group, clean_registry):
        monkeypatch.setenv("TDX_PROGLINT", "1")
        from pytorch_distributed_example_tpu_torch import optim
        from pytorch_distributed_example_tpu_torch.parallel.ddp import make_ddp_train_step
        from pytorch_distributed_example_tpu_torch.plan import driver
        from pytorch_distributed_example_tpu_torch.serve import decode

        model = pl._tiny_model()
        prefill, _, _ = decode.slot_programs(model, 0.0, None)
        pc, ft, at, st = decode.paged_programs(model, 0.0, None)
        assert all(hasattr(p, "_proglint_wrapped") for p in (prefill, pc, ft, at, st))
        prompt = torch.zeros((1, 8), dtype=torch.int32)
        first = prefill(prompt, 8, 0)
        again = prefill(prompt, 8, 0)
        assert torch.equal(first[1], again[1])

        prog = driver.compiled_body("all_reduce", "rhd", 2)
        x = torch.arange(16, dtype=torch.float32).reshape(2, 8)
        assert torch.equal(prog(x), prog(x)) and torch.equal(prog(x)[0], x.sum(0))

        step = make_ddp_train_step(lambda p, x: x @ p["w"], lambda o, y: ((o - y) ** 2).mean(),
                                   optim.sgd(0.1), group=group)
        assert hasattr(step, "init_opt_state") and step.weight_update_sharded
        params = {"w": torch.ones((4, 3))}
        opt = step.init_opt_state(params)
        for _ in range(3):
            params, opt, _ = step(params, opt, torch.ones((4, 4)), torch.zeros((4, 3)))

        names = [(n, k) for n, k, _ in clean_registry.entries()]
        assert names == [("serve.slot.prefill", 0), ("plan.all_reduce.rhd", 0),
                         ("ddp.train_step.zero", 0)]
        (fp,) = clean_registry.get("plan.all_reduce.rhd")
        assert fp.path.endswith("plan/driver.py") and fp.world == 2
        assert fp.eqn_descriptors() == _ref_eqns("plan.all_reduce.rhd")
        assert clean_registry.get("serve.slot.prefill")[0].eqns == ()


class TestAgreementGang:
    @pytest.fixture(scope="class")
    def gang(self, tmp_path_factory):
        def run(algs):
            rcs, outs, res = run_gang("tests._torch_mp_proglint", tmp_path_factory.mktemp("g"),
                                      2, extra_env={"TDX_PROGLINT": "1"}, args=(algs,),
                                      timeout=120)
            assert rcs == [0, 0], "\n".join(outs)
            return res
        return run

    def test_agreeing_ranks_run(self, gang):
        res = gang("ring,ring")
        want = torch.arange(8, dtype=torch.float32) * 2 + 10
        for r, got in enumerate(res):
            assert got["wrapped"] and "mismatch" not in got, got
            assert torch.equal(got["y"][0], want) and torch.equal(got["again"][0], want)
            assert [(n, k) for n, k, _ in got["registry"]] == [
                ("plan.all_reduce.ring", 0), ("ddp.train_step.zero", 0)]
        assert torch.equal(res[0]["ddp"]["w"], res[1]["ddp"]["w"])
        # one process a rank issues the program driver mode issues for all
        regs = [{n: fp for n, _, fp in got["registry"]} for got in res]
        assert regs[0] == regs[1]
        assert regs[0]["plan.all_reduce.ring"]["eqns"] == _ref_eqns("plan.all_reduce.ring")
        with open(os.path.join(PORT_CORPUS, "ddp.train_step.zero.json"), encoding="utf-8") as fh:
            assert regs[0]["ddp.train_step.zero"] == json.load(fh)

    def test_a_skewed_rank_raises_on_both_ranks(self, gang):
        for r, got in enumerate(gang("ring,rhd")):
            msg = got.get("mismatch")
            assert msg, (r, got)
            assert "compiled-program divergence" in msg and "'reg0/c0'" in msg
            # the first divergent collective, named
            assert "first divergent collective eqn is #1" in msg
            assert "psum_scatter|axes=_ranks" in msg and "ppermute|axes=_ranks" in msg


def _merged(eqns):
    """Consecutive collectives of one op and parameters as one: their
    one-rank sizes added (the port's flat-buffer ZeRO layout)."""
    out = []
    for d in eqns:
        m = re.match(r"([^|]+\|axes=[^|]*\|)(\w+)\[([\dx]*)\](.*)", d)
        head, dtype, shape, tail = m.groups()
        n = 1
        for s in filter(None, shape.split("x")):
            n *= int(s)
        if out and out[-1][0] == (head, dtype, tail) and shape:
            out[-1][1] += n
        else:
            out.append([(head, dtype, tail), n if shape else None])
    return [f"{h}{d}[{'' if n is None else n}]{t}" for (h, d, t), n in out]


class TestAgainstReference:
    @pytest.mark.parametrize("name", PLAN)
    def test_plan_programs_are_the_references(self, programs, axes, name):
        fp, meta = programs[name]
        assert fp.eqn_descriptors() == _ref_eqns(name)
        assert meta.expected_perms is not None
        assert not pl.check_fingerprint(fp, registry_axes=axes,
                                        expected_perms=meta.expected_perms)

    def test_ddp_zero_under_the_flat_buffer_mapping(self, programs):
        fp, _ = programs["ddp.train_step.zero"]
        ref = _ref_eqns("ddp.train_step.zero")
        assert ref[1:3] == [
            "psum_scatter|axes=_ranks|float32[4]|scatter_dimension=0|tiled=True",
            "psum_scatter|axes=_ranks|float32[12]|scatter_dimension=0|tiled=True"]
        assert _merged(ref) == fp.eqn_descriptors() == [
            "psum|axes=_ranks|float32[]",
            "psum_scatter|axes=_ranks|float32[16]|scatter_dimension=0|tiled=True",
            "all_gather|axes=_ranks|float32[8]|all_gather_dimension=0|tiled=True",
        ]

    def test_serve_paged_step_has_no_collectives(self, programs):
        assert programs["serve.paged.step"][0].eqns == () == tuple(_ref_eqns("serve.paged.step"))


class TestCorpusAndCatalog:
    def test_no_drift(self, programs):
        pairs = list(programs.values())
        assert pl.corpus_diff(pairs, PORT_CORPUS, pl.CORPUS_PROGRAMS) == []

    def test_drift_is_reported(self, programs, tmp_path):
        pairs = list(programs.values())
        pl.write_corpus(pairs, str(tmp_path), pl.CORPUS_PROGRAMS)
        doc = json.loads((tmp_path / "plan.all_reduce.rhd.json").read_text())
        doc["eqns"] = doc["eqns"][:1]
        (tmp_path / "plan.all_reduce.rhd.json").write_text(json.dumps(doc))
        (tmp_path / "serve.paged.step.json").unlink()
        problems = pl.corpus_diff(pairs, str(tmp_path), pl.CORPUS_PROGRAMS)
        assert len(problems) == 2
        assert any("plan.all_reduce.rhd: eqns drifted" in p for p in problems)
        assert any("serve.paged.step: no golden corpus entry" in p for p in problems)

    def test_catalog_names(self, programs):
        assert set(pl.CORPUS_PROGRAMS) <= set(programs)
        for prefix in ("serve.slot.", "serve.paged.", "ddp.train_step.", "plan.traced."):
            assert any(n.startswith(prefix) for n in programs), prefix
        assert "ops.quantized_all_reduce" in programs

    def test_catalog_is_clean(self, programs):
        findings = pl.lint_repo_programs(REPO, list(programs.values()))
        assert not findings, [f.render() for f in findings]

    def test_quantized_wire_is_clean(self, programs):
        fp, meta = programs["ops.quantized_all_reduce"]
        assert meta.quantized_wire
        assert not pl.quantized_wire_violations(fp.eqns)
        dtypes = {d for e in fp.eqns for d, _ in e.operands}
        assert "int8" in dtypes
        prims = [e.primitive for e in fp.eqns]
        assert "all_to_all" in prims and "all_gather" in prims

    def test_cli_without_jax(self):
        script = HOOK + textwrap.dedent("""
            import runpy
            sys.argv = ["proglint", "--corpus", "--format", "json"]
            runpy.run_module("pytorch_distributed_example_tpu_torch.tools.proglint",
                             run_name="__main__")
        """)
        proc = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True,
                              cwd=REPO, timeout=600)
        assert proc.returncode == 0, proc.stdout + proc.stderr
        assert json.loads(proc.stdout) == []
