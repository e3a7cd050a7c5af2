"""The port's distlint (`pytorch_distributed_example_tpu_torch/tools/distlint.py`).

* Against the reference, on the same inputs: the shared rules (R001-R010,
  R013, R014) give identical (rule, path, line, col, fingerprint) sets
  over the reference's interprocedural fixture corpus and over every
  inline fixture source of the reference's own rule tests (parsed, never
  imported). The JAX-specific fixtures (trace roots, donation, specs)
  stay out.
* The port's own rule shapes, each marked in
  `tests/fixtures/distlint_interproc_torch/` with `# expect: Rnnn`:
  the port's collective call forms (torch.distributed, `_dispatch`,
  nn/functional's rank collectives) under the shared rules; R011 under
  torch.func transforms, torch.compile and checkpointing; R015 over the
  port's spec form; and the three corrections the port's
  idiom needed (a local callable named like a collective, the
  axis-scoped rank collectives under R004, rank-gated p2p).
* R012 is not owed, and asking for it by name fails with the reason.
* The self-gate: the port's tree lints clean at a zero-entry baseline.
"""

import ast
import json
import os
import re
import textwrap

import pytest

from pytorch_distributed_example_tpu.tools import distlint as ref
from pytorch_distributed_example_tpu_torch.tools import _lintcore
from pytorch_distributed_example_tpu_torch.tools import distlint as dl

from tests._mp_util import REPO

SHARED = {f"R{i:03d}" for i in (1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 13, 14)}
REF_CORPUS = "tests/fixtures/distlint_interproc"
# R011/R012/R015 corpora: jit/shard_map trace roots, donation, PartitionSpec
JAX_FIXTURES = ["traced.py", "donate.py", "specs.py", "planner_hook.py", "hostops.py"]
PORT_CORPUS = "tests/fixtures/distlint_interproc_torch"
BASELINE = os.path.join(REPO, _lintcore.BASELINE_DIR, "distlint.json")

_MEMO: dict = {}


def _ids(findings):
    return {
        (f.rule, f.path, f.line, f.col, f.fingerprint, f.suppressed)
        for f in findings
        if f.rule in SHARED
    }


def _port_project():
    """One build of the port's project for the module (the default config)."""
    if "project" not in _MEMO:
        _MEMO["project"] = dl.build_project(root=REPO)
    return _MEMO["project"]


def _port_tree():
    if "tree" not in _MEMO:
        _MEMO["tree"] = dl.lint_paths(root=REPO, project=_port_project())
    return _MEMO["tree"]


def _inline_sources(test_file):
    """Every multi-line string of a reference test file that parses as
    Python and is not a docstring: the fixture sources its tests lint."""
    with open(os.path.join(REPO, test_file), encoding="utf-8") as fh:
        tree = ast.parse(fh.read())
    docs = {
        id(n.body[0].value)
        for n in ast.walk(tree)
        if isinstance(n, (ast.Module, ast.ClassDef, ast.FunctionDef))
        and n.body and isinstance(n.body[0], ast.Expr)
        and isinstance(n.body[0].value, ast.Constant)
    }
    out = []
    for n in ast.walk(tree):
        if not (isinstance(n, ast.Constant) and isinstance(n.value, str)):
            continue
        if "\n" not in n.value or id(n) in docs:
            continue
        src = textwrap.dedent(n.value)
        try:
            ast.parse(src)
        except SyntaxError:
            continue
        if not re.search(r"jax|PartitionSpec|donate|R01[125]", src):
            out.append(src)
    return out


def _ref_points():
    """The reference rule tests' fault-point registry (`_POINTS`)."""
    with open(os.path.join(REPO, "tests", "test_distlint.py"), encoding="utf-8") as fh:
        for node in ast.parse(fh.read()).body:
            if isinstance(node, ast.Assign) and node.targets[0].id == "_POINTS":
                return ast.literal_eval(node.value)
    raise AssertionError("tests/test_distlint.py lost its _POINTS registry")


def _expected(paths):
    """(file, line, rule) of every `# expect: Rnnn` marker."""
    out = set()
    for p in paths:
        with open(os.path.join(REPO, p), encoding="utf-8") as fh:
            for i, line in enumerate(fh, 1):
                m = re.search(r"# expect: (R\d{3})", line)
                if m:
                    out.add((os.path.basename(p), i, m.group(1)))
    return out


def _port_fixture(*names):
    paths = [f"{PORT_CORPUS}/{n}" for n in names]
    findings = dl.lint_paths(root=REPO, config=dl.LintConfig(paths=paths))
    got = {(os.path.basename(f.path), f.line, f.rule) for f in findings if not f.suppressed}
    return got, _expected(paths), findings


class TestAgainstTheReference:
    def test_interprocedural_corpus(self):
        cfg = dict(paths=[REF_CORPUS], exclude=JAX_FIXTURES)
        theirs = ref.lint_paths(root=REPO, config=ref.LintConfig(**cfg))
        ours = dl.lint_paths(root=REPO, config=dl.LintConfig(**cfg))
        assert _ids(ours) == _ids(theirs)
        assert {f.rule for f in theirs} >= {"R001", "R002", "R003", "R004", "R013", "R014"}

    @pytest.mark.parametrize("test_file", ["tests/test_distlint.py", "tests/test_distlint_trace.py"])
    def test_inline_rule_sources(self, test_file):
        sources = _inline_sources(test_file)
        points = _ref_points()
        assert sources
        rules = set()
        for src in sources:
            for kw in ({"dispatch_path": False},
                       {"dispatch_path": True, "store_lifecycle": True}):
                theirs = ref.lint_source(src, "x.py", fault_points=points, **kw)
                ours = dl.lint_source(src, "x.py", fault_points=points, **kw)
                assert _ids(ours) == _ids(theirs), src
                rules |= {f.rule for f in theirs}
        if test_file == "tests/test_distlint.py":
            assert len(sources) >= 70
            assert rules >= {f"R{i:03d}" for i in range(1, 11)}

    def test_fingerprint_is_the_references(self):
        src = "def f(t, dist):\n    if dist.get_rank() == 0:\n        dist.all_reduce(t)\n"
        (theirs,) = ref.lint_source(src, "pkg/m.py")
        (ours,) = dl.lint_source(src, "pkg/m.py")
        assert ours.fingerprint == theirs.fingerprint and ours.rule == "R001"


class TestPortRuleShapes:
    def test_r011_under_transforms_and_compile(self):
        got, want, findings = _port_fixture("r011_transforms.py")
        assert got == want
        assert len(want) == 8
        why = " ".join(f.message for f in findings)
        for root in ("vmap", "torch.compile", "grad", "grad_and_value", "vjp",
                     "called from a lambda passed to `vmap`"):
            assert root in why, root

    def test_r015_over_the_port_spec_form(self):
        got, want, findings = _port_fixture("r015_specs.py")
        assert got == want
        axes = {re.search(r"axis `(\w+)`", f.message).group(1) for f in findings}
        assert axes == {"model", "heads", "sequence", "batch", "zero", "expert"}
        cfg = dl.LintConfig(paths=[f"{PORT_CORPUS}/r015_specs.py"])
        assert dl.harvested_mesh_axes(root=REPO, config=cfg) == {"dp", "tp", "fsdp"}

    def test_r015_silent_without_a_mesh(self):
        src = "def place(mesh, spec_to_placements):\n    return spec_to_placements(('model',), mesh)\n"
        assert dl.lint_source(src, "x.py") == []

    def test_local_callable_shadowing_a_collective(self):
        got, want, _ = _port_fixture("shadowed.py")
        assert got == want and [r for _, _, r in want] == ["R004"]

    def test_axis_scoped_collectives_owe_no_group(self):
        got, want, _ = _port_fixture("__init__.py", "axis_ops.py", "axis_caller.py")
        assert got == want and len(want) == 1

    def test_rank_gated_p2p_is_the_idiom(self):
        got, want, _ = _port_fixture("p2p_gate.py")
        assert got == want and len(want) == 1

    def test_the_port_call_forms_are_collectives(self):
        got, want, _ = _port_fixture("port_forms.py")
        assert got == want
        assert sorted(r for _, _, r in want) == ["R001"] * 4 + ["R002", "R006"]

    def test_harvested_mesh_axes_of_the_port(self):
        axes = dl.harvested_mesh_axes(root=REPO, project=_port_project())
        assert {"dp", "fsdp", "tp", "ep", "pp", "sp"} <= axes


class TestR012NotOwed:
    def test_absent_from_the_rule_table(self):
        assert "R012" not in dl.RULES and "R012" in dl.NOT_OWED
        assert set(dl.RULES) == {f"R{i:03d}" for i in range(1, 16)} - {"R012"}

    def test_explain_by_name_fails_with_the_reason(self, capsys):
        with pytest.raises(dl.NotOwedRuleError, match="ignores it"):
            dl.explain_rule("r012")
        assert dl.main(["--explain", "R012"]) == 2
        assert "not owed" in capsys.readouterr().err
        assert dl.main(["--explain", "R011"]) == 0
        assert "torch.compile" in capsys.readouterr().out

    def test_severity_entry_fails_with_the_reason(self, tmp_path):
        cfg = tmp_path / _lintcore.CONFIG_PATH
        cfg.parent.mkdir(parents=True)
        cfg.write_text('[tool.distlint.severity]\nR012 = "error"\n')
        with pytest.raises(dl.NotOwedRuleError, match="donate"):
            dl.load_config(str(tmp_path))


class TestConfigAndCli:
    def test_load_config_reads_the_port_config(self):
        cfg = dl.load_config(REPO)
        assert "pytorch_distributed_example_tpu_torch" in cfg.paths
        assert "tests/test_torch_*.py" in cfg.paths
        assert any(m.endswith("backends/process.py") for m in cfg.dispatch_path_modules)
        assert cfg.fault_registry == "pytorch_distributed_example_tpu_torch/faults.py"
        assert dl.load_config(REPO) == dl.LintConfig()  # the file restates the defaults

    def test_dispatch_path_matching_from_config(self):
        cfg = dl.load_config(REPO)
        src = "def f(x):\n    try:\n        x()\n    except Exception:\n        pass\n"
        flagged = dl.lint_source(src, "pytorch_distributed_example_tpu_torch/backends/stacked.py",
                                 config=cfg)
        clean = dl.lint_source(src, "pytorch_distributed_example_tpu_torch/models/bert.py",
                               config=cfg)
        assert [f.rule for f in flagged] == ["R005"]
        assert clean == []

    def test_bad_severity_value_rejected(self, tmp_path):
        cfg = tmp_path / _lintcore.CONFIG_PATH
        cfg.parent.mkdir(parents=True)
        cfg.write_text("[tool.distlint.severity]\nR001 = 'loud'\n")
        with pytest.raises(ValueError):
            dl.load_config(str(tmp_path))

    def test_glob_paths_and_a_glob_matching_nothing(self, tmp_path, capsys):
        (tmp_path / "a_one.py").write_text("def f(t, dist):\n    dist.all_reduce(t)\n")
        (tmp_path / "a_two.py").write_text(
            "def f(t, dist):\n    if dist.get_rank() == 0:\n        dist.all_reduce(t)\n")
        cfg = dl.LintConfig(paths=["a_*.py"])
        assert [f.rule for f in dl.lint_paths(root=str(tmp_path), config=cfg)] == ["R001"]
        assert dl.main(["b_*.py", "--root", str(tmp_path), "--no-config"]) == 2
        assert "matches nothing" in capsys.readouterr().err

    def test_cli_json_sarif_and_exit_codes(self, tmp_path, capsys):
        bad = tmp_path / "bad.py"
        bad.write_text("def f(t, dist):\n    if dist.get_rank() == 0:\n        dist.all_reduce(t)\n")
        rc = dl.main([str(bad), "--root", str(tmp_path), "--json", "--no-config"])
        assert rc == 1
        assert [f["rule"] for f in json.loads(capsys.readouterr().out)] == ["R001"]
        assert dl.main([str(bad), "--root", str(tmp_path), "--format", "sarif",
                        "--no-config"]) == 1
        run = json.loads(capsys.readouterr().out)["runs"][0]
        assert run["tool"]["driver"]["name"] == "distlint"
        assert [r["ruleId"] for r in run["results"]] == ["R001"]
        assert run["results"][0]["partialFingerprints"]["distlint/v1"]
        good = tmp_path / "good.py"
        good.write_text("def f(t, dist):\n    dist.all_reduce(t)\n")
        assert dl.main([str(good), "--root", str(tmp_path), "--no-config"]) == 0

    def test_fix_forwards_group(self, tmp_path, capsys):
        bad = tmp_path / "bad.py"
        bad.write_text(
            "def f(t, group, dist):\n"
            "    dist.all_reduce(t)\n"
            "    dist.broadcast(\n"
            "        t,\n"
            "        0,\n"
            "    )\n"
        )
        assert dl.main([str(bad), "--root", str(tmp_path), "--no-config", "--fix-diff"]) == 0
        assert "+    dist.all_reduce(t, group=group)" in capsys.readouterr().out
        assert "group=group" not in bad.read_text()
        assert dl.main([str(bad), "--root", str(tmp_path), "--no-config", "--fix"]) == 0
        assert "dist.all_reduce(t, group=group)" in bad.read_text()
        assert dl.lint_file(str(bad), dl.LintConfig(), root=str(tmp_path)) == []


class TestSelfGate:
    def test_port_tree_has_no_findings(self):
        findings = _port_tree()
        new, _, stale = dl.apply_baseline(findings, dl.load_baseline(BASELINE))
        assert not new, dl.render_report(new)
        assert not stale

    def test_fault_registry_is_the_ports(self):
        from pytorch_distributed_example_tpu_torch import faults

        assert _port_project().fault_points == set(faults.KNOWN_POINTS)
        src = 'from . import faults\n\ndef f():\n    faults.fire("no.such.point")\n'
        findings = dl.lint_source(src, "x.py", project=_port_project())
        assert [f.rule for f in findings] == ["R008"]

    def test_baseline_is_committed_and_empty(self):
        doc = dl.load_baseline(BASELINE)
        assert doc["tool"] == "distlint" and doc["findings"] == []
        assert doc["naive_first_run_count"] >= 1

    def test_the_scan_covers_package_smoke_script_and_tests(self):
        files = list(dl._iter_py_files(dl.LintConfig().paths, dl.DEFAULT_EXCLUDE, REPO))
        rels = {os.path.relpath(f, REPO).replace(os.sep, "/") for f in files}
        assert {"chip_smoke.py", "tests/test_torch_distlint.py"} <= rels
        assert "pytorch_distributed_example_tpu_torch/examples/lm.py" in rels
        assert not any(r.startswith("pytorch_distributed_example_tpu/") for r in rels)

    def test_suppressions_carry_reasons(self):
        pat = re.compile(r"#\s*(?:distlint|storelint):\s*disable(?:-file)?=[A-Za-z0-9_,\s]+")
        bad = []
        for fp in dl._iter_py_files(dl.LintConfig().paths, dl.DEFAULT_EXCLUDE, REPO):
            with open(fp, encoding="utf-8") as fh:
                for i, line in enumerate(fh, 1):
                    m = pat.search(line)
                    if m and "--" not in line[m.end():]:
                        bad.append(f"{fp}:{i}")
        assert not bad, bad
