"""The port's storelint (`pytorch_distributed_example_tpu_torch/tools/storelint.py`).

* Against the reference, on the same inputs: S001-S007 over the
  reference's rule corpus (`tests/fixtures/storelint/`, parsed, never
  imported) give identical (rule, path, line, col, fingerprint) sets.
* `--explore` on the port's REAL protocol code: the four shipped
  scenarios (ledger, leader, resize, done) pass, and `--seed-revert
  pr16` (the worker's missing-grace window zeroed) is caught as a
  lost-seq counterexample — in the port and in the reference alike.
* The self-gate: the port's store key registry lints clean at a
  zero-entry baseline.
"""

import os

import pytest

from pytorch_distributed_example_tpu.tools import storelint as ref
from pytorch_distributed_example_tpu_torch.tools import _lintcore
from pytorch_distributed_example_tpu_torch.tools import storelint as sl

from tests._mp_util import REPO

CORPUS = os.path.join(REPO, "tests", "fixtures", "storelint")
BASELINE = os.path.join(REPO, _lintcore.BASELINE_DIR, "storelint.json")


def _ids(findings):
    return {(f.rule, f.path, f.line, f.col, f.fingerprint, f.suppressed) for f in findings}


@pytest.fixture(scope="module")
def port_tree():
    return sl.lint(REPO, sl.load_config(REPO))


@pytest.fixture(scope="module")
def explore_cli():
    """The port's `--explore --quick --seed-revert pr16`, run once."""
    import contextlib
    import io

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = sl.main(["--explore", "--quick", "--seed-revert", "pr16"])
    return rc, out.getvalue()


class TestAgainstTheReference:
    def test_rule_corpus(self):
        theirs, _ = ref.lint(CORPUS, ref.StorelintConfig(paths=["."], exclude=[]))
        ours, _ = sl.lint(CORPUS, sl.StorelintConfig(paths=["."], exclude=[]))
        assert _ids(ours) == _ids(theirs)
        active = sorted(f.rule for f in ours if not f.suppressed)
        assert active == sorted(sl.RULES)  # one of each, nothing more
        assert any(f.suppressed for f in ours)

    def test_reference_explorer_on_its_own_protocols(self):
        reports = ref.run_scenarios(seed_revert="pr16", max_schedules=150)
        by_name = {r.scenario: r for r in reports}
        for name in ref.SCENARIOS:
            assert by_name[name].ok, name
        assert by_name["ledger-pr16-revert"].counterexample is not None


class TestExplore:
    def test_exit_zero(self, explore_cli):
        rc, out = explore_cli
        assert rc == 0, out

    def test_shipped_scenarios_pass_on_the_port(self, explore_cli):
        _, out = explore_cli
        assert set(sl.SCENARIOS) == {"ledger", "leader", "resize", "done"}
        for name in sl.SCENARIOS:
            assert f"scenario '{name}': no violation" in out, out

    def test_revert_prints_a_counterexample(self, explore_cli):
        _, out = explore_cli
        assert "seeded-revert scenario 'ledger-pr16-revert': VIOLATION" in out, out
        assert "add serve/work/head" in out and "LOST" in out, out

    def test_scenarios_drive_the_port(self, monkeypatch):
        """The explorer runs the port's own protocol functions."""
        from pytorch_distributed_example_tpu_torch.elastic import agent
        from pytorch_distributed_example_tpu_torch.serve import worker

        calls = []
        for cls, name in ((worker.ServeWorker, "_claim_available"),
                          (worker.ServeWorker, "_restore_geometry"),
                          (worker.ServeWorker, "_publish_completions"),
                          (worker.GangRouter, "submit")):
            real = getattr(cls, name)

            def spy(*a, _real=real, _name=name, **k):
                calls.append(_name)
                return _real(*a, **k)

            monkeypatch.setattr(cls, name, spy)
        real_stamp = agent._stamp_resize
        monkeypatch.setattr(agent, "_stamp_resize",
                            lambda *a: calls.append("_stamp_resize") or real_stamp(*a))
        for name in sl.SCENARIOS:
            assert sl.explore(sl.SCENARIOS[name], max_schedules=1).ok, name
        assert set(calls) == {"_claim_available", "_restore_geometry", "_publish_completions",
                              "submit", "_stamp_resize"}

    def test_unknown_scenario_is_exit_2(self, capsys):
        assert sl.main(["--explore", "--scenario", "nope"]) == 2
        assert "unknown scenario" in capsys.readouterr().err


class TestSelfGate:
    def test_port_tree_has_no_findings(self, port_tree):
        findings, reg = port_tree
        active = [f for f in findings if not f.suppressed and f.severity == "error"]
        assert not active, "\n".join(f"{f.path}:{f.line} {f.rule} {f.message}" for f in active)
        # the registry sees the protocols explore drives
        families = {u.text for u in reg.usages}
        assert {"serve/work/head", "serve/work/item/{seq}", "agent/resize_target"} <= families

    def test_registry_is_the_ports(self, port_tree):
        _, reg = port_tree
        paths = {u.path for u in reg.usages}
        assert paths and all(p.startswith("pytorch_distributed_example_tpu_torch/") for p in paths)
        assert not any(p.endswith("tools/storelint.py") for p in paths)

    def test_baseline_is_committed_and_empty(self):
        doc = sl.load_baseline(BASELINE)
        assert doc["tool"] == "storelint" and doc["findings"] == []
        assert doc["naive_first_run_count"] >= 1

    def test_config_reads_the_port_config(self, tmp_path):
        cfg = tmp_path / _lintcore.CONFIG_PATH
        cfg.parent.mkdir(parents=True)
        cfg.write_text('[tool.storelint]\nretained_families = ["log/*"]\n'
                       '[tool.storelint.severity]\nS005 = "warning"\n')
        loaded = sl.load_config(str(tmp_path))
        assert loaded.retained_families == ["log/*"]
        assert loaded.rule_severity("S005") == "warning"
        assert sl.load_config(REPO).paths == ["pytorch_distributed_example_tpu_torch"]
