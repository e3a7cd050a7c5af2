"""The port's unified lint entry point (`pytorch_distributed_example_tpu_torch/tools/lint.py`).

* The CLI gate, once, as a subprocess under `tests/test_torch_imports.py`'s
  import hook (which refuses JAX and the JAX package): it runs the four
  planes in the reference's order (distlint, proglint, storelint,
  numlint), exits 0 over the port's tree at zero-entry baselines, and
  its one merged SARIF artifact holds one run per plane.
* A seeded finding of ANY shipped static rule (R001-R011, R013-R015,
  J001, J002, J004, S001-S007, N001-N007) fails the single exit code, and
  so does a crashing plane. proglint lints the port's registered
  programs, not the root's sources, so its seeds replace the program
  catalog (`proglint.build_repo_programs`) with one seeded program.
"""

import json
import os
import subprocess
import sys
import textwrap

import pytest

from pytorch_distributed_example_tpu_torch.tools import _lintcore
from pytorch_distributed_example_tpu_torch.tools import lint as unified
from pytorch_distributed_example_tpu_torch.tools import proglint

from tests._mp_util import REPO
from tests.test_torch_imports import HOOK

EXPECTED_ORDER = ["distlint", "proglint", "storelint", "numlint"]

# One seeded module a rule, each of which trips that rule once.
_SEEDS = {
    "R001": """
        def f(t, dist):
            if dist.get_rank() == 0:
                dist.all_reduce(t)
    """,
    "R002": """
        def f(t, dist, log):
            try:
                dist.all_reduce(t)
            except Exception:
                log.warning("swallowed")
    """,
    "R003": """
        def f(t, dist, store):
            w = dist.all_reduce(t, async_op=True)
            store.get("flag")
            w.wait()
    """,
    "R004": """
        def f(t, dist, group):
            dist.all_reduce(t)
    """,
    "R005": """
        def f(x):
            try:
                x()
            except Exception:
                pass
    """,
    "R006": """
        def f(t, dist):
            dist.all_reduce(t, async_op=True)
    """,
    "R007": """
        def f(store):
            store.set("cfg/flag", b"1")
            return store.get("cfg/flag")
    """,
    "R008": """
        from . import faults

        def f():
            faults.fire("no.such.point")
    """,
    "R009": """
        def f(t):
            return t  # distlint: disable=R001 -- nothing here any more
    """,
    "R010": """
        def f(dist, local_shards):
            for s in local_shards:
                dist.all_reduce(s)
    """,
    "R011": """
        from torch.func import vmap

        def body(x):
            return x.item()

        def run(xs):
            return vmap(body)(xs)
    """,
    "R013": """
        def f(pool, table, req, cap):
            blocks = pool.allocate()
            if cap < 1:
                return None
            table[req] = blocks
            return req
    """,
    "R014": """
        import threading

        class M:
            def __init__(self):
                self._lock = threading.Lock()
                self.n = 0

            def inc(self):
                with self._lock:
                    self.n += 1

            def reset(self):
                self.n = 0
    """,
    "R015": """
        def build(devices, DeviceMesh):
            return DeviceMesh(devices, (2,), ("dp",))

        def place(mesh, spec_to_placements):
            return spec_to_placements(("model",), mesh)
    """,
}
# numlint's, in the port's idiom: one module a rule
_N_SEEDS = {
    "N001": """
        import torch

        def cast(x):
            return x.to(torch.bfloat16)

        @numerics_contract("bitwise")
        def step(w, batch):
            return torch.matmul(cast(batch), w)
    """,
    "N002": """
        def scatter(flat, nnf):
            return nnf.reduce_scatter(flat, "dp", 0)

        @numerics_contract("bitwise")
        def update(flat, nnf):
            return scatter(flat, nnf)
    """,
    "N003": """
        def leak(x, quantize_blockwise):
            q, _scales = quantize_blockwise(x, 64)
            return q
    """,
    "N004": """
        import torch

        def save_checkpoint(path, leaves):
            torch.save([l.to(torch.float16) for l in leaves], path)

        def load_checkpoint(path):
            return torch.load(path)
    """,
    "N005": """
        @numerics_contract("token_exact")
        def pair(key, prng):
            return prng.uniform(key, (4,)), prng.uniform(key, (4,))
    """,
    "N006": """
        import time

        import torch

        @torch.compile
        def stamp(x):
            return x * time.time()
    """,
    "N007": """
        import torch

        @numerics_contract("bitwise")
        def exact(p, g):
            return p - 0.1 * g

        def test_exact():
            torch.testing.assert_close(exact(1.0, 1.0), 0.9, rtol=1e-5, atol=0.0)
    """,
}
# proglint's: one seeded program a rule
_J_SEEDS = {
    "J001": (proglint.CollectiveEqn(0, "psum", ("ghost",), (("float32", (4,)),)), {}),
    "J002": (proglint.CollectiveEqn(0, "ppermute", ("dp",), (("float32", (4,)),),
                                    perm=((0, 1), (0, 0))), {}),
    "J004": (proglint.CollectiveEqn(0, "psum", ("dp",), (("float32", (512,)),)),
             {"quantized_wire": True}),
}
# storelint's: the reference's rule corpus, one module a rule
_S_CORPUS = {
    "S001": "s001_wait.py", "S002": "s002_dead_write.py", "S003": "s003_skew.py",
    "S004": "s004_scope.py", "S005": "s005_retained.py", "S006": "s006_cas.py",
    "S007": "s007_pr16.py",
}
_CONFIG = """
[tool.distlint]
paths = ["pkg"]
exclude = []
fault_registry = "pkg/faults.py"
store_lifecycle_paths = ["pkg"]
dispatch_path_modules = ["pkg/mod.py"]
trace_roots = []

[tool.storelint]
paths = ["pkg"]
exclude = []

[tool.numlint]
paths = ["pkg"]
exclude = []
"""


def _root(tmp_path, source):
    pkg = tmp_path / "pkg"
    pkg.mkdir()
    (pkg / "__init__.py").write_text("")
    (pkg / "faults.py").write_text('KNOWN_POINTS = frozenset({"train.step"})\n')
    (pkg / "mod.py").write_text(source)
    cfg = tmp_path / _lintcore.CONFIG_PATH
    cfg.parent.mkdir(parents=True)
    cfg.write_text(_CONFIG)
    return str(tmp_path)


@pytest.fixture(scope="module")
def cli(tmp_path_factory):
    out = tmp_path_factory.mktemp("sarif") / "lint.sarif"
    script = HOOK + textwrap.dedent(f"""
        import runpy
        sys.argv = ["lint", "--sarif-out", {str(out)!r}]
        runpy.run_module("pytorch_distributed_example_tpu_torch.tools.lint",
                         run_name="__main__")
    """)
    proc = subprocess.run([sys.executable, "-c", script], capture_output=True,
                          text=True, cwd=REPO, timeout=600)
    return proc, out


class TestLintGate:
    def test_exit_zero_without_jax(self, cli):
        proc, _ = cli
        assert proc.returncode == 0, proc.stdout + proc.stderr
        assert "the port imported" not in proc.stderr

    def test_every_plane_reported(self, cli):
        proc, _ = cli
        for name in EXPECTED_ORDER:
            assert f"{name}: rc=0 0 active finding(s)" in proc.stderr, proc.stderr

    def test_merged_artifact_has_one_run_per_tool(self, cli):
        _, out = cli
        doc = json.loads(out.read_text())
        assert doc["version"] == "2.1.0"
        assert [r["tool"]["driver"]["name"] for r in doc["runs"]] == EXPECTED_ORDER
        prefixes = {"distlint": "R", "proglint": "J", "storelint": "S", "numlint": "N"}
        for run in doc["runs"]:
            name = run["tool"]["driver"]["name"]
            rules = {r["id"] for r in run["tool"]["driver"]["rules"]}
            assert rules and all(r.startswith(prefixes[name]) for r in rules), name
            assert not [r for r in run["results"] if r.get("baselineState") == "new"]
        distlint_rules = {r["id"] for r in doc["runs"][0]["tool"]["driver"]["rules"]}
        assert "R012" not in distlint_rules and len(distlint_rules) == 14
        proglint_rules = {r["id"] for r in doc["runs"][1]["tool"]["driver"]["rules"]}
        assert proglint_rules == {"J001", "J002", "J004", "J005"}
        numlint_rules = {r["id"] for r in doc["runs"][3]["tool"]["driver"]["rules"]}
        assert numlint_rules == {f"N{i:03d}" for i in range(1, 8)}

    def test_tool_table_matches_baseline_files(self):
        assert [name for name, _, _ in unified.TOOLS] == EXPECTED_ORDER
        for name, _, baseline in unified.TOOLS:
            doc = _lintcore.load_baseline(os.path.join(REPO, baseline))
            assert doc["tool"] == name and doc["findings"] == []


class TestLintSemantics:
    def test_clean_root_exits_zero(self, tmp_path):
        root = _root(tmp_path, "def f(t, dist):\n    dist.all_reduce(t)\n")
        assert unified.main(["--root", root]) == 0

    @pytest.mark.parametrize(
        "rule", sorted(_SEEDS) + sorted(_J_SEEDS) + sorted(_S_CORPUS) + sorted(_N_SEEDS))
    def test_a_seeded_finding_of_any_rule_fails(self, tmp_path, monkeypatch, rule):
        if rule in _SEEDS:
            source = textwrap.dedent(_SEEDS[rule])
        elif rule in _N_SEEDS:
            source = "def numerics_contract(tier):\n    return lambda f: f\n" + textwrap.dedent(
                _N_SEEDS[rule])
        elif rule in _J_SEEDS:
            eq, meta = _J_SEEDS[rule]
            seeded = [(proglint.ProgramFingerprint(name=f"seeded.{rule}", eqns=(eq,), world=2),
                       proglint.ProgramMeta(**meta))]
            monkeypatch.setattr(proglint, "build_repo_programs", lambda: list(seeded))
            source = "def f(t, dist):\n    dist.all_reduce(t)\n"
        else:
            with open(os.path.join(REPO, "tests", "fixtures", "storelint", _S_CORPUS[rule]),
                      encoding="utf-8") as fh:
                source = fh.read()
        root = _root(tmp_path, source)
        out = tmp_path / "lint.sarif"
        assert unified.main(["--root", root, "--sarif-out", str(out)]) == 1
        doc = json.loads(out.read_text())
        fired = {r["ruleId"] for run in doc["runs"] for r in run["results"]
                 if not r.get("suppressions")}
        assert rule in fired, fired

    def test_only_runs_a_subset(self, tmp_path):
        root = _root(tmp_path, textwrap.dedent(_SEEDS["R001"]))
        merged, rcs = unified.run_all(root, only=["storelint", "numlint"])
        assert rcs == {"storelint": 0, "numlint": 0}
        assert [r["tool"]["driver"]["name"] for r in merged["runs"]] == ["storelint", "numlint"]
        assert unified.main(["--root", root, "--only", "distlint"]) == 1

    def test_a_crashing_plane_fails_the_exit_code(self, tmp_path):
        root = _root(tmp_path, "x = 1\n")
        cfg = tmp_path / _lintcore.CONFIG_PATH
        cfg.write_text(_CONFIG + '\n[tool.distlint.severity]\nR001 = "loud"\n')
        merged, rcs = unified.run_all(root)
        # proglint (its mesh-axis registry) and numlint (its call graph)
        # read distlint's config too, so they fail with it; storelint runs
        assert rcs == {"distlint": 2, "proglint": 2, "storelint": 0, "numlint": 2}
        assert [r["tool"]["driver"]["name"] for r in merged["runs"]] == EXPECTED_ORDER
        assert unified.main(["--root", root]) == 1
