"""The port's numlint (`pytorch_distributed_example_tpu_torch/tools/numlint.py`).

* Against the reference, on the same inputs: over the reference's rule
  corpus `tests/fixtures/numlint/` (parsed, never imported), N003, N004,
  N006 and N007 give the reference's (rule, path, line, col, fingerprint)
  sets. N006's roots there are `jax.jit` bodies, which the port's trace
  model does not know: the port marks them as configured trace roots.
  Its set-iteration finding has no backticked token of its own, so its
  fingerprint takes the wrapper's name (`jax.jit` in the reference, the
  configured root here) and is compared on (rule, path, line, col) only.
* The port's own rule shapes, in torch idiom, under
  `tests/fixtures/numlint_torch/`: one module a positive site (`*_fire`)
  and one the corrected numerics (`*_clean`) for N001, N002, N005 (key
  reuse and a re-seeded generator) and N006.
* The self-gate: the port's tree is clean at the zero-entry baseline,
  and the CLI's SARIF carries numlint/v1 fingerprints.
* The contracts: the port's eight `@numerics_contract` declarations
  carry the reference's tiers and envelopes, and a training run through
  the block-quantized hook holds the quantized all-reduce's declared
  envelope (rtol 5e-2, atol 5e-3) against the exact mean, checked at
  exactly that envelope, as the reference verifies it.
* The sweep: `--sweep --quick --seed-revert pr10` exits 0 with every
  subject clean and the revert caught and localized; the revert changes
  the ZeRO update's float32 bits at every world the gate counts it
  caught at, and at no power-of-two world.
"""

import json
import os
import shutil
import subprocess
import sys
import textwrap

import pytest

from pytorch_distributed_example_tpu.tools import numlint as ref
from pytorch_distributed_example_tpu_torch import numerics
from pytorch_distributed_example_tpu_torch.tools import _lintcore
from pytorch_distributed_example_tpu_torch.tools import numlint as nl

from tests._mp_util import REPO
from tests.test_torch_imports import HOOK

REF_CORPUS = os.path.join(REPO, "tests", "fixtures", "numlint")
PORT_CORPUS = os.path.join(REPO, "tests", "fixtures", "numlint_torch")
BASELINE = os.path.join(REPO, _lintcore.BASELINE_DIR, "numlint.json")
SHARED = ("N003", "N004", "N006", "N007")
# the reference corpus's jit bodies, as the port's configured trace roots
JIT_ROOTS = ["n006_fire.py::stamped_scale", "n006_clean.py::stamped_scale_ok"]

_MEMO: dict = {}


def _corpus(root):
    if root not in _MEMO:
        _MEMO[root] = nl.lint(root, nl.NumlintConfig(paths=["."], exclude=[]))
    return _MEMO[root]


def _active(findings, rule=None):
    return [f for f in findings if not f.suppressed and (rule is None or f.rule == rule)]


def _cli(args, env=None):
    script = HOOK + textwrap.dedent(f"""
        import runpy
        sys.argv = ["numlint", *{list(args)!r}]
        runpy.run_module("pytorch_distributed_example_tpu_torch.tools.numlint",
                         run_name="__main__")
    """)
    return subprocess.run([sys.executable, "-c", script], capture_output=True, text=True,
                          cwd=REPO, env={**os.environ, **(env or {})}, timeout=600)


class TestAgainstReference:
    @pytest.fixture(scope="class")
    def both(self, tmp_path_factory):
        # the corpus with the port's config beside it: its jit bodies as
        # distlint's configured trace roots
        root = tmp_path_factory.mktemp("numlint_corpus")
        shutil.copytree(REF_CORPUS, root, dirs_exist_ok=True)
        cfg = root / _lintcore.CONFIG_PATH
        cfg.parent.mkdir(parents=True)
        cfg.write_text(f"[tool.distlint]\ntrace_roots = {JIT_ROOTS!r}\n")
        port, _ = nl.lint(str(root), nl.NumlintConfig(paths=["."], exclude=[]))
        theirs, _ = ref.lint(REF_CORPUS, ref.NumlintConfig(paths=["."], exclude=[]))
        return port, theirs

    @pytest.mark.parametrize("rule", SHARED)
    def test_same_sites(self, both, rule):
        port, theirs = both
        sites = sorted((f.rule, f.path, f.line, f.col, f.suppressed)
                       for f in port if f.rule == rule)
        assert sites and sites == sorted((f.rule, f.path, f.line, f.col, f.suppressed)
                                         for f in theirs if f.rule == rule)

    @pytest.mark.parametrize("rule", SHARED)
    def test_same_fingerprints(self, both, rule):
        port, theirs = both

        def ids(findings):
            return {(f.rule, f.path, f.line, f.col, f.fingerprint) for f in findings
                    if f.rule == rule and not f.message.startswith("iteration over a set")}

        assert ids(port) and ids(port) == ids(theirs)

    def test_tolerance_names_are_read(self):
        # torch's forms beside numpy's (N007)
        assert {"assert_close", "allclose", "isclose", "assert_allclose"} <= nl._TOLERANCE_FN_NAMES


class TestPortCorpus:
    """Each torch-idiom rule fires on its positive sites only; cleans stay
    silent."""

    @pytest.mark.parametrize("rule,files", [
        ("N001", ["n001_fire.py"]),
        ("N002", ["n002_fire.py"]),
        ("N005", ["n005_fire.py", "n005_reseed_fire.py"]),
        ("N006", ["n006_fire.py", "n006_fire.py"]),
    ])
    def test_fires_on_the_positive_sites_only(self, rule, files):
        findings, _ = _corpus(PORT_CORPUS)
        assert sorted(f.path for f in _active(findings, rule)) == files

    def test_cleans_stay_silent(self):
        findings, _ = _corpus(PORT_CORPUS)
        assert not [f for f in _active(findings) if not f.path.endswith("_fire.py")]

    def test_n001_names_the_torch_knob(self):
        findings, _ = _corpus(PORT_CORPUS)
        (f,) = _active(findings, "N001")
        assert "allow_bf16_reduced_precision_reduction" in f.message
        assert f.trace == ("n001_fire.train_step",)

    def test_n002_whitelist_silences(self):
        cfg = nl.NumlintConfig(paths=["."], exclude=[],
                               parity_preserving=["n002_fire.py::scatter_grads"])
        findings, _ = nl.lint(PORT_CORPUS, cfg)
        assert not _active(findings, "N002")

    def test_n005_generator_reseed_is_the_torch_reuse(self):
        findings, _ = _corpus(PORT_CORPUS)
        reseed = [f for f in _active(findings, "N005") if f.path == "n005_reseed_fire.py"]
        assert len(reseed) == 1 and "`gen.manual_seed`" in reseed[0].message

    def test_n006_reads_the_torch_trace_roots(self):
        findings, _ = _corpus(PORT_CORPUS)
        assert all("torch.compile" in f.message for f in _active(findings, "N006"))

    def test_suppression_with_reason(self, tmp_path):
        src = open(os.path.join(PORT_CORPUS, "n005_fire.py"), encoding="utf-8").read()
        src = src.replace("    b = prng.uniform(key, (4,))",
                          "    b = prng.uniform(key, (4,))  # numlint: disable=N005 -- test")
        (tmp_path / "m.py").write_text(src)
        findings, _ = nl.lint(str(tmp_path), nl.NumlintConfig(paths=["."], exclude=[]))
        (f,) = [f for f in findings if f.rule == "N005"]
        assert f.suppressed


class TestSelfGate:
    @pytest.fixture(scope="class")
    def tree(self):
        return nl.lint(REPO, nl.load_config(REPO))

    def test_zero_unsuppressed_findings(self, tree):
        findings, _ = tree
        active = [f for f in findings if not f.suppressed and f.severity == "error"]
        assert not active, "\n".join(f.render() for f in active)

    def test_the_port_registers_its_eight_contracts(self, tree):
        _, project = tree
        sites = nl.harvest_contracts(project).values()
        got = sorted((s.fi.path.rsplit("/", 1)[-1], s.fi.name, s.tier) for s in sites)
        assert got == [
            ("checkpoint.py", "load_checkpoint", "bitwise"),
            ("checkpoint.py", "save_checkpoint", "bitwise"),
            ("ddp.py", "make_ddp_train_step", "bitwise"),
            ("engine.py", "ServeEngine.step", "token_exact"),
            ("migrate.py", "migrate_request", "token_exact"),
            ("quant.py", "quantize_blockwise", "tolerance"),
            ("quant.py", "quantize_kv", "tolerance"),
            ("quant.py", "quantized_all_reduce", "tolerance"),
        ]

    def test_baseline_is_committed_and_empty(self):
        doc = _lintcore.load_baseline(BASELINE)
        assert doc["tool"] == "numlint" and doc["findings"] == []
        # history: the first run over the port found the ZeRO path's
        # decompositions, settled in lint.toml's parity_preserving
        assert doc["naive_first_run_count"] >= 1

    def test_sarif_from_the_cli(self):
        proc = _cli(["--format", "sarif", "--baseline", BASELINE])
        assert proc.returncode == 0, proc.stdout + proc.stderr
        doc = json.loads(proc.stdout)
        assert doc["version"] == "2.1.0"
        driver = doc["runs"][0]["tool"]["driver"]
        assert driver["name"] == "numlint"
        assert {r["id"] for r in driver["rules"]} == {f"N{i:03d}" for i in range(1, 8)}
        for r in doc["runs"][0]["results"]:
            assert r["partialFingerprints"]["numlint/v1"]
        assert not [r for r in doc["runs"][0]["results"] if r.get("baselineState") == "new"]

    def test_contract_registry_sees_the_decorators(self):
        from pytorch_distributed_example_tpu_torch.parallel import ddp

        assert numerics.contract_of(ddp.make_ddp_train_step)["tier"] == "bitwise"


_CONTRACTS = [
    ("parallel.ddp", "make_ddp_train_step"),
    ("ops.quant", "quantize_blockwise"),
    ("ops.quant", "quantized_all_reduce"),
    ("ops.quant", "quantize_kv"),
    ("serve.engine", "ServeEngine.step"),
    ("serve.disagg.migrate", "migrate_request"),
    ("checkpoint", "save_checkpoint"),
    ("checkpoint", "load_checkpoint"),
]


class TestContracts:
    @pytest.mark.parametrize("module,name", _CONTRACTS)
    def test_the_references_tier_and_envelope(self, module, name):
        import importlib

        def contract(pkg):
            obj = importlib.import_module(f"{pkg}.{module}")
            for part in name.split("."):
                obj = getattr(obj, part)
            return numerics.contract_of(obj)

        port = contract("pytorch_distributed_example_tpu_torch")
        theirs = contract("pytorch_distributed_example_tpu")
        assert (port["tier"], port["rtol"], port["atol"]) == \
            (theirs["tier"], theirs["rtol"], theirs["atol"])

    def test_quantized_training_holds_the_declared_envelope(self):
        # the reference verifies this contract on a training run (its
        # tests/test_quant.py: 3 steps with the block-quantized hook against
        # the exact mean, params at exactly the declared rtol/atol)
        import numpy as np
        import torch

        from pytorch_distributed_example_tpu_torch import optim
        from pytorch_distributed_example_tpu_torch.ops import quant
        from pytorch_distributed_example_tpu_torch.parallel import comm_hooks
        from pytorch_distributed_example_tpu_torch.parallel.ddp import make_ddp_train_step

        declared = numerics.contract_of(quant.quantized_all_reduce)
        gen = np.random.default_rng(0)
        # the reference's geometry: W 8, a 16-32-4 MLP, SGD 0.05, 3 steps
        W, Din, H, C = 8, 16, 32, 4
        init = {"w1": gen.standard_normal((Din, H)) / Din ** 0.5, "b1": np.zeros(H),
                "w2": gen.standard_normal((H, C)) / H ** 0.5, "b2": np.zeros(C)}
        x = torch.from_numpy(gen.standard_normal((2 * W, Din)).astype(np.float32))
        y = torch.from_numpy(gen.integers(0, C, 2 * W))

        def apply_fn(p, x):
            return torch.relu(x @ p["w1"] + p["b1"]) @ p["w2"] + p["b2"]

        def train(hook):
            step = make_ddp_train_step(apply_fn, torch.nn.functional.cross_entropy,
                                       optim.sgd(0.05), group=nl._group_of(W),
                                       comm_hook=hook)
            p = {k: torch.from_numpy(v.astype(np.float32)) for k, v in init.items()}
            o = step.init_opt_state(p)
            for _ in range(3):
                p, o, loss = step(p, o, x, y)
            return p

        with nl._cpu_world():
            exact = train(None)
            quantized = train(comm_hooks.blockwise_quant_hook(error_feedback=False))
        for k in exact:
            torch.testing.assert_close(quantized[k], exact[k], rtol=declared["rtol"],
                                       atol=declared["atol"])


class TestSweep:
    @pytest.fixture(scope="class")
    def cli(self):
        return _cli(["--sweep", "--seed-revert", "pr10"], env={"TDX_NUMLINT_SWEEP": "quick"})

    def test_exit_zero(self, cli):
        assert cli.returncode == 0, cli.stdout + cli.stderr
        assert "the port imported" not in cli.stderr

    def test_every_subject_swept_clean(self, cli):
        for name in nl.SUBJECTS:
            assert f"subject '{name}'" in cli.stdout, cli.stdout
        assert "10/10 geometries parity-clean" in cli.stdout, cli.stdout

    def test_revert_caught_and_localized_to_the_perturbed_op(self, cli):
        assert "caught and localized at 1/1 eligible geometries" in cli.stdout, cli.stdout
        line = next(l for l in cli.stdout.splitlines() if "DIVERGED (required)" in l)
        # the reassociated division is the first op the two streams differ in
        assert "first divergent op" in line and "subject `aten.div.Tensor" in line, line

    @pytest.mark.parametrize("world,changes", [(2, False), (3, True), (4, False), (6, True)])
    def test_the_revert_changes_bits_where_it_is_counted(self, world, changes):
        with nl._cpu_world():
            assert nl.revert_changes_bits({"world": world}) is changes
        counted = {g["world"] for g in nl._revert_geometries(False)}
        assert (world in counted) is changes

    def test_quick_takes_the_first_two_geometries(self):
        for subj in nl.SUBJECTS.values():
            assert subj.geometries(True) == subj.geometries(False)[:2]
