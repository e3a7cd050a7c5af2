"""The port stands alone, and its tests lint clean.

* In a clean subprocess, every module of the port (and `chip_smoke.py`)
  imports without JAX, flax, optax or the JAX package: an import hook
  refuses them, and `sys.modules` must hold none of them afterwards. The
  port's name starts with the JAX package's, so names are matched exactly
  or up to a dot.
* distlint and numlint, the repo's self-gates over `tests/`, find nothing
  in the port's test files.
"""

import glob
import os
import subprocess
import sys

from pytorch_distributed_example_tpu.tools import distlint
from pytorch_distributed_example_tpu.tools import numlint as nl

from tests._mp_util import REPO

PORT_TESTS = sorted(
    os.path.relpath(p, REPO).replace(os.sep, "/")
    for p in glob.glob(os.path.join(REPO, "tests", "test_torch_*.py"))
)

# An import hook that refuses JAX and the JAX package; a script that
# runs the port under it starts with this.
HOOK = r"""
import importlib, importlib.abc, pkgutil, sys

BANNED = ("jax", "jaxlib", "flax", "optax", "pytorch_distributed_example_tpu")

def banned(name):
    return any(name == b or name.startswith(b + ".") for b in BANNED)

class Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if banned(name):
            raise ImportError(f"the port imported {name}")

for name in [m for m in sys.modules if banned(m)]:
    del sys.modules[name]
sys.meta_path.insert(0, Refuse())
"""

_CHECK = HOOK + r"""
import pytorch_distributed_example_tpu_torch as port
names = [m.name for m in pkgutil.walk_packages(port.__path__, port.__name__ + ".")]
for name in names + ["chip_smoke"]:
    importlib.import_module(name)
leaked = sorted(m for m in sys.modules if banned(m))
assert not leaked, leaked
print(" ".join(names))
print("clean", len(names))
"""


def test_port_imports_nothing_of_jax():
    out = subprocess.run(
        [sys.executable, "-c", _CHECK], capture_output=True, text=True,
        timeout=120, cwd=REPO,
    )
    assert out.returncode == 0, out.stderr
    *_, modules, last = out.stdout.splitlines()
    word, count = last.split()
    assert word == "clean", out.stdout
    # ops, models, examples, parallel, the c10d core, data, DDP, sharded
    # training, generation, serving on one card and across ranks and
    # pools, the planner's schedules, the ResNet and BERT workloads, the
    # pipeline and the dry run, checkpoints and the training utilities,
    # the p2p plane and the collective planner, the guard planes, and
    # their modules
    assert int(count) >= 104
    for name in ("ops.flash_attention", "parallel", "parallel.context_parallel",
                 "distributed", "store", "backends.stacked", "backends.process",
                 "examples.toy", "data.sampler", "data.loader", "models.convnet",
                 "parallel.ddp", "parallel.zero", "parallel.reducer", "examples.mnist",
                 "bench", "numerics", "nn", "nn.functional", "dtensor", "parallel.sharding",
                 "parallel.tensor_parallel", "parallel.expert_parallel", "parallel.fsdp",
                 "utils.memstats", "prng", "ops.quant", "models.generate", "serve",
                 "serve.bucketing", "serve.queue", "serve.metrics", "serve.prefix",
                 "serve.cache", "serve.decode", "serve.engine", "examples.generate",
                 "plan", "plan.topology", "plan.schedules", "plan.transfer", "serve.router",
                 "serve.autoscale", "serve.elastic", "serve.disagg", "serve.disagg.migrate",
                 "serve.disagg.router", "optim", "utils.remat", "models.resnet", "models.bert",
                 "examples.cifar", "parallel.comm_hooks", "parallel.pipeline", "dryrun",
                 "checkpoint", "checkpoint_sharded", "amp", "nn.utils", "parallel.join",
                 "parallel.localsgd", "utils.cpu_reference", "p2p", "plan.probe",
                 "plan.planner", "plan.driver", "plan.executor", "plan.traced",
                 "elastic", "elastic.agent", "elastic.run", "serve.worker", "serve.prewarm",
                 "utils.debug_http", "examples.elastic", "examples.serve_worker",
                 "tools", "tools._lintcore", "tools.distlint", "tools.storelint", "tools.lint",
                 "tools.numlint", "tools.proglint"):
        assert f"pytorch_distributed_example_tpu_torch.{name}" in modules.split(), name


def test_port_tests_are_distlint_clean():
    assert PORT_TESTS
    findings = distlint.lint_paths(PORT_TESTS, root=REPO)
    active = [f for f in findings if not f.suppressed]
    assert not active, distlint.render_report(active)


def test_port_tests_are_numlint_clean():
    # the JAX package carries the contracts the tests reach; the rest of
    # tests/ has no bearing on the port's files and halves the scan
    cfg = nl.load_config(REPO)
    cfg.paths = ["pytorch_distributed_example_tpu", *PORT_TESTS]
    findings, _ = nl.lint(REPO, cfg)
    active = [
        f for f in findings
        if f.path in PORT_TESTS and not f.suppressed and f.severity == "error"
    ]
    assert not active, "\n".join(
        f"{f.path}:{f.line} {f.rule} {f.message}" for f in active
    )
