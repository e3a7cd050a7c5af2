"""distlint — the port's whole-project collective-divergence static analyzer.

The port of the reference's `tools/distlint.py`, pointed at
`pytorch_distributed_example_tpu_torch/`. The failure mode it guards is
*silent schedule divergence*: two ranks issue different collective
sequences (one gated a collective on `rank == 0`, one swallowed an
exception and continued, one forgot to forward `group=`) and the job
hangs — or a rank `vmap`'s fold returns wrong numbers with no error at
all. distlint enforces the static half of the group-scoped schedule
contract; the runtime half is the `TDX_SCHEDULE_CHECK` fingerprint
verifier in `distributed.ProcessGroup._dispatch` (`schedule.py`).

The analyzer is **interprocedural**: it parses every configured file
once, builds a module-and-call graph (imports, aliased imports,
`from`-import re-export chains through `__init__.py`, methods resolved
through `self`/`cls` and base classes), and infers a transitive
**effect summary** per function:

  * may-issue-collective — the function (or anything it may call,
    including closures it defines) reaches a collective entry point (the
    c10d names, which `torch.distributed.*` in `backends/process.py` and
    `nn/functional.py`'s rank collectives share, plus that module's
    `rank_all_reduce` and `ppermute`) or a `ProcessGroup._dispatch`;
  * may-block-on-store — it reaches a blocking store/rendezvous op;
  * may-host-effect — it reaches a host-side primitive (below);
  * takes-group — it accepts a `group` / `process_group` parameter that
    callers are expected to forward.

R001/R002/R004 are then re-evaluated against calls to *effectful
helpers*, not just direct collective calls, and interprocedural findings
carry a caller→callee trace. The effect analysis is a *may* analysis and
deliberately over-approximates: a function that merely defines a
collective-issuing closure (a comm hook, a step factory) is summarized as
effectful — ranks disagreeing on whether to build such an object almost
always disagree on calling it too.

Rules
-----

R001  collective (or call to a may-issue-collective helper) under
      rank-dependent control flow — an `if` / `while` / ternary whose
      test reads a rank-like value (`get_rank()`, `.rank()`, names like
      `rank` / `is_main` / `is_master`, or a variable assigned from one
      of those), including statements *after* a rank-gated early
      `return` / `continue` / `break` in the same block.
R002  collective (or effectful-helper call) inside a `try` body whose
      broad handler (`except:` / `except Exception` / `except
      BaseException`) swallows and continues.
R003  blocking store/rendezvous op (`store.get` / `store.wait` /
      `store.barrier` / `rendezvous(...)` / `monitored_barrier`, or a
      call to a may-block-on-store helper) issued between an async
      collective launch (`async_op=True`) and its `Work.wait()`.
R004  a function that takes a `group` / `process_group` parameter but
      calls a collective — or an effectful helper that itself takes a
      group parameter — without forwarding it. (`--fix` rewrites these.)
R005  broad `except`-and-`pass` in dispatch-path modules.
R006  async collective launch (`async_op=True`, or a raw
      `._dispatch(...)`) whose returned `Work` handle is discarded or
      bound to a name that is never used again in the scope. Launches
      inside a `with coalescing_manager(...)` block are exempt.
R007  store coordination key that is `set`/`add`-ed but never
      `delete_key`-ed anywhere in the project and not incarnation-scoped
      (no generation/round/seq field in the key).
R008  fault-point string (a `faults.fire("...")` literal, the point
      entry of a fault-plan dict, or a point inside an embedded JSON
      plan string) that matches no point in the port's `faults.py`
      `KNOWN_POINTS` registry.
R009  stale suppression: a `# distlint: disable=...` comment whose rules
      match no finding anchored to that line (or file).
R010  collective inside a loop whose trip count depends on rank-local
      data.
R011  host-side effect reachable from a trace root. The port's trace is
      what `traceguard.under_tracing` detects: a function passed to (or
      decorated with) `torch.compile`, the first function argument of
      `torch.func.{vmap, grad, grad_and_value, vjp, jvp, jacrev, jacfwd,
      functional_call}` or `torch.vmap`, the function
      `torch.utils.checkpoint.checkpoint` recomputes, the functions a
      lambda handed to one of those calls, and the seams configured
      under ``[tool.distlint] trace_roots``. The host primitives:
      `.item()`, `.tolist()`, `.numpy()`, `.cpu()`,
      `torch.cuda.synchronize`, `faults.fire`, the blocking store ops
      and `rendezvous` / `monitored_barrier`. Under a transform such an
      op raises on a batched tensor, or runs once at trace time instead
      of once a rank or a step.
R013  paged-pool refcount pairing: a locally-acquired pool handle
      (`allocate` / `ensure_blocks` / `attach_prefix` / `cow_block` on a
      pool/cache-like receiver) that reaches a `return` — or falls off
      the end of the function — without a `free()` / ownership hand-off.
R014  unlocked shared-state mutation in a class declaring a `_lock`
      discipline.
R015  sharding-spec drift: an axis name in the port's spec form (the
      spec tuples a rule table maps a parameter pattern to, the spec
      `dtensor.spec_to_placements` takes, and the axis arguments of the
      spec builders `fsdp_rules`, `data_spec` and the models'
      `*sharding_rules`) that no mesh constructed project-wide declares
      (axis-name literals are harvested from every `*Mesh*` /
      `init_device_mesh` call; ``[tool.distlint] known_mesh_axes``
      extends the registry).

Not owed: R012 (use-after-donate). The port accepts `donate=` and
ignores it — a call never frees or aliases its arguments — so no read
can follow a donation. Asking for it by name (a severity entry,
``--explain R012``) fails with that reason (`NOT_OWED`).

Suppressions
------------

A finding is suppressed by a comment on the flagged line or on its
governing construct's first line (the `if`, `try`, `except` or `def`)::

    if rank == 0:  # distlint: disable=R001 -- post-join probe, all ranks converge below
        dist.barrier(group)

``# distlint: disable=R001,R004 -- why`` suppresses several rules at
once; ``# distlint: disable-file=R003 -- why`` anywhere in a file
suppresses the rule file-wide. Always append a reason after ``--``. Only
real comment tokens count.

Baseline & ratchet
------------------

``--baseline FILE`` splits findings into *new* (fail the run) and
*baselined* (grandfathered). Entries are content-fingerprinted (path +
rule + normalized source line), with the reference's fingerprint, so a
finding has the same identity in both packages. ``--update-baseline``
refuses to grow the baseline. The committed ratchet is
`pytorch_distributed_example_tpu_torch/tools/baselines/distlint.json`,
held at zero entries.

Configuration
-------------

``[tool.distlint]`` in `pytorch_distributed_example_tpu_torch/tools/lint.toml`
under the lint root (the root `pyproject.toml` tables serve the JAX
package and are not read)::

    [tool.distlint]
    paths = ["pytorch_distributed_example_tpu_torch", "chip_smoke.py",
             "tests/test_torch_*.py"]                # globs accepted
    exclude = ["csrc/"]
    dispatch_path_modules = ["pytorch_distributed_example_tpu_torch/store.py", "..."]
    fault_registry = "pytorch_distributed_example_tpu_torch/faults.py"
    trace_roots = ["pytorch_distributed_example_tpu_torch/plan/traced.py::all_reduce"]
    known_mesh_axes = []

    [tool.distlint.severity]   # per-rule overrides: error | warning | off
    R010 = "warning"

CLI
---

    python -m pytorch_distributed_example_tpu_torch.tools.distlint [paths...]
        [--format human|json|sarif] [--baseline FILE]
        [--update-baseline] [--fix | --fix-diff] [--show-suppressed]
        [--show-baselined] [--root DIR] [--no-config] [--explain RULE]

Exit status: 0 clean, 1 new unsuppressed error findings (a syntax error
in a LINTED file is such a finding, E000), 2 bad invocation/config.
"""

from __future__ import annotations

import argparse
import ast
import fnmatch
import glob
import hashlib
import io
import json
import os
import re
import sys
import tokenize
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Set, Tuple

from ._lintcore import (  # noqa: F401  (re-exported; see module docstring)
    CONFIG_PATH,
    SEVERITIES,
    Finding,
    apply_baseline,
    baseline_entries,
    load_baseline,
    load_config_section,
    parse_severity_table,
    parse_suppressions,
    render_report,
    write_baseline,
)
from ._lintcore import render_sarif as _render_sarif_core

__all__ = [
    "Finding",
    "LintConfig",
    "NOT_OWED",
    "NotOwedRuleError",
    "Project",
    "explain_rule",
    "harvested_mesh_axes",
    "lint_source",
    "lint_file",
    "lint_paths",
    "load_config",
    "load_baseline",
    "apply_baseline",
    "baseline_entries",
    "render_sarif",
    "apply_fixes",
    "main",
]

RULES = {
    "R001": "collective (possibly via helpers) under rank-dependent control flow",
    "R002": "collective (possibly via helpers) inside a try whose broad handler swallows and continues",
    "R003": "blocking store/rendezvous op between a collective launch and its wait()",
    "R004": "collective does not forward the enclosing function's group parameter",
    "R005": "broad except swallows silently in a dispatch-path module",
    "R006": "async collective launch whose Work handle is never waited or captured",
    "R007": "store coordination key set/add-ed but never deleted nor incarnation-scoped",
    "R008": "fault-point name not present in the faults registry",
    "R009": "stale suppression matches no finding",
    "R010": "collective inside a loop whose trip count depends on rank-local data",
    "R011": "host-side effect reachable from a torch.compile/torch.func trace root",
    "R013": "pool acquisition leaks on a non-raising path (no free()/hand-off)",
    "R014": "guarded field written outside the class's `_lock` discipline",
    "R015": "sharding-spec axis name not declared by any mesh project-wide",
}

# Rules of the reference that the port does not owe, with the reason a
# request for one by name fails with.
NOT_OWED = {
    "R012": (
        "R012 (use-after-donate) is not owed by the port: it accepts "
        "`donate=` and ignores it, so a call never frees or aliases its "
        "arguments and no read can follow a donation"
    ),
}


class NotOwedRuleError(ValueError):
    """A rule of the reference that the port does not owe was asked for
    by name."""


def explain_rule(rule: str) -> str:
    """``RULE: description``; a not-owed rule raises `NotOwedRuleError`
    with its reason, an unknown one `KeyError`."""
    rule = rule.strip().upper()
    if rule in NOT_OWED:
        raise NotOwedRuleError(NOT_OWED[rule])
    return f"{rule}: {RULES[rule]}"

# SEVERITIES / Finding / baseline ratchet / renderers live in
# tools/_lintcore.py (shared with storelint) and are re-exported here
# unchanged.

# Collective entry points (the schedule-divergence surface). p2p ops
# (send/recv/isend/irecv) are deliberately absent: they are rank-directed
# by contract, so rank-gating them is the normal idiom, not a smell.
COLLECTIVES: Set[str] = {
    "all_reduce",
    "broadcast",
    "reduce",
    "all_gather",
    "gather",
    "scatter",
    "reduce_scatter",
    "all_to_all",
    "barrier",
    "monitored_barrier",
    "all_gather_into_tensor",
    "all_to_all_single",
    "reduce_scatter_tensor",
    "all_gather_object",
    "broadcast_object_list",
    "scatter_object_list",
    "gather_object",
    "all_reduce_coalesced",
    "all_gather_coalesced",
    "batch_isend_irecv",
    # nn/functional.py's rank collectives beyond the c10d names: the
    # rank vmap's fold and the rank permutation
    "rank_all_reduce",
    "ppermute",
}

# Point-to-point entry points. Rank-gating them is the normal idiom (the
# sender branch and the receiver branch), so a rank-gated or rank-local
# loop call to one is no R001/R010 finding even though a driver-mode
# send dispatches half of a permute pair.
_P2P_OPS = {"send", "recv", "isend", "irecv", "send_object_list", "recv_object_list"}

# The raw dispatch primitive: `group._dispatch(op, payload, fn)` is how
# every collective in this package reaches its backend, so a call to it
# IS a collective issue for effect purposes.
_DISPATCH_ATTR = "_dispatch"

# Positional index of `group` in this package's collective signatures —
# the --fix autofixer must not append `group=` when that slot is already
# filled positionally (duplicate-argument TypeError). Names absent here
# are only fixed on single-positional-arg calls (group is never arg 0).
_COLLECTIVE_GROUP_POS = {
    "all_reduce": 2,
    "broadcast": 2,
    "reduce": 3,
    "all_gather": 1,
    "gather": 2,
    "scatter": 2,
    "reduce_scatter": 2,
    "all_to_all": 1,
    "barrier": 0,
    "monitored_barrier": 0,
    "all_gather_into_tensor": 1,
    "reduce_scatter_tensor": 2,
    "all_to_all_single": 3,
}

# Names that read as "which rank am I" in a condition.
_RANK_NAME_RE = re.compile(
    r"(^|_)(rank|ranks?_?id)($|_)|^(is_main|is_master|main_process|is_leader)$",
    re.IGNORECASE,
)
# Calls whose RESULT is a rank: get_rank(), g.rank(), process_index()
_RANK_CALL_ATTRS = {"rank", "get_rank", "process_index", "get_node_local_rank"}
# Attributes that hold a rank: _world.process_rank, self.my_rank ...
_RANK_ATTR_RE = re.compile(r"rank", re.IGNORECASE)

# Names that read as "data only this rank holds" (R010 trip counts).
_LOCAL_DATA_RE = re.compile(r"(^|_)(local|locals|mine|my|shard|shards)(_|$)", re.IGNORECASE)

# Fields in a store-key f-string that scope the key to one incarnation.
# Word-boundary anchored (like _RANK_NAME_RE): `gen`/`restart_gen`/`gen0`
# count, but `agent_id` (substring 'gen') and `urgent` must NOT.
_SCOPE_FIELD_RE = re.compile(
    r"(^|_)(gen|generation|scope|rnd|round|seq|epoch|restart|incarnation|attempt)(_|$|\d)",
    re.IGNORECASE,
)

# Blocking store ops for R003 (`check` is a non-blocking probe; `set`
# and `add` complete locally against a live daemon).
_STORE_BLOCKING_ATTRS = {"get", "wait", "barrier"}

# -- trace-context model (R011) ---------------------------------------------
# Callables whose function argument becomes a TRACED body: what
# `traceguard.under_tracing` detects (`torch.compile` tracing, a
# `torch.func` transform), plus the recomputed function of an activation
# checkpoint. Matched on the import-resolved dotted name, so
# `from torch.func import vmap` and `torch.func.vmap` both count while an
# unrelated `checkpoint` module or `re.compile` do not.
_TRACE_WRAPS = {
    "torch.compile",
    "torch.vmap",
    "torch.func.vmap",
    "torch.func.grad",
    "torch.func.grad_and_value",
    "torch.func.vjp",
    "torch.func.jvp",
    "torch.func.jacrev",
    "torch.func.jacfwd",
    "torch.func.functional_call",
    "torch.utils.checkpoint.checkpoint",
}
# The port's own remat wrapper (`utils/remat.py`) reruns its function
# under `torch.func.vjp`: matched by module suffix.
_TRACE_WRAP_SUFFIXES = (".utils.remat.checkpoint_wrapper",)
# Zero-argument tensor methods that read device data back to the host.
_HOST_READBACK_ATTRS = {"item", "tolist", "numpy", "cpu"}

# -- paged-pool lifecycle (R013) --------------------------------------------
_POOL_ACQUIRE_ATTRS = {"allocate", "ensure_blocks", "attach_prefix", "cow_block"}
# A class matching this implements the pool itself: its methods own the
# refcount plumbing and are out of scope for the consumer-pairing rule.
_POOL_IMPL_CLASS_RE = re.compile(r"pool|cache|block", re.IGNORECASE)

# -- lock discipline (R014): `self._lock` plus the condition-variable
# wrappers that hold it ------------------------------------------------------
_LOCK_ATTRS = {"_lock", "_cv", "_cond", "_condition"}

# Functions that run under a transform through a hand-off the analyzer
# cannot see: the planner's trace-time dispatchers, which a model's
# forward reaches inside the DDP step's rank vmap through
# `functional_call(module, ...)`, and which lower `plan/driver.py`'s
# schedule bodies there. `path-glob::name-glob` matched against (module
# path, qualified name).
DEFAULT_TRACE_ROOTS = [
    "pytorch_distributed_example_tpu_torch/plan/traced.py::all_reduce",
    "pytorch_distributed_example_tpu_torch/plan/traced.py::all_gather",
    "pytorch_distributed_example_tpu_torch/plan/traced.py::reduce_scatter",
    "pytorch_distributed_example_tpu_torch/plan/traced.py::all_gather_matmul",
]

# Modules whose broad-except hygiene R005 polices. Matched as path
# suffixes against the posix-style relative path. The backends that
# issue the collectives (`stacked.py` in driver mode, `process.py` over
# torch.distributed) stand where the reference's `xla.py` stood.
DEFAULT_DISPATCH_PATH_MODULES = [
    "pytorch_distributed_example_tpu_torch/distributed.py",
    "pytorch_distributed_example_tpu_torch/store.py",
    "pytorch_distributed_example_tpu_torch/p2p.py",
    "pytorch_distributed_example_tpu_torch/rendezvous.py",
    "pytorch_distributed_example_tpu_torch/schedule.py",
    "pytorch_distributed_example_tpu_torch/utils/watchdog.py",
    "pytorch_distributed_example_tpu_torch/backends/wrapper.py",
    "pytorch_distributed_example_tpu_torch/backends/stacked.py",
    "pytorch_distributed_example_tpu_torch/backends/process.py",
    "pytorch_distributed_example_tpu_torch/parallel/reducer.py",
    "pytorch_distributed_example_tpu_torch/parallel/ddp.py",
]

# The port package (its examples included), the card smoke script and the
# port's tests. Entries may be globs.
DEFAULT_PATHS = [
    "pytorch_distributed_example_tpu_torch",
    "chip_smoke.py",
    "tests/test_torch_*.py",
]
DEFAULT_EXCLUDE = ["csrc/"]
DEFAULT_FAULT_REGISTRY = "pytorch_distributed_example_tpu_torch/faults.py"
# R007 polices key lifecycle on LONG-LIVED stores — the runtime package and
# its example entrypoints. Tests and the smoke script churn throwaway
# stores where key GC is irrelevant, so they are out of scope by default.
DEFAULT_STORE_LIFECYCLE_PATHS = ["pytorch_distributed_example_tpu_torch"]

_POINT_IN_STRING_RE = re.compile(r'"point"\s*:\s*"([^"]*)"')


@dataclass
class LintConfig:
    paths: List[str] = field(default_factory=lambda: list(DEFAULT_PATHS))
    exclude: List[str] = field(default_factory=lambda: list(DEFAULT_EXCLUDE))
    dispatch_path_modules: List[str] = field(
        default_factory=lambda: list(DEFAULT_DISPATCH_PATH_MODULES)
    )
    severity: Dict[str, str] = field(default_factory=dict)
    fault_registry: str = DEFAULT_FAULT_REGISTRY
    store_lifecycle_paths: List[str] = field(
        default_factory=lambda: list(DEFAULT_STORE_LIFECYCLE_PATHS)
    )
    trace_roots: List[str] = field(
        default_factory=lambda: list(DEFAULT_TRACE_ROOTS)
    )
    known_mesh_axes: List[str] = field(default_factory=list)

    def rule_severity(self, rule: str) -> str:
        return self.severity.get(rule, "error")


def load_config(root: str) -> LintConfig:
    """Read ``[tool.distlint]`` from ``<root>/CONFIG_PATH`` (missing
    file/section → defaults). A severity entry for a not-owed rule
    raises `NotOwedRuleError` with its reason."""
    cfg = LintConfig()
    section = load_config_section(root, "distlint")
    if "paths" in section:
        cfg.paths = [str(p) for p in section["paths"]]
    if "exclude" in section:
        cfg.exclude = [str(p) for p in section["exclude"]]
    if "dispatch_path_modules" in section:
        cfg.dispatch_path_modules = [str(p) for p in section["dispatch_path_modules"]]
    if "fault_registry" in section:
        cfg.fault_registry = str(section["fault_registry"])
    if "store_lifecycle_paths" in section:
        cfg.store_lifecycle_paths = [str(p) for p in section["store_lifecycle_paths"]]
    if "trace_roots" in section:
        cfg.trace_roots = [str(p) for p in section["trace_roots"]]
    if "known_mesh_axes" in section:
        cfg.known_mesh_axes = [str(p) for p in section["known_mesh_axes"]]
    cfg.severity = parse_severity_table(section, "distlint")
    for rule in cfg.severity:
        if rule in NOT_OWED:
            raise NotOwedRuleError(
                f"[tool.distlint.severity] names {rule}: {NOT_OWED[rule]}"
            )
    return cfg


# ---------------------------------------------------------------------------
# source-level helpers
# ---------------------------------------------------------------------------


def _parse_suppressions(
    src: str,
) -> Tuple[Dict[int, Set[str]], Dict[str, int]]:
    """(line -> suppressed rules, file-wide rule -> declaring line);
    comment tokens only — see `_lintcore.parse_suppressions`."""
    return parse_suppressions(src, "distlint")


def _call_name(call: ast.Call) -> Optional[str]:
    """Trailing identifier of the called thing: `all_reduce`, `dist.all_reduce`,
    `tdx.distributed.all_reduce` all resolve to "all_reduce"."""
    f = call.func
    if isinstance(f, ast.Name):
        return f.id
    if isinstance(f, ast.Attribute):
        return f.attr
    return None


def _is_collective_call(node: ast.AST) -> bool:
    """Direct collective issue: a collective entry-point name, or the raw
    dispatch primitive itself (`g._dispatch(...)`) — rank-gating the
    dispatcher is the same desync as rank-gating `all_reduce`."""
    if not isinstance(node, ast.Call):
        return False
    if _call_name(node) in COLLECTIVES:
        return True
    return (
        isinstance(node.func, ast.Attribute) and node.func.attr == _DISPATCH_ATTR
    )


def _dotted_chain(expr: ast.expr) -> Optional[List[str]]:
    """`a.b.c` -> ["a", "b", "c"]; None when not a pure dotted name."""
    parts: List[str] = []
    while isinstance(expr, ast.Attribute):
        parts.append(expr.attr)
        expr = expr.value
    if isinstance(expr, ast.Name):
        parts.append(expr.id)
        return list(reversed(parts))
    return None


def _expr_all_idents(node: ast.AST) -> Set[str]:
    """Bare names AND attribute components of an expression."""
    out: Set[str] = set()
    for sub in ast.walk(node):
        if isinstance(sub, ast.Name):
            out.add(sub.id)
        elif isinstance(sub, ast.Attribute):
            out.add(sub.attr)
    return out


def _is_rank_expr(node: ast.AST, tainted: Set[str]) -> bool:
    """Does this expression read a rank-like value?"""
    for sub in ast.walk(node):
        if isinstance(sub, ast.Name):
            if sub.id in tainted or _RANK_NAME_RE.search(sub.id):
                return True
        elif isinstance(sub, ast.Attribute):
            if _RANK_ATTR_RE.search(sub.attr):
                return True
        elif isinstance(sub, ast.Call):
            name = _call_name(sub)
            if name in _RANK_CALL_ATTRS:
                return True
    return False


def _is_local_data_expr(node: ast.AST) -> bool:
    """Does this expression read rank-local data (R010 trip counts)?"""
    return any(_LOCAL_DATA_RE.search(n) for n in _expr_all_idents(node))


def _rank_taint_targets(stmt: ast.stmt, tainted: Set[str]) -> Set[str]:
    """Names newly rank-tainted by an assignment like ``me = g.rank()``."""
    if not isinstance(stmt, (ast.Assign, ast.AnnAssign, ast.AugAssign)):
        return set()
    value = stmt.value
    if value is None or not _is_rank_expr(value, tainted):
        return set()
    targets: List[ast.expr] = []
    if isinstance(stmt, ast.Assign):
        targets = stmt.targets
    else:
        targets = [stmt.target]
    out: Set[str] = set()
    for t in targets:
        if isinstance(t, ast.Name):
            out.add(t.id)
    return out


def _handler_is_broad(handler: ast.ExceptHandler) -> bool:
    def broad_name(e: ast.expr) -> bool:
        return isinstance(e, ast.Name) and e.id in ("Exception", "BaseException")

    t = handler.type
    if t is None:
        return True
    if broad_name(t):
        return True
    if isinstance(t, ast.Tuple):
        return any(broad_name(e) for e in t.elts)
    return False


def _handler_swallows(handler: ast.ExceptHandler) -> bool:
    """True when the handler neither re-raises nor exits the process."""
    for sub in ast.walk(handler):
        if isinstance(sub, ast.Raise):
            return False
        if isinstance(sub, ast.Call):
            name = _call_name(sub)
            if name in ("_exit", "exit", "abort"):
                return False
    return True


def _handler_is_silent(handler: ast.ExceptHandler) -> bool:
    """R005 shape: the handler body does nothing observable (only `pass` /
    `...` / a bare `return`) — the failure leaves no trace at all."""
    for stmt in handler.body:
        if isinstance(stmt, ast.Pass):
            continue
        if isinstance(stmt, ast.Expr) and isinstance(stmt.value, ast.Constant):
            continue  # docstring/ellipsis
        if isinstance(stmt, ast.Return) and (
            stmt.value is None
            or (isinstance(stmt.value, ast.Constant) and stmt.value.value is None)
        ):
            continue
        return False
    return True


def _walk_skip_nested_funcs(stmt: ast.stmt):
    """ast.walk that does not descend into nested function/lambda bodies
    (deferred execution: each function body is scanned as its own scope
    by run_module; lambda bodies run whenever the lambda is called)."""
    stack: List[ast.AST] = [stmt]
    while stack:
        node = stack.pop()
        yield node
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
            continue  # its body is its own (deferred) scope
        stack.extend(ast.iter_child_nodes(node))


def _receiver_mentions_store(expr: ast.expr) -> bool:
    for sub in ast.walk(expr):
        if isinstance(sub, ast.Name) and "store" in sub.id.lower():
            return True
        if isinstance(sub, ast.Attribute) and "store" in sub.attr.lower():
            return True
    return False


def _render_callee(call: ast.Call) -> str:
    f = call.func
    parts: List[str] = []
    while isinstance(f, ast.Attribute):
        parts.append(f.attr)
        f = f.value
    if isinstance(f, ast.Name):
        parts.append(f.id)
    return ".".join(reversed(parts))


def _host_prim_label(call: ast.Call) -> Optional[str]:
    """Display label when ``call`` is a DIRECT host-side primitive (the
    R011 surface), else None. Blocking store ops reuse the R003
    receiver heuristic; the readbacks (`.item()`, `.tolist()`,
    `.numpy()`, `.cpu()`) only in their positional-argument-free form."""
    name = _call_name(call)
    if name is None:
        return None
    if name == "fire":
        if isinstance(call.func, ast.Name):
            return "faults.fire"
        if isinstance(call.func, ast.Attribute) and any(
            "fault" in n
            for n in map(str.lower, _expr_all_idents(call.func.value))
        ):
            return "faults.fire"
        return None
    if (
        name == "synchronize"
        and isinstance(call.func, ast.Attribute)
        and "cuda" in _expr_all_idents(call.func.value)
    ):
        return "torch.cuda.synchronize"
    if (
        name in _HOST_READBACK_ATTRS
        and isinstance(call.func, ast.Attribute)
        and not call.args
    ):
        return f".{name}()"
    if name in ("rendezvous", "monitored_barrier"):
        return name
    if (
        name in _STORE_BLOCKING_ATTRS
        and isinstance(call.func, ast.Attribute)
        and _receiver_mentions_store(call.func.value)
    ):
        return f"store.{name}"
    return None


def _qualified_name(minfo: "ModuleInfo", expr: ast.expr) -> Optional[str]:
    """Import-resolved dotted name of ``expr`` as seen from ``minfo``:
    `vmap` after `from torch.func import vmap` is "torch.func.vmap",
    `tdist.all_reduce` after `import torch.distributed as tdist` is
    "torch.distributed.all_reduce". None when not a dotted name."""
    chain = _dotted_chain(expr)
    if not chain:
        return None
    head = chain[0]
    if head in minfo.from_imports:
        mod, orig = minfo.from_imports[head]
        base = f"{mod}.{orig}" if mod else orig
    else:
        base = minfo.import_aliases.get(head, head)
    return ".".join([base] + chain[1:])


def _callable_names(expr: ast.expr) -> Set[str]:
    """Names an expression may evaluate to as a callable: itself, either
    arm of a conditional, a wrapper's arguments (`partial(checkpoint,
    fn)`, `wrap(fn)`). A callee is not among them: `model = build(cfg)`
    binds what `build` returns, not `build`."""
    if isinstance(expr, ast.Name):
        return {expr.id}
    if isinstance(expr, ast.IfExp):
        return _callable_names(expr.body) | _callable_names(expr.orelse)
    if isinstance(expr, ast.BoolOp):
        return set().union(*(_callable_names(v) for v in expr.values))
    if isinstance(expr, ast.Call):
        return set().union(*(_callable_names(a) for a in expr.args))
    return set()


def _is_trace_wrap(qualified: Optional[str]) -> bool:
    return qualified is not None and (
        qualified in _TRACE_WRAPS or qualified.endswith(_TRACE_WRAP_SUFFIXES)
    )


# ---------------------------------------------------------------------------
# project model: modules, functions, imports, call graph, effect inference
# ---------------------------------------------------------------------------


@dataclass
class Effect:
    """A transitive effect summary hop chain ending at a primitive."""

    kind: str  # "collective" | "store"
    prim_name: str
    prim_path: str
    prim_line: int
    chain: Tuple[str, ...]  # display names from the summarized fn to the prim holder

    def describe(self) -> str:
        via = f"{self.prim_path}:{self.prim_line}"
        chain = " -> ".join(self.chain)
        return f"`{self.prim_name}` via {via} (call chain {chain})"


@dataclass
class TraceCtx:
    """How a function becomes reachable from a traced program body."""

    reason: str  # why the ROOT is a trace root
    root_display: str
    root_path: str
    root_line: int
    chain: Tuple[str, ...]  # display names from the root down to this fn

    def describe(self) -> str:
        if len(self.chain) <= 1:
            return f"a trace root ({self.reason})"
        return (
            f"reachable from trace root `{self.root_display}` "
            f"({self.reason}, {self.root_path}:{self.root_line}; "
            f"chain {' -> '.join(self.chain)})"
        )


@dataclass
class FunctionInfo:
    module: str
    name: str  # "func", "Class.meth", or "outer.<locals>.inner"
    path: str
    node: ast.AST
    cls: Optional[str] = None
    group_param: Optional[str] = None
    coll_effect: Optional[Effect] = None
    store_effect: Optional[Effect] = None
    host_effect: Optional[Effect] = None
    trace_root: Optional[str] = None  # reason string when a trace root
    trace_ctx: Optional[TraceCtx] = None
    edges: List[Tuple[int, "FunctionInfo"]] = field(default_factory=list)

    @property
    def display(self) -> str:
        mod_tail = self.module.rsplit(".", 1)[-1]
        return f"{mod_tail}.{self.name}"

    @property
    def qualname(self) -> str:
        return f"{self.module}:{self.name}"


@dataclass
class ClassInfo:
    name: str
    module: str
    bases: List[str] = field(default_factory=list)  # textual dotted names
    methods: Dict[str, FunctionInfo] = field(default_factory=dict)


@dataclass
class ModuleInfo:
    name: str  # dotted
    path: str  # relative posix path
    is_pkg: bool
    tree: ast.Module
    src: str
    import_aliases: Dict[str, str] = field(default_factory=dict)
    from_imports: Dict[str, Tuple[str, str]] = field(default_factory=dict)
    functions: Dict[str, FunctionInfo] = field(default_factory=dict)
    classes: Dict[str, ClassInfo] = field(default_factory=dict)
    consts: Dict[str, str] = field(default_factory=dict)  # top-level str constants


def _module_name_for(rel_path: str) -> Tuple[str, bool]:
    p = rel_path.replace(os.sep, "/")
    if p.endswith(".py"):
        p = p[: -len(".py")]
    is_pkg = p.endswith("/__init__")
    if is_pkg:
        p = p[: -len("/__init__")]
    return p.replace("/", "."), is_pkg


def _group_param_of(node) -> Optional[str]:
    args = node.args
    names = [a.arg for a in (args.posonlyargs + args.args + args.kwonlyargs)]
    for cand in ("group", "process_group"):
        if cand in names:
            return cand
    return None


def _group_param_index(node, name: str, cls: Optional[str]) -> int:
    """Positional index of param ``name`` at the BOUND call site (methods
    drop self/cls); a kw-only param cannot be filled positionally and
    reports an unreachably large index."""
    args = node.args
    pos = [a.arg for a in (args.posonlyargs + args.args)]
    if cls is not None and pos and pos[0] in ("self", "cls"):
        pos = pos[1:]
    if name in pos:
        return pos.index(name)
    return 10**6  # kw-only: never positionally filled


class Project:
    """Whole-project symbol table + call graph + effect summaries.

    Built once per lint run over every configured file; the per-file
    analyzers consult it to treat calls to effectful helpers as
    collective/store operations (with caller→callee traces)."""

    _MAX_CHAIN = 8
    _MAX_RESOLVE_DEPTH = 12

    def __init__(self) -> None:
        self.modules: Dict[str, ModuleInfo] = {}
        self.by_path: Dict[str, ModuleInfo] = {}
        self.delete_key_prefixes: Set[str] = set()
        self.fault_points: Optional[Set[str]] = None
        self.mesh_axes: Set[str] = set()

    # -- construction ------------------------------------------------------

    @classmethod
    def build(
        cls,
        sources: Dict[str, str],
        trace_roots: Sequence[str] = (),
    ) -> "Project":
        """``sources``: relative posix path -> source text. Files that do
        not parse are skipped here (lint_source reports E000 for them).
        ``trace_roots``: configured `path-glob::name-glob` seam patterns
        marked as traced bodies on top of the automatic detection."""
        proj = cls()
        for rel, src in sources.items():
            try:
                tree = ast.parse(src, filename=rel)
            except SyntaxError:
                continue
            name, is_pkg = _module_name_for(rel)
            minfo = ModuleInfo(
                name=name, path=rel.replace(os.sep, "/"), is_pkg=is_pkg,
                tree=tree, src=src,
            )
            proj._collect_module(minfo)
            proj.modules[name] = minfo
            proj.by_path[minfo.path] = minfo
        proj._mark_trace_roots(trace_roots)
        proj._compute_effects()
        proj._compute_trace_reach()
        proj._collect_store_deletes()
        proj._collect_mesh_axes()
        proj._extract_fault_registry()
        return proj

    def _collect_module(self, m: ModuleInfo) -> None:
        for stmt in m.tree.body:
            if isinstance(stmt, ast.Assign) and isinstance(stmt.value, ast.Constant):
                if isinstance(stmt.value.value, str):
                    for t in stmt.targets:
                        if isinstance(t, ast.Name):
                            m.consts[t.id] = stmt.value.value

        def base_package(level: int) -> Optional[str]:
            parts = m.name.split(".")
            if not m.is_pkg:
                parts = parts[:-1]
            up = level - 1
            if up > len(parts):
                return None
            return ".".join(parts[: len(parts) - up]) if up else ".".join(parts)

        for node in ast.walk(m.tree):
            if isinstance(node, ast.Import):
                for alias in node.names:
                    if alias.asname:
                        m.import_aliases[alias.asname] = alias.name
                    else:
                        m.import_aliases.setdefault(
                            alias.name.split(".")[0], alias.name.split(".")[0]
                        )
            elif isinstance(node, ast.ImportFrom):
                if node.level:
                    base = base_package(node.level)
                    if base is None:
                        continue
                    target = f"{base}.{node.module}" if node.module else base
                else:
                    target = node.module or ""
                for alias in node.names:
                    if alias.name == "*":
                        continue
                    m.from_imports[alias.asname or alias.name] = (target, alias.name)

        def collect_defs(
            body, cls_name: Optional[str], prefix: str, nested: bool = False
        ) -> None:
            for stmt in body:
                if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    fq = f"{prefix}{stmt.name}"
                    fi = FunctionInfo(
                        module=m.name, name=fq, path=m.path, node=stmt,
                        cls=cls_name, group_param=_group_param_of(stmt),
                    )
                    m.functions[fq] = fi
                    if cls_name is not None:
                        m.classes[cls_name].methods[stmt.name] = fi
                    # nested defs are registered too (trace roots live
                    # there: step factories define their transformed
                    # bodies inline) but never as re-resolvable symbols —
                    # their dotted names miss resolve_symbol's bare-name
                    # check by construction
                    collect_defs(
                        stmt.body, None, f"{fq}.<locals>.", nested=True
                    )
                elif isinstance(stmt, ast.ClassDef) and nested:
                    # a function-local class: methods may still hold trace
                    # roots, but registering the CLASS would shadow any
                    # module-level one of the same name — recurse defs only
                    collect_defs(
                        stmt.body, None, f"{prefix}{stmt.name}.<locals>.",
                        nested=True,
                    )
                elif isinstance(stmt, ast.ClassDef):
                    ci = ClassInfo(name=stmt.name, module=m.name)
                    for b in stmt.bases:
                        chain = _dotted_chain(b)
                        if chain:
                            ci.bases.append(".".join(chain))
                    m.classes[stmt.name] = ci
                    collect_defs(stmt.body, stmt.name, f"{stmt.name}.")
                elif isinstance(stmt, (ast.If, ast.Try)):
                    # defs guarded by TYPE_CHECKING / version checks
                    for attr in ("body", "orelse", "finalbody"):
                        collect_defs(
                            getattr(stmt, attr, []) or [], cls_name, prefix,
                            nested,
                        )
                    for h in getattr(stmt, "handlers", []) or []:
                        collect_defs(h.body, cls_name, prefix, nested)

        collect_defs(m.tree.body, None, "")

    # -- symbol resolution -------------------------------------------------

    def resolve_symbol(self, mod_name: str, sym: str, _depth: int = 0):
        """Resolve ``sym`` as seen from module ``mod_name`` to a
        FunctionInfo / ClassInfo / ModuleInfo, chasing `from`-import
        re-export chains (``backends/__init__.py`` style)."""
        if _depth > self._MAX_RESOLVE_DEPTH:
            return None
        m = self.modules.get(mod_name)
        if m is None:
            return None
        if sym in m.functions and "." not in sym:
            return m.functions[sym]
        if sym in m.classes:
            return m.classes[sym]
        if sym in m.from_imports:
            target_mod, orig = m.from_imports[sym]
            resolved = self.resolve_symbol(target_mod, orig, _depth + 1)
            if resolved is not None:
                return resolved
            # `from a.b import c` where c is itself a module
            return self.modules.get(f"{target_mod}.{orig}")
        if sym in m.import_aliases:
            return self.modules.get(m.import_aliases[sym])
        sub = self.modules.get(f"{mod_name}.{sym}")
        if sub is not None:
            return sub
        return None

    def _resolve_class(self, mod_name: str, dotted: str, _depth: int = 0):
        """Resolve a (possibly dotted) textual class reference."""
        if _depth > self._MAX_RESOLVE_DEPTH:
            return None
        parts = dotted.split(".")
        cur = self.resolve_symbol(mod_name, parts[0])
        for p in parts[1:]:
            if isinstance(cur, ModuleInfo):
                cur = self.resolve_symbol(cur.name, p, _depth + 1)
            else:
                return None
        return cur if isinstance(cur, ClassInfo) else None

    def _method_on(self, ci: ClassInfo, meth: str, _depth: int = 0) -> Optional[FunctionInfo]:
        if _depth > self._MAX_RESOLVE_DEPTH:
            return None
        if meth in ci.methods:
            return ci.methods[meth]
        for base in ci.bases:
            bci = self._resolve_class(ci.module, base, _depth + 1)
            if bci is not None:
                found = self._method_on(bci, meth, _depth + 1)
                if found is not None:
                    return found
        return None

    def resolve_call(
        self, minfo: ModuleInfo, cls_name: Optional[str], call: ast.Call
    ) -> List[FunctionInfo]:
        """Best-effort call-target resolution (empty when unknown)."""
        f = call.func
        if isinstance(f, ast.Name):
            r = self.resolve_symbol(minfo.name, f.id)
            if isinstance(r, FunctionInfo):
                return [r]
            if isinstance(r, ClassInfo):
                init = self._method_on(r, "__init__")
                return [init] if init else []
            return []
        chain = _dotted_chain(f)
        if not chain or len(chain) < 2:
            return []
        if chain[0] in ("self", "cls") and cls_name and len(chain) == 2:
            ci = minfo.classes.get(cls_name)
            if ci is not None:
                meth = self._method_on(ci, chain[1])
                return [meth] if meth else []
            return []
        cur = self.resolve_symbol(minfo.name, chain[0])
        for part in chain[1:-1]:
            if isinstance(cur, ModuleInfo):
                cur = self.resolve_symbol(cur.name, part)
            else:
                cur = None
                break
        attr = chain[-1]
        if isinstance(cur, ModuleInfo):
            r = self.resolve_symbol(cur.name, attr)
            if isinstance(r, FunctionInfo):
                return [r]
            if isinstance(r, ClassInfo):
                init = self._method_on(r, "__init__")
                return [init] if init else []
        elif isinstance(cur, ClassInfo):
            meth = self._method_on(cur, attr)
            return [meth] if meth else []
        return []

    def effectful_targets(
        self, minfo: ModuleInfo, cls_name: Optional[str], call: ast.Call, kind: str
    ) -> List[FunctionInfo]:
        name = _call_name(call)
        if name in COLLECTIVES or name == _DISPATCH_ATTR:
            return []  # the direct rules already handle these
        targets = self.resolve_call(minfo, cls_name, call)
        if kind == "collective":
            return [t for t in targets if t.coll_effect is not None]
        return [t for t in targets if t.store_effect is not None]

    # -- effect inference --------------------------------------------------

    def _direct_effects(
        self, fi: FunctionInfo
    ) -> Tuple[Optional[Effect], Optional[Effect], Optional[Effect]]:
        """Seed effects from the function's own body. The scan includes
        nested defs/lambdas on purpose (may analysis: a function that
        *builds* a collective-issuing closure is summarized as may-issue)."""
        coll = store = host = None
        body = getattr(fi.node, "body", [])
        for stmt in body:
            for node in ast.walk(stmt):
                if not isinstance(node, ast.Call):
                    continue
                name = _call_name(node)
                line = getattr(node, "lineno", 0)
                if coll is None and (
                    name in COLLECTIVES
                    or (name == _DISPATCH_ATTR and isinstance(node.func, ast.Attribute))
                ):
                    coll = Effect("collective", name, fi.path, line, (fi.display,))
                if store is None:
                    if name in ("rendezvous", "monitored_barrier"):
                        store = Effect("store", name, fi.path, line, (fi.display,))
                    elif (
                        name in _STORE_BLOCKING_ATTRS
                        and isinstance(node.func, ast.Attribute)
                        and _receiver_mentions_store(node.func.value)
                    ):
                        store = Effect(
                            "store", f"store.{name}", fi.path, line, (fi.display,)
                        )
                if host is None:
                    label = _host_prim_label(node)
                    if label is not None:
                        host = Effect("host", label, fi.path, line, (fi.display,))
        # Store subclasses' own get/wait/barrier are the primitives
        if (
            store is None
            and fi.cls is not None
            and fi.cls.endswith("Store")
            and fi.name.rsplit(".", 1)[-1] in _STORE_BLOCKING_ATTRS
        ):
            store = Effect(
                "store",
                f"store.{fi.name.rsplit('.', 1)[-1]}",
                fi.path,
                getattr(fi.node, "lineno", 0),
                (fi.display,),
            )
        # a blocking store op is a host effect too (the R011 surface is a
        # superset of the R003 one)
        if host is None and store is not None:
            host = Effect(
                "host", store.prim_name, store.prim_path, store.prim_line,
                store.chain,
            )
        return coll, store, host

    def _compute_effects(self) -> None:
        funcs: List[FunctionInfo] = [
            fi for m in self.modules.values() for fi in m.functions.values()
        ]
        for fi in funcs:
            fi.coll_effect, fi.store_effect, fi.host_effect = (
                self._direct_effects(fi)
            )
        # call edges (resolved once; includes calls inside nested defs)
        for m in self.modules.values():
            for fi in m.functions.values():
                for stmt in getattr(fi.node, "body", []):
                    for node in ast.walk(stmt):
                        if not isinstance(node, ast.Call):
                            continue
                        for t in self.resolve_call(m, fi.cls, node):
                            if t is not fi:
                                fi.edges.append((getattr(node, "lineno", 0), t))
        changed = True
        while changed:
            changed = False
            for fi in funcs:
                for line, t in fi.edges:
                    if fi.coll_effect is None and t.coll_effect is not None:
                        e = t.coll_effect
                        fi.coll_effect = Effect(
                            "collective", e.prim_name, e.prim_path, e.prim_line,
                            ((fi.display,) + e.chain)[: self._MAX_CHAIN],
                        )
                        changed = True
                    if fi.store_effect is None and t.store_effect is not None:
                        e = t.store_effect
                        fi.store_effect = Effect(
                            "store", e.prim_name, e.prim_path, e.prim_line,
                            ((fi.display,) + e.chain)[: self._MAX_CHAIN],
                        )
                        changed = True
                    if fi.host_effect is None and t.host_effect is not None:
                        e = t.host_effect
                        fi.host_effect = Effect(
                            "host", e.prim_name, e.prim_path, e.prim_line,
                            ((fi.display,) + e.chain)[: self._MAX_CHAIN],
                        )
                        changed = True

    # -- trace-context model (R011) -----------------------------------------

    def _mark_trace_roots(self, patterns: Sequence[str]) -> None:
        """Mark traced bodies.

        A function is a trace root when (a) a decorator names a trace
        wrapper (covers `@torch.compile` and
        `@functools.partial(torch.compile, ...)` alike), (b) it is passed
        to one — by name, or through a name bound to an expression that
        mentions it (`obj = wrap(objective) if remat else objective`) —
        or is called from a lambda passed to one, or (c) it matches a
        configured `path-glob::name-glob` seam."""
        for m in self.modules.values():
            by_leaf: Dict[str, List[FunctionInfo]] = {}
            for fi in m.functions.values():
                by_leaf.setdefault(fi.name.rsplit(".", 1)[-1], []).append(fi)
            # single-name assignments anywhere in the module: a wrapped
            # name may be bound to the function it stands for
            bound: Dict[str, Set[str]] = {}
            for node in ast.walk(m.tree):
                if (
                    isinstance(node, ast.Assign)
                    and len(node.targets) == 1
                    and isinstance(node.targets[0], ast.Name)
                ):
                    bound.setdefault(node.targets[0].id, set()).update(
                        _callable_names(node.value)
                    )

            def mark(fi: FunctionInfo, how: str) -> None:
                if fi.trace_root is None:
                    fi.trace_root = how

            # (a) decorators
            for fi in m.functions.values():
                for dec in getattr(fi.node, "decorator_list", []):
                    hits = sorted(
                        q
                        for q in (
                            _qualified_name(m, sub)
                            for sub in ast.walk(dec)
                            if isinstance(sub, (ast.Name, ast.Attribute))
                        )
                        if _is_trace_wrap(q)
                    )
                    if hits:
                        mark(fi, f"decorated with `{hits[0]}`")

            # (b) wrap-call sites
            for node in ast.walk(m.tree):
                if not isinstance(node, ast.Call) or not node.args:
                    continue
                q = _qualified_name(m, node.func)
                if not _is_trace_wrap(q):
                    continue
                short = q.rsplit(".", 1)[-1]
                arg = node.args[0]
                if isinstance(arg, ast.Name):
                    names = {arg.id} | bound.get(arg.id, set())
                    for nm in sorted(names):
                        for fi in by_leaf.get(nm, []):
                            mark(fi, f"passed to `{short}`")
                elif isinstance(arg, ast.Lambda):
                    for call in ast.walk(arg.body):
                        if not isinstance(call, ast.Call):
                            continue
                        for fi in self.resolve_call(m, None, call):
                            mark(fi, f"called from a lambda passed to `{short}`")

            # (c) configured seams
            for pat in patterns:
                if "::" not in pat:
                    continue
                pglob, nglob = pat.split("::", 1)
                if not fnmatch.fnmatch(m.path, pglob):
                    continue
                for fi in m.functions.values():
                    if fi.trace_root is None and fnmatch.fnmatchcase(
                        fi.name, nglob
                    ):
                        fi.trace_root = f"configured trace root `{pat}`"

    def _compute_trace_reach(self) -> None:
        """Traced-context reachability: flows DOWN the call graph (root →
        callees), the opposite direction of the effect summaries."""
        work: List[FunctionInfo] = []
        for m in self.modules.values():
            for fi in m.functions.values():
                if fi.trace_root is not None:
                    fi.trace_ctx = TraceCtx(
                        reason=fi.trace_root,
                        root_display=fi.display,
                        root_path=fi.path,
                        root_line=getattr(fi.node, "lineno", 0),
                        chain=(fi.display,),
                    )
                    work.append(fi)
        while work:
            fi = work.pop()
            ctx = fi.trace_ctx
            if ctx is None or len(ctx.chain) >= self._MAX_CHAIN:
                continue
            for _line, t in fi.edges:
                if t.trace_ctx is None:
                    t.trace_ctx = TraceCtx(
                        ctx.reason, ctx.root_display, ctx.root_path,
                        ctx.root_line, ctx.chain + (t.display,),
                    )
                    work.append(t)

    def _collect_mesh_axes(self) -> None:
        """Harvest axis-name string literals from every mesh-constructing
        call project-wide (the R015 registry). Over-inclusive on purpose:
        an extra registry entry only mutes the rule, never misfires it."""
        for m in self.modules.values():
            for node in ast.walk(m.tree):
                if not isinstance(node, ast.Call):
                    continue
                name = _call_name(node)
                if name is None or "mesh" not in name.lower():
                    continue
                pools: List[ast.expr] = [
                    a for a in node.args if isinstance(a, (ast.Tuple, ast.List))
                ]
                pools += [
                    kw.value
                    for kw in node.keywords
                    if kw.arg in (
                        "axis_names", "axis_name", "axes", "mesh_dim_names",
                    )
                    and kw.value is not None
                ]
                for expr in pools:
                    for sub in ast.walk(expr):
                        if isinstance(sub, ast.Constant) and isinstance(
                            sub.value, str
                        ):
                            self.mesh_axes.add(sub.value)

    # -- project-wide store-key + fault-registry facts ---------------------

    def _collect_store_deletes(self) -> None:
        for m in self.modules.values():
            for prefix in _iter_delete_key_prefixes(m.tree, m.consts):
                self.delete_key_prefixes.add(prefix)

    def _extract_fault_registry(self) -> None:
        """Fallback registry discovery (build_project overrides this with
        the configured module): the default registry path first, then any
        */faults.py in deterministic path order."""
        candidates = sorted(
            (m for m in self.modules.values() if m.path.endswith("faults.py")),
            key=lambda m: (m.path != DEFAULT_FAULT_REGISTRY, m.path),
        )
        for m in candidates:
            pts = _extract_fault_registry(m.tree)
            if pts is not None:
                self.fault_points = pts
                return


def _extract_fault_registry(tree: ast.Module) -> Optional[Set[str]]:
    """Find ``KNOWN_POINTS = frozenset({...})`` (or a plain set/list/tuple
    literal) and return its string members."""
    for node in tree.body:
        if not isinstance(node, ast.Assign):
            continue
        if not any(
            isinstance(t, ast.Name) and t.id in ("KNOWN_POINTS", "_KNOWN_POINTS")
            for t in node.targets
        ):
            continue
        value = node.value
        if (
            isinstance(value, ast.Call)
            and _call_name(value) in ("frozenset", "set")
            and value.args
        ):
            value = value.args[0]
        if isinstance(value, (ast.Set, ast.List, ast.Tuple)):
            out = {
                e.value
                for e in value.elts
                if isinstance(e, ast.Constant) and isinstance(e.value, str)
            }
            return out
    return None


# ---------------------------------------------------------------------------
# the gate/flow analyzer (R001, R002, R004, R010)
# ---------------------------------------------------------------------------


class _FunctionAnalyzer:
    """Per-scope walker. A "scope" is a module body or one function body;
    nested functions are analyzed in their own scope (they do not inherit
    the outer scope's rank gating — they may run elsewhere)."""

    def __init__(
        self,
        path: str,
        findings: List[Finding],
        project: Optional[Project] = None,
        minfo: Optional[ModuleInfo] = None,
    ):
        self.path = path
        self.findings = findings
        self.project = project
        self.minfo = minfo
        self._cls: Optional[str] = None

    # -- entry points ------------------------------------------------------

    def run_module(self, tree: ast.Module) -> None:
        self._scan_scope(tree.body, func=None, cls=None)
        self._walk_defs(tree, cls=None)

    def _walk_defs(self, node: ast.AST, cls: Optional[str]) -> None:
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                self._scan_scope(child.body, func=child, cls=cls)
                self._walk_defs(child, cls)  # closures may still bind self
            elif isinstance(child, ast.ClassDef):
                self._walk_defs(child, child.name)
            else:
                self._walk_defs(child, cls)

    # -- scope scan --------------------------------------------------------

    def _scan_scope(self, body: List[ast.stmt], func, cls: Optional[str]) -> None:
        group_param = None
        group_derived: Set[str] = set()
        if func is not None:
            group_param = _group_param_of(func)
            if group_param:
                group_derived = {group_param}

        state = _ScopeState(
            tainted=set(),
            group_param=group_param,
            group_derived=group_derived,
            func=func,
            cls=cls,
            shadowed=_local_callables(body) if func is not None else set(),
        )
        self._scan_block(body, state, rank_gate=None, anchors=(), loop=None)

    def _scan_block(
        self,
        body: List[ast.stmt],
        state: "_ScopeState",
        rank_gate: Optional[int],
        anchors: Tuple[int, ...],
        loop: Optional[Tuple[int, str]],
    ) -> None:
        """Walk one statement list. ``rank_gate`` is the line of the
        innermost rank-dependent branch governing this block (None when
        unconditional); ``anchors`` are extra suppression anchor lines;
        ``loop`` is (line, reason) of the innermost rank-local-trip-count
        loop governing this block (R010)."""
        gate = rank_gate
        for stmt in body:
            # rank taint propagation (me = g.rank(), ...)
            state.tainted |= _rank_taint_targets(stmt, state.tainted)
            # group derivation (g = _resolve(group), pg = group or WORLD)
            state.absorb_group_derivation(stmt)

            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue  # analyzed as its own scope
            if isinstance(stmt, ast.ClassDef):
                # methods get their own scopes; class-level statements
                # keep the current gate
                self._scan_block(stmt.body, state, gate, anchors, loop)
                continue

            if isinstance(stmt, (ast.If, ast.While)):
                test_is_rank = _is_rank_expr(stmt.test, state.tainted)
                inner_gate = stmt.lineno if test_is_rank else gate
                inner_loop = loop
                if (
                    isinstance(stmt, ast.While)
                    and not test_is_rank
                    and _is_local_data_expr(stmt.test)
                ):
                    inner_loop = (stmt.lineno, "while-test over rank-local state")
                self._visit_exprs(stmt.test, state, gate, anchors, loop)
                self._scan_block(
                    stmt.body, state, inner_gate, anchors + (stmt.lineno,), inner_loop
                )
                self._scan_block(
                    stmt.orelse, state, inner_gate, anchors + (stmt.lineno,), loop
                )
                # rank-gated early exit: the REST of this block only runs
                # on the ranks that did not leave. For an `if`, a trailing
                # return/continue/break all divert (continue/break leave
                # the ENCLOSING loop iteration); for a `while`, only
                # `return` does — break/continue exit the while itself,
                # after which every rank converges again.
                if test_is_rank and gate is None and _block_diverts(
                    stmt.body, returns_only=isinstance(stmt, ast.While)
                ):
                    gate = stmt.lineno
                continue

            if isinstance(stmt, ast.Try):
                self._scan_try(stmt, state, gate, anchors, loop)
                continue

            if isinstance(stmt, (ast.For, ast.AsyncFor)):
                inner_loop = loop
                if _is_rank_expr(stmt.iter, state.tainted):
                    inner_loop = (stmt.lineno, "iterating a rank-derived value")
                elif _is_local_data_expr(stmt.iter):
                    inner_loop = (stmt.lineno, "iterating a rank-local collection")
                self._visit_exprs(stmt.iter, state, gate, anchors, loop)
                self._scan_block(
                    stmt.body, state, gate, anchors + (stmt.lineno,), inner_loop
                )
                self._scan_block(stmt.orelse, state, gate, anchors, loop)
                continue

            if isinstance(stmt, (ast.With, ast.AsyncWith)):
                for item in stmt.items:
                    self._visit_exprs(item.context_expr, state, gate, anchors, loop)
                self._scan_block(stmt.body, state, gate, anchors, loop)
                continue

            self._visit_exprs(stmt, state, gate, anchors, loop)

    def _scan_try(
        self,
        stmt: ast.Try,
        state: "_ScopeState",
        gate: Optional[int],
        anchors: Tuple[int, ...],
        loop: Optional[Tuple[int, str]],
    ) -> None:
        self._cls = state.cls
        swallowing = [
            h
            for h in stmt.handlers
            if _handler_is_broad(h) and _handler_swallows(h)
        ]
        try_anchors = anchors + (stmt.lineno,)
        if swallowing:
            h = swallowing[0]
            for sub_stmt in stmt.body:
                # skip nested def/lambda bodies: a collective defined (not
                # called) inside the try executes in another scope, outside
                # the swallowing handler
                for call in (
                    n
                    for n in _walk_skip_nested_funcs(sub_stmt)
                    if isinstance(n, ast.Call)
                ):
                    if state.is_collective(call):
                        self._emit(
                            "R002",
                            call,
                            f"collective `{_call_name(call)}` inside a try whose "
                            f"broad handler (line {h.lineno}) swallows and "
                            "continues: an excepting rank abandons the "
                            "collective schedule while peers keep waiting",
                            try_anchors + (h.lineno,),
                        )
                        continue
                    for t in self._effectful(call, "collective"):
                        e = t.coll_effect
                        self._emit(
                            "R002",
                            call,
                            f"call to `{t.display}` inside a try whose broad "
                            f"handler (line {h.lineno}) swallows and continues; "
                            f"it may issue {e.describe()} — an excepting rank "
                            "abandons the collective schedule while peers wait",
                            try_anchors + (h.lineno,),
                            trace=e.chain,
                        )
        self._scan_block(stmt.body, state, gate, try_anchors, loop)
        for h in stmt.handlers:
            self._scan_block(h.body, state, gate, try_anchors + (h.lineno,), loop)
        self._scan_block(stmt.orelse, state, gate, try_anchors, loop)
        self._scan_block(stmt.finalbody, state, gate, try_anchors, loop)

    def _effectful(self, call: ast.Call, kind: str) -> List[FunctionInfo]:
        if self.project is None or self.minfo is None:
            return []
        return self.project.effectful_targets(self.minfo, self._cls, call, kind)

    def _visit_exprs(
        self,
        node: ast.AST,
        state: "_ScopeState",
        gate: Optional[int],
        anchors: Tuple[int, ...],
        loop: Optional[Tuple[int, str]],
    ) -> None:
        self._cls = state.cls
        for call in (n for n in ast.walk(node) if isinstance(n, ast.Call)):
            name = _call_name(call)
            if state.is_collective(call):
                if gate is not None:
                    self._emit(
                        "R001",
                        call,
                        f"collective `{name}` runs only on ranks satisfying the "
                        f"rank-dependent branch at line {gate}; ranks that skip "
                        "it desynchronize the collective schedule",
                        anchors + (gate,),
                    )
                if loop is not None:
                    self._emit(
                        "R010",
                        call,
                        f"collective `{name}` inside the loop at line {loop[0]} "
                        f"whose trip count depends on rank-local data "
                        f"({loop[1]}): ranks iterating different counts issue "
                        "different collective schedules",
                        anchors + (loop[0],),
                    )
                if (
                    state.group_param
                    and not self._forwards_group(call, state)
                    and self._takes_group(call)
                ):
                    self._emit(
                        "R004",
                        call,
                        f"collective `{name}` does not forward this function's "
                        f"`{state.group_param}` parameter — it will run on the "
                        "default group instead of the caller's",
                        anchors + ((state.func.lineno,) if state.func else ()),
                        fix=self._fix_for(call, "group", state.group_param),
                    )
                continue
            # interprocedural: calls to may-issue-collective helpers
            p2p = name in _P2P_OPS
            for t in self._effectful(call, "collective"):
                e = t.coll_effect
                if gate is not None and not p2p:
                    self._emit(
                        "R001",
                        call,
                        f"rank-gated call to `{t.display}` (branch at line "
                        f"{gate}), which may issue {e.describe()}; ranks that "
                        "skip the branch desynchronize the collective schedule",
                        anchors + (gate,),
                        trace=e.chain,
                    )
                if loop is not None and not p2p:
                    self._emit(
                        "R010",
                        call,
                        f"call to `{t.display}` inside the loop at line "
                        f"{loop[0]} whose trip count depends on rank-local "
                        f"data ({loop[1]}); it may issue {e.describe()}",
                        anchors + (loop[0],),
                        trace=e.chain,
                    )
                if (
                    state.group_param
                    and t.group_param
                    and not self._forwards_group(call, state)
                ):
                    self._emit(
                        "R004",
                        call,
                        f"call to `{t.display}` (which takes `{t.group_param}` "
                        f"and may issue {e.describe()}) does not forward this "
                        f"function's `{state.group_param}` parameter — the "
                        "collective will run on the default group",
                        anchors + ((state.func.lineno,) if state.func else ()),
                        trace=e.chain,
                        fix=self._fix_for(
                            call,
                            t.group_param,
                            state.group_param,
                            group_pos=_group_param_index(
                                t.node, t.group_param, t.cls
                            ),
                        ),
                    )

    def _fix_for(self, call: ast.Call, kw: str, param: str, group_pos=None):
        end_line = getattr(call, "end_lineno", None)
        end_col = getattr(call, "end_col_offset", None)
        if end_line is None or end_col is None:
            return None
        # don't fight an existing keyword of the same name — and a **kw
        # expansion may already carry it (that's usually WHY **kw exists),
        # where appending group= would raise duplicate-keyword TypeError
        if any(k.arg == kw or k.arg is None for k in call.keywords):
            return None
        # nor a positionally-filled group slot (same TypeError): use the
        # callee's real arg index when known, else the known collective
        # signatures, else only fix single-positional calls
        if group_pos is None:
            group_pos = _COLLECTIVE_GROUP_POS.get(_call_name(call), 1)
        if len(call.args) > group_pos:
            return None
        return (end_line, end_col, kw, param)

    def _takes_group(self, call: ast.Call) -> bool:
        """False when the collective resolves to project functions none of
        which takes a group: `nn/functional.py`'s rank collectives run
        over a mesh axis (`axis_name`), never on the default group."""
        if self.project is None or self.minfo is None:
            return True
        targets = self.project.resolve_call(self.minfo, self._cls, call)
        return not targets or any(t.group_param for t in targets)

    def _forwards_group(self, call: ast.Call, state: "_ScopeState") -> bool:
        # method call on the group itself (g.backend_impl.barrier(), ...)
        if isinstance(call.func, ast.Attribute) and (
            _expr_all_idents(call.func.value) & state.group_derived
        ):
            return True
        for kw in call.keywords:
            if kw.arg in ("group", "process_group") or kw.arg is None:
                if kw.value is not None and (
                    _expr_all_idents(kw.value) & state.group_derived
                ):
                    return True
        for arg in call.args:
            if _expr_all_idents(arg) & state.group_derived:
                return True
        return False

    def _emit(
        self,
        rule: str,
        node: ast.AST,
        message: str,
        anchors: Tuple[int, ...],
        trace: Tuple[str, ...] = (),
        fix=None,
    ) -> None:
        f = Finding(
            path=self.path,
            line=getattr(node, "lineno", 0),
            col=getattr(node, "col_offset", 0) + 1,
            rule=rule,
            message=message,
            trace=tuple(trace),
        )
        f._anchors = anchors  # type: ignore[attr-defined]
        if fix is not None:
            f._fix = fix  # type: ignore[attr-defined]
        self.findings.append(f)


def _local_callables(body: List[ast.stmt]) -> Set[str]:
    """Names a function body binds to a callable of its own (a nested
    `def`, or a lambda): a call of one runs that code, not a collective
    of the same name (`def reduce(x, fn): ...` in a norm helper)."""
    out: Set[str] = set()
    for stmt in body:
        for node in _walk_skip_nested_funcs(stmt):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                out.add(node.name)
            elif isinstance(node, ast.Assign) and isinstance(
                node.value, ast.Lambda
            ):
                out |= {t.id for t in node.targets if isinstance(t, ast.Name)}
    return out


@dataclass
class _ScopeState:
    tainted: Set[str]
    group_param: Optional[str]
    group_derived: Set[str]
    func: Optional[ast.AST]
    cls: Optional[str] = None
    shadowed: Set[str] = field(default_factory=set)

    def is_collective(self, call: ast.Call) -> bool:
        """A direct collective issue, unless a bare name calls a local
        callable of the same name."""
        if isinstance(call.func, ast.Name) and call.func.id in self.shadowed:
            return False
        return _is_collective_call(call)

    def absorb_group_derivation(self, stmt: ast.stmt) -> None:
        """``g = _resolve(group)`` makes ``g`` group-derived too; attribute
        idents count, so ``self.process_group = _resolve(process_group)``
        followed by ``g = self.process_group`` keeps the chain."""
        if self.group_param is None:
            return
        if not isinstance(stmt, (ast.Assign, ast.AnnAssign)):
            return
        value = stmt.value
        if value is None or not (_expr_all_idents(value) & self.group_derived):
            return
        targets = stmt.targets if isinstance(stmt, ast.Assign) else [stmt.target]
        for t in targets:
            if isinstance(t, ast.Name):
                self.group_derived.add(t.id)
            elif isinstance(t, ast.Attribute):
                self.group_derived.add(t.attr)


def _block_diverts(body: List[ast.stmt], returns_only: bool = False) -> bool:
    """Does this block end by leaving the enclosing block (early exit)?
    ``returns_only`` for while-bodies, where break/continue stay local."""
    if not body:
        return False
    last = body[-1]
    if returns_only:
        return isinstance(last, ast.Return)
    return isinstance(last, (ast.Return, ast.Continue, ast.Break))


# -- R003: linear launch/store-op/wait ordering per scope -------------------


class _AsyncWindowAnalyzer:
    """Scans each scope's statements in source order, tracking how many
    async collective launches are outstanding; a blocking store /
    rendezvous op (or a call to a may-block-on-store helper) inside that
    window is flagged."""

    def __init__(
        self,
        path: str,
        findings: List[Finding],
        project: Optional[Project] = None,
        minfo: Optional[ModuleInfo] = None,
    ):
        self.path = path
        self.findings = findings
        self.project = project
        self.minfo = minfo
        self._cls: Optional[str] = None

    def run_module(self, tree: ast.Module) -> None:
        self._cls = None
        self._scan(tree.body)
        self._walk_defs(tree, None)

    def _walk_defs(self, node: ast.AST, cls: Optional[str]) -> None:
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                self._cls = cls
                self._scan(child.body)
                self._walk_defs(child, cls)
            elif isinstance(child, ast.ClassDef):
                self._walk_defs(child, child.name)
            else:
                self._walk_defs(child, cls)

    def _scan(self, body: List[ast.stmt]) -> None:
        events: List[Tuple[int, str, ast.Call, Optional[FunctionInfo]]] = []
        for stmt in body:
            for node in _walk_skip_nested_funcs(stmt):
                if not isinstance(node, ast.Call):
                    continue
                kind, target = self._classify(node)
                if kind:
                    events.append((getattr(node, "lineno", 0), kind, node, target))
        events.sort(key=lambda e: e[0])
        outstanding = 0
        for line, kind, call, target in events:
            if kind == "launch":
                outstanding += 1
            elif kind == "wait":
                outstanding = 0
            elif kind == "store" and outstanding > 0:
                if target is not None:
                    e = target.store_effect
                    msg = (
                        f"call to `{target.display}` while {outstanding} async "
                        f"collective launch(es) are outstanding (no intervening "
                        f"Work.wait()); it may block on {e.describe()} and "
                        "deadlock against the unfinished collective"
                    )
                    trace = e.chain
                else:
                    msg = (
                        f"blocking store/rendezvous op "
                        f"`{_render_callee(call)}` issued while "
                        f"{outstanding} async collective launch(es) are "
                        "outstanding (no intervening Work.wait()): the "
                        "store op can deadlock against the unfinished "
                        "collective"
                    )
                    trace = ()
                f = Finding(
                    path=self.path,
                    line=line,
                    col=getattr(call, "col_offset", 0) + 1,
                    rule="R003",
                    message=msg,
                    trace=tuple(trace),
                )
                f._anchors = ()  # type: ignore[attr-defined]
                self.findings.append(f)

    def _classify(self, call: ast.Call) -> Tuple[Optional[str], Optional[FunctionInfo]]:
        name = _call_name(call)
        if name in COLLECTIVES:
            for kw in call.keywords:
                if (
                    kw.arg == "async_op"
                    and isinstance(kw.value, ast.Constant)
                    and kw.value.value is True
                ):
                    return "launch", None
            return None, None
        if name == "wait":
            f = call.func
            if isinstance(f, ast.Attribute) and _receiver_mentions_store(f.value):
                return "store", None
            return "wait", None
        if name in _STORE_BLOCKING_ATTRS:
            f = call.func
            if isinstance(f, ast.Attribute) and _receiver_mentions_store(f.value):
                return "store", None
            return None, None
        if name in ("rendezvous", "monitored_barrier"):
            return "store", None
        if self.project is not None and self.minfo is not None:
            targets = self.project.effectful_targets(
                self.minfo, self._cls, call, "store"
            )
            if targets:
                return "store", targets[0]
        return None, None


# -- R006: Work-handle lifecycle per scope ----------------------------------


class _WorkLifecycleAnalyzer:
    """Flags async collective launches (`async_op=True`, or raw
    `._dispatch(...)`) whose Work handle is discarded or bound to a name
    that is never used again in the scope (no `.wait()`, no return, no
    store, no hand-off). Launches inside a `with coalescing_manager(...)`
    block are exempt: the manager captures and waits them."""

    def __init__(self, path: str, findings: List[Finding]):
        self.path = path
        self.findings = findings

    def run_module(self, tree: ast.Module) -> None:
        self._scan(tree.body)
        for node in ast.walk(tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                self._scan(node.body)

    # scope scan

    def _scan(self, body: List[ast.stmt]) -> None:
        parents: Dict[ast.AST, ast.AST] = {}
        launches: List[Tuple[ast.Call, bool]] = []  # (call, inside_cm)
        loads: Dict[str, int] = {}

        def walk(node: ast.AST, in_cm: bool) -> None:
            if isinstance(node, (ast.With, ast.AsyncWith)):
                cm = any(
                    isinstance(it.context_expr, ast.Call)
                    and _call_name(it.context_expr) == "coalescing_manager"
                    for it in node.items
                )
                in_cm = in_cm or cm
            for child in ast.iter_child_nodes(node):
                if isinstance(
                    child, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)
                ):
                    continue  # deferred scope
                parents[child] = node
                if isinstance(child, ast.Call):
                    if self._is_launch(child):
                        launches.append((child, in_cm))
                walk(child, in_cm)

        for stmt in body:
            # liveness loads are counted over EVERY statement including
            # nested def/lambda bodies (unlike the launch walk, which must
            # not attribute a nested scope's launches here): both
            # `defer(lambda: w.wait())` and `def finisher(): w.wait()`
            # are legitimate deferred hand-offs of the Work, not dead names
            for sub in ast.walk(stmt):
                if isinstance(sub, ast.Name) and isinstance(sub.ctx, ast.Load):
                    loads[sub.id] = loads.get(sub.id, 0) + 1
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            walk(stmt, False)

        for call, in_cm in launches:
            if in_cm:
                continue
            verdict = self._verdict(call, parents, loads)
            if verdict is None:
                continue
            f = Finding(
                path=self.path,
                line=getattr(call, "lineno", 0),
                col=getattr(call, "col_offset", 0) + 1,
                rule="R006",
                message=verdict,
                trace=(),
            )
            f._anchors = ()  # type: ignore[attr-defined]
            self.findings.append(f)

    @staticmethod
    def _is_launch(call: ast.Call) -> bool:
        name = _call_name(call)
        if name in COLLECTIVES:
            return any(
                kw.arg == "async_op"
                and isinstance(kw.value, ast.Constant)
                and kw.value.value is True
                for kw in call.keywords
            )
        return name == _DISPATCH_ATTR and isinstance(call.func, ast.Attribute)

    def _verdict(
        self,
        call: ast.Call,
        parents: Dict[ast.AST, ast.AST],
        loads: Dict[str, int],
    ) -> Optional[str]:
        """None when the Work is handled; otherwise the finding message."""
        name = _call_name(call)
        node: ast.AST = call
        p = parents.get(node)
        while p is not None:
            if isinstance(p, ast.Attribute) and p.attr == "wait":
                return None  # launch(...).wait()
            if isinstance(p, ast.Call) and p is not call:
                return None  # passed straight into another call
            if isinstance(p, (ast.Return, ast.Yield, ast.YieldFrom, ast.Await)):
                return None  # escapes to the caller
            if isinstance(p, (ast.Assign, ast.AnnAssign, ast.NamedExpr)):
                names = self._bound_work_names(p, call)
                if names is None:
                    return None  # bound into a structure we can't track
                dead = [
                    n for n in names if n != "_" and loads.get(n, 0) == 0
                ]
                if dead and len(dead) == len([n for n in names if n != "_"]):
                    return (
                        f"async collective launch `{name}` binds its Work "
                        f"handle to `{'`, `'.join(dead)}` which is never "
                        "wait()ed on, returned, or handed off in this scope: "
                        "a fire-and-forget collective that peers will block on"
                    )
                return None
            if isinstance(p, ast.Expr):
                return (
                    f"async collective launch `{name}` discards its Work "
                    "handle: nothing can ever wait() on this collective, "
                    "while peer ranks block in it"
                )
            node, p = p, parents.get(p)
        return None

    @staticmethod
    def _bound_work_names(assign: ast.AST, call: ast.Call) -> Optional[List[str]]:
        """Names that hold the Work after `targets = <call>`; None when the
        value is not exactly the launch call (conservative: handled)."""
        value = getattr(assign, "value", None)
        if value is not call:
            return None
        if isinstance(assign, ast.NamedExpr):
            t = assign.target
            return [t.id] if isinstance(t, ast.Name) else None
        targets = assign.targets if isinstance(assign, ast.Assign) else [assign.target]
        if len(targets) != 1:
            return None
        t = targets[0]
        if isinstance(t, ast.Name):
            return [t.id]
        if isinstance(t, ast.Tuple) and all(isinstance(e, ast.Name) for e in t.elts):
            names = [e.id for e in t.elts]
            # `out, work = g._dispatch(...)`: the Work rides in slot 2
            if _call_name(call) == _DISPATCH_ATTR and len(names) == 2:
                return [names[1]]
            return names
        return None


# -- R005 -------------------------------------------------------------------


def _scan_silent_excepts(path: str, tree: ast.Module, findings: List[Finding]) -> None:
    for node in ast.walk(tree):
        if not isinstance(node, ast.Try):
            continue
        for h in node.handlers:
            if _handler_is_broad(h) and _handler_is_silent(h):
                f = Finding(
                    path=path,
                    line=h.lineno,
                    col=h.col_offset + 1,
                    rule="R005",
                    message=(
                        "broad `except` swallows silently in a "
                        "dispatch-path module; raise a typed exception, "
                        "log, or suppress with a reason"
                    ),
                )
                f._anchors = (node.lineno,)  # type: ignore[attr-defined]
                findings.append(f)


# -- R007: store coordination-key lifecycle ---------------------------------


def _static_key(expr: ast.expr, consts: Dict[str, str]) -> Optional[Tuple[str, List[Set[str]]]]:
    """(static prefix, per-field identifier sets) of a store-key
    expression, or None when the key is dynamic."""
    if isinstance(expr, ast.Constant) and isinstance(expr.value, str):
        return expr.value, []
    if isinstance(expr, ast.Name) and expr.id in consts:
        return consts[expr.id], []
    if isinstance(expr, ast.JoinedStr):
        prefix = ""
        fields: List[Set[str]] = []
        for v in expr.values:
            if isinstance(v, ast.Constant) and isinstance(v.value, str):
                if not fields:
                    prefix += v.value
            elif isinstance(v, ast.FormattedValue):
                fields.append(_expr_all_idents(v.value))
        if not prefix:
            return None
        return prefix, fields
    return None


def _key_is_scoped(prefix: str, fields: List[Set[str]]) -> bool:
    """A key is incarnation-scoped when a formatted field reads a
    generation/round/seq-ish value, or when the namespace segment right
    before the first field names one (``agent/gen{target}/...``)."""
    if any(_SCOPE_FIELD_RE.search(n) for f in fields for n in f):
        return True
    if fields:
        tail = prefix.rstrip("/").rsplit("/", 1)[-1]
        if _SCOPE_FIELD_RE.search(tail):
            return True
    return False


class _ClassStackVisitor(ast.NodeVisitor):
    """NodeVisitor that tracks the enclosing class name."""

    def __init__(self) -> None:
        self._cls: List[str] = []

    @property
    def cls(self) -> Optional[str]:
        return self._cls[-1] if self._cls else None

    def visit_ClassDef(self, node: ast.ClassDef) -> None:
        self._cls.append(node.name)
        self.generic_visit(node)
        self._cls.pop()


def _store_like_receiver(expr: ast.expr, cls: Optional[str]) -> bool:
    for sub in ast.walk(expr):
        if isinstance(sub, ast.Name):
            n = sub.id.lower()
            if "store" in n or n in ("ctrl", "st"):
                return True
            if n in ("self", "cls") and cls and "Store" in cls:
                return True
        elif isinstance(sub, ast.Attribute):
            a = sub.attr.lower()
            if "store" in a or a == "ctrl":
                return True
    return False


def _iter_delete_key_prefixes(tree: ast.Module, consts: Dict[str, str]):
    """Static prefixes of every `*.delete_key(<key>)` in a module."""

    class V(_ClassStackVisitor):
        out: List[str] = []

        def visit_Call(self, node: ast.Call) -> None:
            if (
                isinstance(node.func, ast.Attribute)
                and node.func.attr == "delete_key"
                and node.args
                and _store_like_receiver(node.func.value, self.cls)
            ):
                key = _static_key(node.args[0], consts)
                if key is not None:
                    self.out.append(key[0])
            self.generic_visit(node)

    v = V()
    v.out = []
    v.visit(tree)
    return v.out


def _prefixes_compatible(a: str, b: str) -> bool:
    return bool(a) and bool(b) and (a.startswith(b) or b.startswith(a))


def _scan_store_key_lifecycle(
    path: str,
    tree: ast.Module,
    findings: List[Finding],
    project: Optional[Project],
    consts: Optional[Dict[str, str]] = None,
) -> None:
    consts = consts or {}
    deletes: Set[str] = set(_iter_delete_key_prefixes(tree, consts))
    if project is not None:
        deletes |= project.delete_key_prefixes

    class V(_ClassStackVisitor):
        def visit_Call(self, node: ast.Call) -> None:
            self.generic_visit(node)
            if not (
                isinstance(node.func, ast.Attribute)
                and node.func.attr in ("set", "add")
                and node.args
                and _store_like_receiver(node.func.value, self.cls)
            ):
                return
            key = _static_key(node.args[0], consts)
            if key is None:
                return
            prefix, fields = key
            if _key_is_scoped(prefix, fields):
                return
            if any(_prefixes_compatible(prefix, d) for d in deletes):
                return
            shown = prefix + ("…" if fields else "")
            f = Finding(
                path=path,
                line=node.lineno,
                col=node.col_offset + 1,
                rule="R007",
                message=(
                    f"store key `{shown}` is {node.func.attr}-ed but never "
                    "delete_key-ed anywhere in the project and carries no "
                    "incarnation/round field: on a persistent store daemon "
                    "it leaks into every later generation (scope it with a "
                    "gen/round component, delete it, or suppress with the "
                    "lifetime contract as the reason)"
                ),
            )
            f._anchors = ()  # type: ignore[attr-defined]
            findings.append(f)

    V().visit(tree)


# -- R008: fault-point names vs the faults.py registry ----------------------


def _scan_fault_points(
    path: str,
    tree: ast.Module,
    findings: List[Finding],
    registry: Optional[Set[str]],
) -> None:
    if not registry:
        return

    def point_ok(lit: str, allow_glob: bool) -> bool:
        if lit in registry:
            return True
        if allow_glob:
            return any(fnmatch.fnmatchcase(p, lit) for p in registry)
        return False

    def emit(node: ast.AST, lit: str, how: str) -> None:
        f = Finding(
            path=path,
            line=getattr(node, "lineno", 0),
            col=getattr(node, "col_offset", 0) + 1,
            rule="R008",
            message=(
                f"fault point {lit!r} ({how}) does not match any point in "
                "the faults.py KNOWN_POINTS registry: the plan/fire never "
                "triggers and the chaos path passes vacuously"
            ),
        )
        f._anchors = ()  # type: ignore[attr-defined]
        findings.append(f)

    seen_consts: Set[int] = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Call) and _call_name(node) == "fire":
            recv_ok = isinstance(node.func, ast.Name)
            if isinstance(node.func, ast.Attribute):
                recv_ok = any(
                    "faults" in n for n in map(str.lower, _expr_all_idents(node.func.value))
                )
            if recv_ok and node.args:
                a0 = node.args[0]
                if isinstance(a0, ast.Constant) and isinstance(a0.value, str):
                    seen_consts.add(id(a0))
                    if not point_ok(a0.value, allow_glob=False):
                        emit(a0, a0.value, "faults.fire() literal")
        elif isinstance(node, ast.Dict):
            for k, v in zip(node.keys, node.values):
                if (
                    isinstance(k, ast.Constant)
                    and k.value == "point"
                    and isinstance(v, ast.Constant)
                    and isinstance(v.value, str)
                ):
                    seen_consts.add(id(v))
                    if not point_ok(v.value, allow_glob=True):
                        emit(v, v.value, "fault-plan dict")
    for node in ast.walk(tree):
        if (
            isinstance(node, ast.Constant)
            and isinstance(node.value, str)
            and id(node) not in seen_consts
            and '"point"' in node.value
        ):
            for lit in _POINT_IN_STRING_RE.findall(node.value):
                if not point_ok(lit, allow_glob=True):
                    emit(node, lit, "embedded JSON plan string")


# -- R011: host effects reachable from trace roots --------------------------


class _TraceHostEffectAnalyzer:
    """For every function the project marked trace-reachable, flag direct
    host-side primitives and calls to may-host-effect helpers inside its
    body (nested defs included: a closure built in traced code runs under
    the same trace when called). Dedupes by call node so a primitive
    inside a registered nested trace root is reported once."""

    def __init__(self, path: str, findings: List[Finding], project: Project,
                 minfo: ModuleInfo):
        self.path = path
        self.findings = findings
        self.project = project
        self.minfo = minfo

    def run(self) -> None:
        seen: Set[int] = set()
        for fi in self.minfo.functions.values():
            ctx = fi.trace_ctx
            if ctx is None:
                continue
            for stmt in getattr(fi.node, "body", []):
                for node in ast.walk(stmt):
                    if not isinstance(node, ast.Call) or id(node) in seen:
                        continue
                    label = _host_prim_label(node)
                    if label is not None:
                        seen.add(id(node))
                        self._emit(
                            fi, ctx, node,
                            f"host-side op `{label}` can execute under "
                            f"tracing: `{fi.display}` is {ctx.describe()}. A "
                            "traced body must stay device-pure — under a "
                            "torch.func transform this raises on a batched "
                            "tensor, and under torch.compile it runs ONCE "
                            "at trace time (or breaks the graph) instead of "
                            "every step",
                            extra_trace=(),
                        )
                        continue
                    name = _call_name(node)
                    if name in COLLECTIVES or name == _DISPATCH_ATTR:
                        continue
                    targets = [
                        t
                        for t in self.project.resolve_call(
                            self.minfo, fi.cls, node
                        )
                        if t.host_effect is not None
                    ]
                    if targets:
                        t = targets[0]
                        e = t.host_effect
                        seen.add(id(node))
                        self._emit(
                            fi, ctx, node,
                            f"call to `{t.display}` inside trace context "
                            f"(`{fi.display}` is {ctx.describe()}); it may "
                            f"perform host-side {e.describe()} — a traced "
                            "body must stay device-pure",
                            extra_trace=e.chain,
                        )

    def _emit(self, fi: FunctionInfo, ctx: TraceCtx, node: ast.AST,
              message: str, extra_trace: Tuple[str, ...]) -> None:
        f = Finding(
            path=self.path,
            line=getattr(node, "lineno", 0),
            col=getattr(node, "col_offset", 0) + 1,
            rule="R011",
            message=message,
            trace=tuple(ctx.chain) + tuple(extra_trace),
        )
        anchors: Tuple[int, ...] = (getattr(fi.node, "lineno", 0),)
        if ctx.root_path == self.path:
            anchors += (ctx.root_line,)
        f._anchors = anchors  # type: ignore[attr-defined]
        self.findings.append(f)


# -- R013: paged-pool acquisition/release pairing ---------------------------


def _pool_like_receiver(expr: ast.expr) -> bool:
    for n in map(str.lower, _expr_all_idents(expr)):
        if "pool" in n or "cache" in n:
            return True
    return False


class _PoolLifecycleAnalyzer:
    """Per-function path walk: a locally-bound pool acquisition must be
    released (free()/hand-off/returned) before every non-raising exit.
    Subjects that are function parameters belong to the caller; methods
    of pool/cache classes implement the refcounts and are exempt."""

    def __init__(self, path: str, findings: List[Finding]):
        self.path = path
        self.findings = findings
        self._emitted: Set[Tuple[str, int]] = set()

    def run_module(self, tree: ast.Module) -> None:
        self._walk_defs(tree, None)

    def _walk_defs(self, node: ast.AST, cls: Optional[str]) -> None:
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                self._scan_func(child, cls)
                self._walk_defs(child, cls)
            elif isinstance(child, ast.ClassDef):
                self._walk_defs(child, child.name)
            else:
                self._walk_defs(child, cls)

    def _scan_func(self, func, cls: Optional[str]) -> None:
        if cls is not None and _POOL_IMPL_CLASS_RE.search(cls):
            return
        a = func.args
        self._params = {
            x.arg for x in (a.posonlyargs + a.args + a.kwonlyargs)
        }
        self._func = func
        live: Dict[str, Tuple[int, str]] = {}
        leftover = self._walk_block(func.body, live)
        if leftover:
            for nm, (aline, meth) in sorted(leftover.items()):
                self._leak(
                    func, nm, aline, meth,
                    "before the function falls off its end",
                )

    def _walk_block(
        self, body: List[ast.stmt], live: Dict[str, Tuple[int, str]]
    ) -> Optional[Dict[str, Tuple[int, str]]]:
        """Returns the live map at fall-through, or None when the block
        diverts (return/raise — leaks flagged at the return)."""
        for stmt in body:
            if isinstance(
                stmt, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)
            ):
                continue
            if isinstance(stmt, ast.Raise):
                return None  # raising paths are exempt
            if isinstance(stmt, ast.Return):
                self._apply_releases(stmt, live)
                for nm, (aline, meth) in sorted(live.items()):
                    self._leak(stmt, nm, aline, meth, "on this return path")
                return None
            if isinstance(stmt, ast.If):
                l1 = self._branch_state(stmt.test, live, True)
                l2 = self._branch_state(stmt.test, live, False)
                r1 = self._walk_block(stmt.body, l1)
                r2 = self._walk_block(stmt.orelse, l2)
                live.clear()
                if r1 is not None:
                    live.update(r1)
                if r2 is not None:
                    live.update(r2)
                if r1 is None and r2 is None:
                    return None
                continue
            if isinstance(stmt, (ast.For, ast.AsyncFor)):
                self._walk_block(stmt.body, live)
                self._walk_block(stmt.orelse, live)
                continue
            if isinstance(stmt, ast.While):
                # `while slot is None:` — inside the body the handle holds
                # nothing, so in-loop exits are not leaks; acquisitions
                # made in the body surface to the fall-through state
                body_live = self._branch_state(stmt.test, live, True)
                self._walk_block(stmt.body, body_live)
                self._walk_block(stmt.orelse, live)
                for nm, info in body_live.items():
                    live.setdefault(nm, info)
                continue
            if isinstance(stmt, ast.Try):
                # `finally` runs on EVERY exit path, returns included:
                # apply its releases up front so the canonical
                # `try: return run(req)` / `finally: pool.free(b)` idiom
                # is clean before the body's Return handler flags leaks
                for fstmt in stmt.finalbody:
                    self._apply_releases(fstmt, live)
                self._walk_block(stmt.body, live)
                for h in stmt.handlers:
                    self._walk_block(h.body, dict(live))
                self._walk_block(stmt.orelse, live)
                self._walk_block(stmt.finalbody, live)
                continue
            if isinstance(stmt, (ast.With, ast.AsyncWith)):
                for item in stmt.items:
                    self._apply_releases(item.context_expr, live)
                self._walk_block(stmt.body, live)
                continue
            self._apply_releases(stmt, live)
            self._apply_acquisitions(stmt, live)
        return live

    def _branch_state(
        self, test: ast.expr, live: Dict[str, Tuple[int, str]], truthy: bool
    ) -> Dict[str, Tuple[int, str]]:
        """Copy of the live map entering one branch, condition-aware for
        the allocate-failure idiom: on the `b is None` / `not b` branch
        nothing was actually acquired."""
        out = dict(live)
        none_names: Set[str] = set()
        t = test
        if (
            isinstance(t, ast.Compare)
            and isinstance(t.left, ast.Name)
            and len(t.ops) == 1
            and len(t.comparators) == 1
            and isinstance(t.comparators[0], ast.Constant)
            and t.comparators[0].value is None
        ):
            if isinstance(t.ops[0], ast.Is) and truthy:
                none_names.add(t.left.id)
            if isinstance(t.ops[0], ast.IsNot) and not truthy:
                none_names.add(t.left.id)
        if (
            isinstance(t, ast.UnaryOp)
            and isinstance(t.op, ast.Not)
            and isinstance(t.operand, ast.Name)
            and truthy
        ):
            none_names.add(t.operand.id)
        for nm in none_names:
            out.pop(nm, None)
        return out

    def _apply_acquisitions(
        self, stmt: ast.stmt, live: Dict[str, Tuple[int, str]]
    ) -> None:
        for node in _walk_skip_nested_funcs(stmt):
            if not isinstance(node, ast.Call):
                continue
            f = node.func
            if not (
                isinstance(f, ast.Attribute)
                and f.attr in _POOL_ACQUIRE_ATTRS
                and _pool_like_receiver(f.value)
            ):
                continue
            subject: Optional[str] = None
            if f.attr == "allocate":
                # the handle is the RESULT: only a plain `b = pool.allocate()`
                # binding is trackable
                if (
                    isinstance(stmt, ast.Assign)
                    and stmt.value is node
                    and len(stmt.targets) == 1
                    and isinstance(stmt.targets[0], ast.Name)
                ):
                    subject = stmt.targets[0].id
            else:
                # the handle is the SLOT (first argument)
                if node.args and isinstance(node.args[0], ast.Name):
                    subject = node.args[0].id
            if subject is None or subject in self._params or subject == "self":
                continue
            live.setdefault(
                subject,
                (getattr(node, "lineno", 0), f"{_render_callee(node)}"),
            )

    def _apply_releases(
        self, node: ast.AST, live: Dict[str, Tuple[int, str]]
    ) -> None:
        """Ownership leaves this path when the subject is passed to any
        non-acquiring call (free(), append(), a helper), stored into a
        structure (assign target is an attribute/subscript/other name),
        or returned/yielded. Index-position reads (`kv[b] = x`) are not
        hand-offs."""
        if not live:
            return
        released: Set[str] = set()
        for sub in _walk_skip_nested_funcs(node):
            if isinstance(sub, ast.Call):
                f = sub.func
                acquiring = (
                    isinstance(f, ast.Attribute)
                    and f.attr in _POOL_ACQUIRE_ATTRS
                )
                if acquiring:
                    continue
                for arg in list(sub.args) + [
                    kw.value for kw in sub.keywords if kw.value is not None
                ]:
                    for n in ast.walk(arg):
                        if isinstance(n, ast.Name) and n.id in live:
                            released.add(n.id)
            elif isinstance(sub, ast.Assign):
                structured = any(
                    isinstance(t, (ast.Attribute, ast.Subscript, ast.Name))
                    for t in sub.targets
                )
                if structured and sub.value is not None:
                    for n in ast.walk(sub.value):
                        if isinstance(n, ast.Name) and n.id in live:
                            released.add(n.id)
                # `table[slot] = req` REGISTERS the handle under its own
                # key — the ownership hand-off idiom of the slot tables
                for t in sub.targets:
                    if isinstance(t, ast.Subscript):
                        for n in ast.walk(t.slice):
                            if isinstance(n, ast.Name) and n.id in live:
                                released.add(n.id)
            elif isinstance(sub, (ast.Return, ast.Yield, ast.YieldFrom)):
                v = sub.value
                if v is not None:
                    for n in ast.walk(v):
                        if isinstance(n, ast.Name) and n.id in live:
                            released.add(n.id)
        for nm in released:
            live.pop(nm, None)

    def _leak(
        self, at: ast.AST, nm: str, aline: int, meth: str, where: str
    ) -> None:
        key = (nm, aline)
        if key in self._emitted:
            return
        self._emitted.add(key)
        f = Finding(
            path=self.path,
            line=getattr(at, "lineno", 0),
            col=getattr(at, "col_offset", 0) + 1,
            rule="R013",
            message=(
                f"`{nm}` acquired via `{meth}` (line {aline}) reaches no "
                f"free() or ownership hand-off {where}: the paged pool "
                "leaks a refcount on this path"
            ),
        )
        f._anchors = (  # type: ignore[attr-defined]
            aline,
            getattr(self._func, "lineno", 0),
        )
        self.findings.append(f)


# -- R014: `_lock` discipline -----------------------------------------------


def _is_lock_with(stmt: ast.stmt) -> bool:
    if not isinstance(stmt, (ast.With, ast.AsyncWith)):
        return False
    for item in stmt.items:
        if _expr_all_idents(item.context_expr) & _LOCK_ATTRS:
            return True
    return False


class _LockDisciplineAnalyzer:
    """A class that takes `self._lock` (or its condition wrappers) around
    SOME assignment of a field declares that field lock-guarded; any
    other assignment of it outside the lock (``__init__`` excepted —
    construction is single-threaded) is a race window."""

    def __init__(self, path: str, findings: List[Finding]):
        self.path = path
        self.findings = findings

    def run_module(self, tree: ast.Module) -> None:
        for node in ast.walk(tree):
            if isinstance(node, ast.ClassDef):
                self._scan_class(node)

    def _scan_class(self, cls: ast.ClassDef) -> None:
        methods = [
            n
            for n in cls.body
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))
        ]
        has_lock = any(
            isinstance(t, ast.Attribute)
            and t.attr in _LOCK_ATTRS
            and isinstance(t.value, ast.Name)
            and t.value.id == "self"
            for meth in methods
            for st in ast.walk(meth)
            if isinstance(st, ast.Assign)
            for t in st.targets
        )
        if not has_lock:
            return
        guarded: Dict[str, int] = {}  # field -> first guarded-write line
        for meth in methods:
            self._collect_guarded(meth.body, False, guarded)
        for attr in _LOCK_ATTRS:
            guarded.pop(attr, None)
        if not guarded:
            return
        for meth in methods:
            if meth.name == "__init__":
                continue
            self._flag_unlocked(meth, meth.body, False, guarded)

    def _self_write_targets(self, stmt: ast.stmt) -> List[ast.Attribute]:
        targets: List[ast.expr] = []
        if isinstance(stmt, ast.Assign):
            targets = list(stmt.targets)
        elif isinstance(stmt, (ast.AnnAssign, ast.AugAssign)):
            targets = [stmt.target]
        out = []
        for t in targets:
            if isinstance(t, ast.Tuple):
                tl = list(t.elts)
            else:
                tl = [t]
            for x in tl:
                if (
                    isinstance(x, ast.Attribute)
                    and isinstance(x.value, ast.Name)
                    and x.value.id == "self"
                ):
                    out.append(x)
        return out

    def _collect_guarded(
        self, body: List[ast.stmt], in_lock: bool, guarded: Dict[str, int]
    ) -> None:
        for stmt in body:
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            inner = in_lock or _is_lock_with(stmt)
            if inner:
                for x in (
                    n
                    for n in ast.walk(stmt)
                    if isinstance(n, (ast.Assign, ast.AnnAssign, ast.AugAssign))
                ):
                    for t in self._self_write_targets(x):
                        guarded.setdefault(t.attr, t.lineno)
                continue
            for attr in ("body", "orelse", "finalbody"):
                self._collect_guarded(
                    getattr(stmt, attr, []) or [], in_lock, guarded
                )
            for h in getattr(stmt, "handlers", []) or []:
                self._collect_guarded(h.body, in_lock, guarded)

    def _flag_unlocked(
        self, meth, body: List[ast.stmt], in_lock: bool,
        guarded: Dict[str, int],
    ) -> None:
        for stmt in body:
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            if _is_lock_with(stmt) or in_lock:
                continue
            for t in self._self_write_targets(stmt):
                if t.attr in guarded:
                    f = Finding(
                        path=self.path,
                        line=t.lineno,
                        col=t.col_offset + 1,
                        rule="R014",
                        message=(
                            f"`self.{t.attr}` is written without holding "
                            f"`self._lock`, but the class guards this field "
                            f"with the lock elsewhere (line "
                            f"{guarded[t.attr]}): a concurrent reader sees "
                            "a torn update"
                        ),
                    )
                    f._anchors = (  # type: ignore[attr-defined]
                        getattr(meth, "lineno", 0),
                    )
                    self.findings.append(f)
            for attr in ("body", "orelse", "finalbody"):
                self._flag_unlocked(
                    meth, getattr(stmt, attr, []) or [], in_lock, guarded
                )
            for h in getattr(stmt, "handlers", []) or []:
                self._flag_unlocked(meth, h.body, in_lock, guarded)


# -- R015: sharding-spec axis drift -----------------------------------------


# The port's spec form: a spec is a tuple with one entry per tensor dim,
# each a mesh-axis name, a tuple of names, or None (`parallel/sharding.py`).
# Rule tables map a parameter-name pattern to one: `[(pattern, spec), ...]`.
# Call positions that take a rule table, by callee name.
_RULE_TABLE_ARGS = {"spec_for": 2, "make_param_specs": 1, "shard_params": 2}
# Spec builders whose axis arguments name mesh axes.
_SPEC_BUILDERS = ("fsdp_rules", "data_spec", "sharding_rules")


def _spec_axis_literals(expr: ast.expr) -> List[ast.Constant]:
    """String constants of a spec expression, through nested tuples and
    lists only (a call inside a spec computes it; its strings are not
    axis names)."""
    out: List[ast.Constant] = []
    stack = [expr]
    while stack:
        e = stack.pop()
        if isinstance(e, ast.Constant) and isinstance(e.value, str):
            out.append(e)
        elif isinstance(e, (ast.Tuple, ast.List)):
            stack.extend(e.elts)
    return out


def _rule_entry_spec(entry: ast.expr) -> Optional[ast.expr]:
    """The spec of a rule entry ``(pattern, spec-tuple)``."""
    if (
        isinstance(entry, ast.Tuple)
        and len(entry.elts) == 2
        and isinstance(entry.elts[1], ast.Tuple)
    ):
        return entry.elts[1]
    return None


def _names_a_rule_table(expr: Optional[ast.expr]) -> bool:
    chain = _dotted_chain(expr) if expr is not None else None
    return bool(chain) and "rule" in chain[-1].lower()


class _ShardingSpecAnalyzer:
    """Axis names in the port's spec form must name axes some mesh
    actually constructs. Silent when no mesh is visible in the project
    scope (a lone file with specs but no meshes proves nothing either
    way)."""

    def __init__(self, path: str, findings: List[Finding], project: Project,
                 minfo: Optional[ModuleInfo], config: "LintConfig"):
        self.path = path
        self.findings = findings
        self.registry = set(project.mesh_axes) | set(config.known_mesh_axes)

    def run_module(self, tree: ast.Module) -> None:
        if not self.registry:
            return
        seen: Set[int] = set()

        def check(expr: ast.expr, anchor: ast.AST, how: str) -> None:
            for e in _spec_axis_literals(expr):
                if id(e) in seen or e.value in self.registry:
                    continue
                seen.add(id(e))
                f = Finding(
                    path=self.path,
                    line=e.lineno,
                    col=e.col_offset + 1,
                    rule="R015",
                    message=(
                        f"sharding-spec axis `{e.value}` ({how}) is not an "
                        "axis of any mesh constructed project-wide (known "
                        f"axes: {sorted(self.registry)}): `spec_for` "
                        "raises on it and `spec_to_placements` never "
                        "places it"
                    ),
                )
                f._anchors = (anchor.lineno,)  # type: ignore[attr-defined]
                self.findings.append(f)

        def table(expr: Optional[ast.expr], anchor: ast.AST) -> None:
            if isinstance(expr, (ast.List, ast.Tuple)):
                for entry in expr.elts:
                    spec = _rule_entry_spec(entry)
                    if spec is not None:
                        check(spec, anchor, "rule-table spec")

        for node in ast.walk(tree):
            if isinstance(node, (ast.Assign, ast.AugAssign, ast.AnnAssign)):
                targets = (
                    node.targets if isinstance(node, ast.Assign)
                    else [node.target]
                )
                if any(_names_a_rule_table(t) for t in targets):
                    table(node.value, node)
            elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                if "rule" in node.name.lower():
                    for stmt in node.body:
                        for sub in _walk_skip_nested_funcs(stmt):
                            if isinstance(sub, ast.Return):
                                table(sub.value, sub)
            elif isinstance(node, ast.Call):
                name = _call_name(node)
                if name is None:
                    continue
                for kw in node.keywords:
                    if kw.arg == "rules":
                        table(kw.value, node)
                pos = _RULE_TABLE_ARGS.get(name)
                if pos is not None and pos < len(node.args):
                    table(node.args[pos], node)
                if (
                    name in ("append", "insert", "extend")
                    and isinstance(node.func, ast.Attribute)
                    and _names_a_rule_table(node.func.value)
                ):
                    for arg in node.args:
                        spec = _rule_entry_spec(arg)
                        if spec is not None:
                            check(spec, node, "rule-table spec")
                        table(arg, node)
                if name == "spec_to_placements":
                    spec = node.args[0] if node.args else next(
                        (k.value for k in node.keywords if k.arg == "spec"),
                        None,
                    )
                    if spec is not None:
                        check(spec, node, "spec_to_placements spec")
                if name.endswith(_SPEC_BUILDERS):
                    args = node.args[1:] if name == "data_spec" else node.args
                    for arg in list(args) + [
                        k.value for k in node.keywords if k.arg != "mesh"
                    ]:
                        check(arg, node, f"`{name}` axis")


# ---------------------------------------------------------------------------
# drivers
# ---------------------------------------------------------------------------


def _is_dispatch_path(rel_path: str, config: LintConfig) -> bool:
    p = rel_path.replace(os.sep, "/")
    return any(
        p == m or p.endswith("/" + m) or fnmatch.fnmatch(p, m)
        for m in config.dispatch_path_modules
    )


def lint_source(
    src: str,
    path: str = "<string>",
    config: Optional[LintConfig] = None,
    dispatch_path: Optional[bool] = None,
    project: Optional[Project] = None,
    fault_points: Optional[Set[str]] = None,
    store_lifecycle: Optional[bool] = None,
) -> List[Finding]:
    """Lint one source string. ``dispatch_path`` forces R005 scanning on
    or off (None: decided from ``path`` against the config). ``project``
    supplies cross-file facts (call graph, delete_key prefixes, fault
    registry); without it the analysis is file-local. ``fault_points``
    overrides the R008 registry (unit-test seam)."""
    config = config or LintConfig()
    minfo = project.by_path.get(path.replace(os.sep, "/")) if project else None
    if minfo is not None and minfo.src == src:
        tree = minfo.tree  # Project.build already parsed this exact source
    else:
        try:
            tree = ast.parse(src, filename=path)
        except SyntaxError as e:
            return [
                Finding(
                    path=path,
                    line=e.lineno or 0,
                    col=(e.offset or 0),
                    rule="E000",
                    message=f"syntax error: {e.msg}",
                )
            ]
    findings: List[Finding] = []
    consts = minfo.consts if minfo else {
        t.id: s.value.value
        for s in tree.body
        if isinstance(s, ast.Assign) and isinstance(s.value, ast.Constant)
        and isinstance(s.value.value, str)
        for t in s.targets
        if isinstance(t, ast.Name)
    }
    _FunctionAnalyzer(path, findings, project, minfo).run_module(tree)
    _AsyncWindowAnalyzer(path, findings, project, minfo).run_module(tree)
    _WorkLifecycleAnalyzer(path, findings).run_module(tree)
    # the trace/spec rules need project facts (trace reach, the mesh-axis
    # registry); a file linted without a project gets a throwaway
    # single-module one so the module-local shapes of R011/R015 still fire
    tproject, tminfo = project, minfo
    if tproject is None:
        tproject = Project.build(
            {path.replace(os.sep, "/"): src},
            trace_roots=config.trace_roots,
        )
        tminfo = tproject.by_path.get(path.replace(os.sep, "/"))
    if tminfo is not None:
        _TraceHostEffectAnalyzer(path, findings, tproject, tminfo).run()
        _ShardingSpecAnalyzer(
            path, findings, tproject, tminfo, config
        ).run_module(tree)
    _PoolLifecycleAnalyzer(path, findings).run_module(tree)
    _LockDisciplineAnalyzer(path, findings).run_module(tree)
    if store_lifecycle is None:
        p = path.replace(os.sep, "/")
        store_lifecycle = any(
            p == pref or p.startswith(pref.rstrip("/") + "/")
            for pref in config.store_lifecycle_paths
        )
    if store_lifecycle:
        _scan_store_key_lifecycle(path, tree, findings, project, consts)
    registry = fault_points
    if registry is None and project is not None:
        registry = project.fault_points
    _scan_fault_points(path, tree, findings, registry)
    if dispatch_path is None:
        dispatch_path = _is_dispatch_path(path, config)
    if dispatch_path:
        _scan_silent_excepts(path, tree, findings)

    # severity: drop "off" rules, annotate the rest
    findings = [f for f in findings if config.rule_severity(f.rule) != "off"]
    for f in findings:
        f.severity = config.rule_severity(f.rule)

    per_line, file_wide = _parse_suppressions(src)
    used_line: Set[Tuple[int, str]] = set()
    used_file: Set[str] = set()

    def suppressed(f: Finding) -> bool:
        hit = False
        for r in (f.rule, "ALL"):
            if r in file_wide:
                used_file.add(r)
                hit = True
        lines = (f.line,) + tuple(getattr(f, "_anchors", ()))
        for ln in lines:
            rules = per_line.get(ln)
            if not rules:
                continue
            for r in (f.rule, "ALL"):
                if r in rules:
                    used_line.add((ln, r))
                    hit = True
        return hit

    for f in findings:
        f.suppressed = suppressed(f)

    # R009: suppressions that matched nothing. A suppression of a rule the
    # config turned OFF is skipped, not stale: its findings were dropped
    # before matching, and disabling a rule must not fail a clean tree.
    stale: List[Finding] = []
    if config.rule_severity("R009") != "off":
        for ln, rules in sorted(per_line.items()):
            for r in sorted(rules):
                if (ln, r) in used_line or r == "R009":
                    continue
                if config.rule_severity(r) == "off":
                    continue
                stale.append(
                    Finding(
                        path=path,
                        line=ln,
                        col=1,
                        rule="R009",
                        message=(
                            f"stale suppression: no {r} finding anchors to "
                            "this line any more — delete the comment (an "
                            "unused suppression is a hole for the next bug)"
                        ),
                        severity=config.rule_severity("R009"),
                    )
                )
        for r, ln in sorted(file_wide.items(), key=lambda kv: kv[1]):
            if r in used_file or r == "R009":
                continue
            if config.rule_severity(r) == "off":
                continue
            stale.append(
                Finding(
                    path=path,
                    line=ln,
                    col=1,
                    rule="R009",
                    message=(
                        f"stale file-wide suppression: no {r} finding exists "
                        "in this file any more — delete the comment"
                    ),
                    severity=config.rule_severity("R009"),
                )
            )
    for f in stale:
        rules = per_line.get(f.line, set())
        f.suppressed = "R009" in rules or "R009" in file_wide
    findings.extend(stale)

    _assign_fingerprints(findings, src)
    findings.sort(key=lambda f: (f.path, f.line, f.rule))
    return findings


def _assign_fingerprints(findings: List[Finding], src: str) -> None:
    lines = src.splitlines()
    occ: Dict[Tuple[str, str, str], int] = {}
    for f in sorted(findings, key=lambda f: (f.line, f.col, f.rule)):
        text = lines[f.line - 1].strip() if 0 < f.line <= len(lines) else ""
        key = (f.path, f.rule, text)
        n = occ.get(key, 0)
        occ[key] = n + 1
        h = hashlib.sha1(
            f"{f.path}\x00{f.rule}\x00{text}\x00{n}".encode()
        ).hexdigest()[:16]
        f.fingerprint = h


def lint_file(
    path: str,
    config: Optional[LintConfig] = None,
    root: str = ".",
    project: Optional[Project] = None,
) -> List[Finding]:
    with open(path, "r", encoding="utf-8") as fh:
        src = fh.read()
    rel = os.path.relpath(path, root)
    fault_points = None
    if project is None:
        fault_points = _load_fault_registry_file(root, config or LintConfig())
    return lint_source(src, rel, config, project=project, fault_points=fault_points)


def _load_fault_registry_file(root: str, config: LintConfig) -> Optional[Set[str]]:
    fp = os.path.join(root, config.fault_registry)
    if not os.path.isfile(fp):
        return None
    try:
        with open(fp, "r", encoding="utf-8") as fh:
            return _extract_fault_registry(ast.parse(fh.read()))
    except (OSError, SyntaxError):
        return None


def _expand_path(root: str, p: str) -> List[str]:
    """``p`` under ``root``; a glob expands to its sorted matches."""
    full = os.path.join(root, p)
    if any(ch in p for ch in "*?["):
        return sorted(glob.glob(full))
    return [full]


def _iter_py_files(paths: Sequence[str], exclude: Sequence[str], root: str):
    fulls: List[str] = []
    for p in paths:
        hits = _expand_path(root, p)
        if not hits:
            raise FileNotFoundError(
                f"lint path glob matches nothing: {os.path.join(root, p)}"
            )
        fulls.extend(hits)
    for full in fulls:
        if os.path.isfile(full) and full.endswith(".py"):
            yield full
            continue
        if not os.path.isdir(full):
            # a stale/typo'd path must FAIL, not lint nothing and report
            # the repo clean — that would silently disable the gate
            raise FileNotFoundError(
                f"lint path does not exist (or is not a .py file / "
                f"directory): {full}"
            )
        for dirpath, dirnames, filenames in os.walk(full):
            dirnames[:] = [d for d in dirnames if d not in ("__pycache__",)]
            for name in sorted(filenames):
                if not name.endswith(".py"):
                    continue
                fp = os.path.join(dirpath, name)
                rel = os.path.relpath(fp, root).replace(os.sep, "/")
                if any(ex in rel for ex in exclude):
                    continue
                yield fp


def build_project(
    paths: Optional[Sequence[str]] = None,
    root: str = ".",
    config: Optional[LintConfig] = None,
) -> Project:
    config = config or load_config(root)
    sources: Dict[str, str] = {}
    for fp in _iter_py_files(paths or config.paths, config.exclude, root):
        rel = os.path.relpath(fp, root).replace(os.sep, "/")
        with open(fp, "r", encoding="utf-8") as fh:
            sources[rel] = fh.read()
    proj = Project.build(sources, trace_roots=config.trace_roots)
    # the CONFIGURED registry module wins; Project.build's own scan (the
    # first */faults.py it happens to see) is only a fallback for callers
    # with no root/config to read from
    configured = _load_fault_registry_file(root, config)
    if configured is not None:
        proj.fault_points = configured
    return proj


def lint_paths(
    paths: Optional[Sequence[str]] = None,
    root: str = ".",
    config: Optional[LintConfig] = None,
    project: Optional[Project] = None,
) -> List[Finding]:
    config = config or load_config(root)
    if project is None:
        project = build_project(paths, root, config)
    # `paths` bounds what gets LINTED even when a (possibly broader)
    # project supplies the cross-file facts — an incremental caller may
    # build the whole-repo project but lint one changed file
    findings: List[Finding] = []
    for fp in _iter_py_files(paths or config.paths, config.exclude, root):
        rel = os.path.relpath(fp, root).replace(os.sep, "/")
        minfo = project.by_path.get(rel)
        if minfo is not None:
            findings.extend(lint_source(minfo.src, rel, config, project=project))
        else:
            # not in the project: unparsable (E000) or outside its scan
            findings.extend(lint_file(fp, config, root, project=project))
    return findings


def harvested_mesh_axes(
    root: str = ".",
    config: Optional[LintConfig] = None,
    project: Optional[Project] = None,
) -> frozenset:
    """The R015 mesh-axis registry, exported for cross-tool consumers.

    ONE source of truth for "which axis names exist in this project":
    every axis-name literal harvested from the project's own
    mesh-constructing calls (`Project._collect_mesh_axes`) plus the
    ``[tool.distlint] known_mesh_axes`` extras. A program-plane
    consumer reads this set instead of re-harvesting, so two planes can
    never drift onto two different registries."""
    config = config or load_config(root)
    if project is None:
        project = build_project(None, root, config)
    return frozenset(project.mesh_axes) | frozenset(config.known_mesh_axes)


# ---------------------------------------------------------------------------
# baseline & reporting — shared toolchain in tools/_lintcore.py
# ---------------------------------------------------------------------------
# baseline_entries / load_baseline / apply_baseline / write_baseline /
# render_report are imported (and re-exported) verbatim; render_sarif
# keeps a thin wrapper here so a bare `render_sarif(findings)` still
# emits the distlint driver block (RULES) by default.


def render_sarif(
    findings: List[Finding],
    show_suppressed: bool = False,
    baseline_mode: Optional[bool] = None,
    tool_name: str = "distlint",
    rules: Optional[Dict[str, str]] = None,
    information_uri: Optional[str] = None,
    fingerprint_key: str = "distlint/v1",
) -> Dict:
    """SARIF 2.1.0 via `_lintcore.render_sarif`, defaulting the driver
    block to distlint's own RULES."""
    return _render_sarif_core(
        findings,
        show_suppressed=show_suppressed,
        baseline_mode=baseline_mode,
        tool_name=tool_name,
        rules=RULES if rules is None else rules,
        information_uri=information_uri,
        fingerprint_key=fingerprint_key,
    )


# ---------------------------------------------------------------------------
# --fix: R004 autofixer
# ---------------------------------------------------------------------------


def apply_fixes(
    findings: List[Finding], root: str = ".", dry_run: bool = False
) -> Tuple[int, str]:
    """Forward the group parameter at every fixable R004 site.

    Returns (number of edits, unified diff). With ``dry_run`` nothing is
    written. Only unsuppressed R004 findings that carry fix metadata
    (direct collective calls, or helper calls whose callee's group
    parameter name resolved unambiguously) are rewritten."""
    import difflib

    by_path: Dict[str, List[Finding]] = {}
    for f in findings:
        if f.rule != "R004" or f.suppressed:
            continue
        if getattr(f, "_fix", None) is None:
            continue
        by_path.setdefault(f.path, []).append(f)
    n_edits = 0
    diffs: List[str] = []
    for rel, fs in sorted(by_path.items()):
        fp = os.path.join(root, rel)
        with open(fp, "r", encoding="utf-8") as fh:
            src = fh.read()
        lines = src.splitlines(keepends=True)
        # apply bottom-up so earlier positions stay valid
        for f in sorted(fs, key=lambda f: f._fix[:2], reverse=True):  # type: ignore[attr-defined]
            end_line, end_col, kw, param = f._fix  # type: ignore[attr-defined]
            if not (0 < end_line <= len(lines)):
                continue
            line = lines[end_line - 1]
            pos = end_col - 1  # the closing paren
            if pos < 0 or pos >= len(line) or line[pos] != ")":
                continue
            insert = _fix_insert_text(lines, end_line, pos, kw, param)
            lines[end_line - 1] = line[:pos] + insert + line[pos:]
            n_edits += 1
        fixed = "".join(lines)
        if fixed != src:
            diffs.append(
                "".join(
                    difflib.unified_diff(
                        src.splitlines(keepends=True),
                        fixed.splitlines(keepends=True),
                        fromfile=f"a/{rel}",
                        tofile=f"b/{rel}",
                    )
                )
            )
            if not dry_run:
                with open(fp, "w", encoding="utf-8") as fh:
                    fh.write(fixed)
    return n_edits, "".join(diffs)


def _fix_insert_text(
    lines: List[str], end_line: int, paren_pos: int, kw: str, param: str
) -> str:
    """``kw=param`` with the right separator for the call's last REAL
    token. Tokenizes the prefix so trailing comments (``x,  # why``) and
    ``#`` inside string literals can't fool the separator choice."""
    last = _last_code_token(lines, end_line, paren_pos)
    if last == "(":
        return f"{kw}={param}"
    if last == ",":
        return f" {kw}={param}"
    return f", {kw}={param}"


def _last_code_token(lines: List[str], end_line: int, paren_pos: int) -> str:
    """String of the last non-comment token before (end_line, paren_pos)."""
    prefix = "".join(lines[: end_line - 1]) + lines[end_line - 1][:paren_pos]
    last = ""
    try:
        for tok in tokenize.generate_tokens(io.StringIO(prefix).readline):
            if tok.type in (
                tokenize.COMMENT,
                tokenize.NL,
                tokenize.NEWLINE,
                tokenize.INDENT,
                tokenize.DEDENT,
                tokenize.ENCODING,
            ):
                continue
            if tok.string:
                last = tok.string
    except (tokenize.TokenError, IndentationError):
        # the prefix ends mid-call, so an unterminated-bracket TokenError
        # is EXPECTED at EOF — tokens seen before it are still valid
        pass
    return last


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="distlint",
        description=(
            "the port's interprocedural collective-divergence + trace "
            "static analyzer (rules R001-R011, R013-R015)"
        ),
    )
    ap.add_argument("paths", nargs="*", help="files/dirs to lint (default: config paths)")
    ap.add_argument(
        "--root", default=".",
        help=f"repo root (the config is <root>/{CONFIG_PATH})",
    )
    ap.add_argument(
        "--format", choices=("human", "json", "sarif"), default="human",
        help="report format",
    )
    ap.add_argument(
        "--json", action="store_true", help="alias for --format json"
    )
    ap.add_argument(
        "--explain", metavar="RULE",
        help="print one rule's description (a not-owed rule fails with "
        "its reason)",
    )
    ap.add_argument("--baseline", help="baseline file: grandfather known findings")
    ap.add_argument(
        "--update-baseline", action="store_true",
        help="rewrite the baseline from current findings (never grows it)",
    )
    ap.add_argument(
        "--force-baseline-growth", action="store_true",
        help="allow --update-baseline to add entries (ratchet override)",
    )
    ap.add_argument("--fix", action="store_true", help="apply R004 autofixes in place")
    ap.add_argument(
        "--fix-diff", action="store_true",
        help="print the R004 autofix diff without writing",
    )
    ap.add_argument("--show-suppressed", action="store_true")
    ap.add_argument("--show-baselined", action="store_true")
    ap.add_argument(
        "--no-config", action="store_true",
        help=f"ignore [tool.distlint] in {CONFIG_PATH}",
    )
    args = ap.parse_args(argv)
    fmt = "json" if args.json else args.format
    if args.explain:
        try:
            print(explain_rule(args.explain))
        except NotOwedRuleError as e:
            print(f"distlint: {e}", file=sys.stderr)
            return 2
        except KeyError:
            print(f"distlint: unknown rule {args.explain}", file=sys.stderr)
            return 2
        return 0
    if args.update_baseline and not args.baseline:
        # silently linting-without-writing here would strand users the
        # stale-entry hint sent to --update-baseline in the first place
        print(
            "distlint: --update-baseline requires --baseline FILE",
            file=sys.stderr,
        )
        return 2
    try:
        config = LintConfig() if args.no_config else load_config(args.root)
    except ValueError as e:
        print(f"distlint: {e}", file=sys.stderr)
        return 2
    try:
        findings = lint_paths(args.paths or None, args.root, config)
    except OSError as e:
        print(f"distlint: {e}", file=sys.stderr)
        return 2

    if args.fix or args.fix_diff:
        n, diff = apply_fixes(findings, args.root, dry_run=args.fix_diff)
        if args.fix_diff:
            print(diff, end="")
            print(f"distlint --fix-diff: {n} fixable R004 site(s)", file=sys.stderr)
            return 0
        print(f"distlint --fix: rewrote {n} R004 site(s)", file=sys.stderr)
        # re-lint so the report reflects the fixed tree
        findings = lint_paths(args.paths or None, args.root, config)

    stale_entries: List[Dict] = []
    if args.baseline:
        try:
            baseline = load_baseline(args.baseline)
        except FileNotFoundError:
            baseline = {"findings": []}
        except (OSError, ValueError) as e:
            print(f"distlint: {e}", file=sys.stderr)
            return 2
        new, matched, stale_entries = apply_baseline(findings, baseline)
        if args.update_baseline:
            try:
                n = write_baseline(
                    args.baseline, findings,
                    allow_growth=args.force_baseline_growth,
                )
            except ValueError as e:
                print(f"distlint: {e}", file=sys.stderr)
                return 2
            print(f"distlint: baseline updated ({n} entries)", file=sys.stderr)

    if fmt == "json":
        print(json.dumps([f.to_dict() for f in findings], indent=2))
    elif fmt == "sarif":
        print(
            json.dumps(
                render_sarif(
                    findings,
                    args.show_suppressed,
                    baseline_mode=bool(args.baseline),
                ),
                indent=2,
            )
        )
    else:
        print(render_report(findings, args.show_suppressed, args.show_baselined))
    if stale_entries:
        print(
            f"distlint: {len(stale_entries)} stale baseline entr"
            f"{'y' if len(stale_entries) == 1 else 'ies'} (fixed findings "
            "still grandfathered) — run --update-baseline to shrink the "
            "ratchet",
            file=sys.stderr,
        )
    active = [
        f for f in findings
        if not f.suppressed and not f.baselined and f.severity == "error"
    ]
    return 1 if active else 0


if __name__ == "__main__":
    sys.exit(main())
