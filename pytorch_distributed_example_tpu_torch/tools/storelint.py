"""storelint — the port's coordination-plane analyzer for its store
protocols.

The port of the reference's `tools/storelint.py`, pointed at
`pytorch_distributed_example_tpu_torch/`. distlint reads the source and
the runtime guards read the collectives; neither looks at the store
coordination protocols, where a ledger race (the head counter bumped
before the item body landed, so a scanning worker swept past the seq
forever) lives. storelint makes that plane checkable, in two halves
that share one protocol model:

**(a) Static key-space analysis.** Every store key expression in the
project (literals, f-strings, ``PrefixStore`` prefixes, module-const
composition, helper functions like ``_item_key(seq)`` — resolved
through distlint's interprocedural module/call-graph machinery) is
harvested into a producer/consumer registry per key FAMILY, the
normalized template with format holes erased
(``serve/work/item/{seq}`` → segments ``serve/work/item/*``). Rules
over the registry:

  S001  key family waited on but never written anywhere in the
        project (hang-at-wait)
  S002  key family written but never read, waited on, or deleted
        (dead coordination / store leak)
  S003  producer↔consumer format skew inside one family — a writer
        and reader share a literal base but disagree on segment count
        or hole positions, so they can never meet
  S004  generation-scoping mismatch — one side of a family is scoped
        by a gen/round/seq-style segment and the other is not
  S005  retained key family: an unbounded (holed) family of keys is
        produced but no delete/GC path anywhere in the project can
        reclaim it
  S006  ``compare_set`` claim raced with no rescan loop
  S007  ordered-publish violation — a counter/head key written before
        its holed payload key on the same path (the ledger-race class;
        flow-sensitive within the publishing function, with an
        allocator exemption when the counter's ``add`` result flows
        into the payload op)

**(b) Exhaustive interleaving checking.** ``storelint --explore`` runs
the port's REAL protocol functions — the ledger publish/claim scan
(`serve/worker.py`: `GangRouter.submit` / `ServeWorker._claim_available`),
the drain→seal→restore leader election (`ServeWorker._restore_geometry`
over `serve/elastic.save_serve_state` planes of `serve/queue.Request`
rows), the resize-target stamp/act/consume path (`elastic/agent.py`),
and the ``serve/done`` idempotent completion — against an in-memory
model of the port's `Store` API (`store.py`) under a controlled
scheduler that enumerates interleavings of 2–3 actors to a bounded
depth. Branching is conflict-driven (a DPOR-style backward dependency
analysis), each actor gets its own virtual clock, and protocol
invariants are asserted at quiescence: no lost seq, at most one restore
leader per generation, claims never double-granted, every non-done rid
merged on restore. ``--seed-revert pr16`` zeroes the worker's
missing-grace window (the consumer-side fix of the ledger race), and
the explorer must print the lost-seq interleaving as a per-actor step
schedule.

Ships with distlint's toolchain: human/json/SARIF output via the shared
renderers, the content-fingerprinted ratchet
(`pytorch_distributed_example_tpu_torch/tools/baselines/storelint.json`,
held at zero entries), ``# storelint: disable=Sxxx -- reason``
suppressions (comments only), and ``[tool.storelint]`` in
`pytorch_distributed_example_tpu_torch/tools/lint.toml` for the
key-family registry seams (paths, retained families, external
producers and consumers).

Known static-model limits (documented, deliberate): templates whose
every segment is a hole (``f"{rnd}/{rank}"`` schedule rounds, the
``PrefixStore._k`` plumbing) carry no family information and are
dropped as opaque rather than unified with everything; cross-object
prefix threading (a PrefixStore handed to another component) is not
modeled — both sides of such a protocol harvest the same unprefixed
template, so they still pair up.
"""

from __future__ import annotations

import argparse
import ast
import contextlib
import fnmatch
import hashlib
import json
import re
import sys
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, FrozenSet, List, Optional, Sequence, Set, Tuple

from ._lintcore import (
    CONFIG_PATH,
    Finding,
    apply_baseline,
    load_baseline,
    load_config_section,
    parse_severity_table,
    parse_suppressions,
    render_report,
    render_sarif,
    write_baseline,
)
from .distlint import ModuleInfo, Project, build_project
from .distlint import LintConfig as _DistlintConfig
from .distlint import _SCOPE_FIELD_RE, _store_like_receiver

__all__ = [
    "RULES",
    "StorelintConfig",
    "load_config",
    "KeyUsage",
    "Registry",
    "collect_registry",
    "run_rules",
    "lint",
    "ModelStore",
    "StoreTimeout",
    "Scheduler",
    "Scenario",
    "ExploreReport",
    "explore",
    "render_trace",
    "SCENARIOS",
    "run_scenarios",
    "main",
]

RULES = {
    "S001": "key family waited on but never written anywhere "
            "(hang-at-wait)",
    "S002": "key family written but never read, waited on, or deleted "
            "(dead coordination / store leak)",
    "S003": "producer/consumer format skew within a key family "
            "(segment count or hole positions disagree)",
    "S004": "generation-scoping mismatch within a key family "
            "(one side scoped, the other not)",
    "S005": "retained key family: unbounded keys produced with no "
            "reachable delete/GC path",
    "S006": "compare_set claim raced without a rescan loop",
    "S007": "ordered-publish violation: counter key written before "
            "its payload key (ledger-race class)",
}

_INFO_URI = "pytorch_distributed_example_tpu_torch/tools/storelint.py"

# Store-op method names → (op kind, key argument position).
_STORE_OPS = {
    "set": "write",
    "add": "write",  # amount 0 → read (value probe), see _classify_add
    "get": "read",
    "check": "read",
    "wait": "wait",
    "compare_set": "cas",
    "delete_key": "delete",
}

# Store constructor names whose bound locals become store receivers.
_STORE_CTORS = ("TCPStore", "HashStore", "FileStore", "PrefixStore")

# Final-segment names that mark a counter/head key for S007.
_COUNTER_SEG_RE = re.compile(
    r"(^|_)(head|count|counter|len|size|seq|high|total|latest|tail)(_|$)",
    re.IGNORECASE,
)

_HOLE_RE = re.compile(r"\{([A-Za-z_][A-Za-z0-9_]*)\}")

# The port package, its examples included (tests churn throwaway stores).
DEFAULT_PATHS = ["pytorch_distributed_example_tpu_torch"]
# storelint.py itself is excluded: the explorer half re-enacts the
# protocol key families as a test harness, and harvesting those would
# double-count every producer it models
DEFAULT_EXCLUDE = ["tests/", "csrc/", "tools/storelint.py"]


# ---------------------------------------------------------------------------
# config
# ---------------------------------------------------------------------------


@dataclass
class StorelintConfig:
    paths: List[str] = field(default_factory=lambda: list(DEFAULT_PATHS))
    exclude: List[str] = field(default_factory=lambda: list(DEFAULT_EXCLUDE))
    # fnmatch globs over the ERASED family text (e.g. "serve/done/*"):
    # families retained by documented contract — exempt from S005.
    retained_families: List[str] = field(default_factory=list)
    # families written/read by components outside the linted tree
    # (e.g. torch's own rendezvous keys): exempt from S001/S002.
    external_producers: List[str] = field(default_factory=list)
    external_consumers: List[str] = field(default_factory=list)
    # extra receiver NAMES treated as stores on top of the heuristic.
    store_receivers: List[str] = field(default_factory=list)
    severity: Dict[str, str] = field(default_factory=dict)

    def rule_severity(self, rule: str) -> str:
        return self.severity.get(rule, "error")


def load_config(root: str) -> StorelintConfig:
    """Read ``[tool.storelint]`` from ``<root>/CONFIG_PATH``
    (missing file/section → defaults)."""
    cfg = StorelintConfig()
    section = load_config_section(root, "storelint")
    for name in (
        "paths",
        "exclude",
        "retained_families",
        "external_producers",
        "external_consumers",
        "store_receivers",
    ):
        if name in section:
            setattr(cfg, name, [str(p) for p in section[name]])
    cfg.severity = parse_severity_table(section, "storelint")
    return cfg


# ---------------------------------------------------------------------------
# key templates
# ---------------------------------------------------------------------------
#
# A template is a tuple of parts: ("lit", text) | ("hole", name) |
# ("param", name). "param" parts are unresolved function parameters —
# expanded at call sites during the interprocedural pass, and demoted
# to holes when no caller binds them.

Part = Tuple[str, str]


def _parts_text(parts: Sequence[Part]) -> str:
    out = []
    for kind, val in parts:
        out.append(val if kind == "lit" else "{%s}" % val)
    return "".join(out)


def _segments(parts: Sequence[Part]) -> List[List[Part]]:
    """Split a template into '/'-separated segments, each a part list."""
    segs: List[List[Part]] = [[]]
    for kind, val in parts:
        if kind != "lit":
            segs[-1].append((kind, val))
            continue
        pieces = val.split("/")
        for i, piece in enumerate(pieces):
            if i:
                segs.append([])
            if piece:
                segs[-1].append(("lit", piece))
    return segs


def _erase_segment(seg: Sequence[Part]) -> str:
    """Erased form of one segment: literal text up to the first hole,
    then '*' ("gen{g}" → "gen*", "{seq}" → "*", "latest" → "latest")."""
    prefix = []
    for kind, val in seg:
        if kind == "lit":
            prefix.append(val)
        else:
            return "".join(prefix) + "*"
    return "".join(prefix)


def _seg_is_scoped(seg: Sequence[Part]) -> bool:
    """A segment is generation/round-scoped when its literal prefix or
    any hole name matches distlint's scope-field vocabulary."""
    for kind, val in seg:
        if kind == "lit" and _SCOPE_FIELD_RE.search(val):
            return True
        if kind in ("hole", "param") and _SCOPE_FIELD_RE.search(val):
            return True
    return False


def _seg_compat(a: str, b: str) -> bool:
    """Can erased segments a and b ever name the same key segment?"""
    if a == b:
        return True
    aw, bw = a.endswith("*"), b.endswith("*")
    if aw and bw:
        pa, pb = a[:-1], b[:-1]
        return pa.startswith(pb) or pb.startswith(pa)
    if aw:
        return b.startswith(a[:-1])
    if bw:
        return a.startswith(b[:-1])
    return False


def _unify(a: Sequence[str], b: Sequence[str]) -> bool:
    return len(a) == len(b) and all(
        _seg_compat(x, y) for x, y in zip(a, b)
    )


def _base_of(segs: Sequence[str]) -> str:
    """Leading fully-literal segments — the family's stable address."""
    out = []
    for s in segs:
        if s.endswith("*"):
            break
        out.append(s)
    return "/".join(out)


@dataclass
class KeyUsage:
    """One store operation on one (possibly expanded) key template."""

    path: str
    line: int
    col: int
    func: str  # FunctionInfo.display of the op site
    raw_op: str  # set / add / get / check / wait / compare_set / delete_key
    op: str  # write / read / wait / cas / delete
    parts: Tuple[Part, ...]
    text: str  # rendered with hole names: "serve/work/item/{seq}"
    segs: Tuple[str, ...]  # erased segments: ("serve","work","item","*")
    base: str
    in_loop: bool
    arg_names: FrozenSet[str]  # bare Names in the whole op call
    alloc_names: FrozenSet[str]  # assign targets of an `add` result
    scoped: bool = False

    def __post_init__(self) -> None:
        self.scoped = any(
            _seg_is_scoped(seg) for seg in _segments(self.parts)
        )

    def describe(self) -> str:
        return f"{self.raw_op}({self.text}) at {self.path}:{self.line}"


@dataclass
class Registry:
    """The project-wide producer/consumer registry of key usages."""

    usages: List[KeyUsage] = field(default_factory=list)
    opaque: int = 0  # templates dropped for carrying no literal text

    def select(
        self, op: Optional[str] = None, pattern: Optional[str] = None
    ) -> List[KeyUsage]:
        out = []
        for u in self.usages:
            if op is not None and u.op != op:
                continue
            if pattern is not None and not fnmatch.fnmatch(
                "/".join(u.segs), pattern
            ):
                continue
            out.append(u)
        return out


# ---------------------------------------------------------------------------
# expression → template evaluation
# ---------------------------------------------------------------------------


@dataclass
class _EvalCtx:
    project: Project
    minfo: ModuleInfo
    cls: Optional[str]
    params: Set[str]  # declared parameter names of the enclosing func
    locals: Dict[str, ast.expr]  # simple single-target assignments
    forced_holes: Set[str]  # comprehension targets etc.
    depth: int = 0

    _MAX_DEPTH = 6


def _const_lookup(ctx: _EvalCtx, name: str) -> Optional[str]:
    """Module-level string constant, chasing from-import re-exports."""
    if name in ctx.minfo.consts:
        return ctx.minfo.consts[name]
    tgt = ctx.minfo.from_imports.get(name)
    seen = 0
    while tgt is not None and seen < 8:
        mod, orig = tgt
        m = ctx.project.modules.get(mod)
        if m is None:
            return None
        if orig in m.consts:
            return m.consts[orig]
        tgt = m.from_imports.get(orig)
        seen += 1
    return None


def _parse_format_holes(text: str) -> List[Part]:
    """Split a literal containing {name} markers into lit/hole parts."""
    parts: List[Part] = []
    pos = 0
    for m in _HOLE_RE.finditer(text):
        if m.start() > pos:
            parts.append(("lit", text[pos : m.start()]))
        parts.append(("hole", m.group(1)))
        pos = m.end()
    if pos < len(text):
        parts.append(("lit", text[pos:]))
    return parts or [("lit", "")]


def _eval_parts(expr: ast.expr, ctx: _EvalCtx) -> List[Part]:
    """Best-effort template of a key expression. Never raises; unknown
    subexpressions become anonymous holes."""
    if ctx.depth > ctx._MAX_DEPTH:
        return [("hole", "?")]
    if isinstance(expr, ast.Constant):
        if isinstance(expr.value, str):
            return [("lit", expr.value)]
        return [("hole", "?")]
    if isinstance(expr, ast.Name):
        name = expr.id
        if name in ctx.forced_holes:
            return [("hole", name)]
        if name in ctx.locals:
            sub = _EvalCtx(
                ctx.project, ctx.minfo, ctx.cls, ctx.params,
                dict(ctx.locals), set(ctx.forced_holes), ctx.depth + 1,
            )
            del sub.locals[name]  # cycle guard
            return _eval_parts(ctx.locals[name], sub)
        if name in ctx.params:
            return [("param", name)]
        const = _const_lookup(ctx, name)
        if const is not None:
            return [("lit", const)]
        return [("hole", name)]
    if isinstance(expr, ast.Attribute):
        return [("hole", expr.attr)]
    if isinstance(expr, ast.JoinedStr):
        parts: List[Part] = []
        for v in expr.values:
            if isinstance(v, ast.Constant) and isinstance(v.value, str):
                parts.append(("lit", v.value))
            elif isinstance(v, ast.FormattedValue):
                sub = _EvalCtx(
                    ctx.project, ctx.minfo, ctx.cls, ctx.params,
                    ctx.locals, ctx.forced_holes, ctx.depth + 1,
                )
                inner = _eval_parts(v.value, sub)
                # a const that resolved to literal text may itself
                # carry {name} markers (format-template consts)
                for kind, val in inner:
                    if kind == "lit" and "{" in val:
                        parts.extend(_parse_format_holes(val))
                    else:
                        parts.append((kind, val))
            else:
                parts.append(("hole", "?"))
        return parts
    if isinstance(expr, ast.BinOp) and isinstance(expr.op, ast.Add):
        sub = _EvalCtx(
            ctx.project, ctx.minfo, ctx.cls, ctx.params,
            ctx.locals, ctx.forced_holes, ctx.depth + 1,
        )
        return _eval_parts(expr.left, sub) + _eval_parts(expr.right, sub)
    if isinstance(expr, ast.Call):
        return _eval_call(expr, ctx)
    return [("hole", "?")]


def _single_return(node: ast.AST) -> Optional[ast.expr]:
    """The sole `return <expr>` of a helper body, or None."""
    rets = [
        n for n in ast.walk(node)
        if isinstance(n, ast.Return) and n.value is not None
    ]
    return rets[0].value if len(rets) == 1 else None


def _eval_call(call: ast.Call, ctx: _EvalCtx) -> List[Part]:
    # "...".format(**kw) / CONST.format(**kw)
    if (
        isinstance(call.func, ast.Attribute)
        and call.func.attr == "format"
    ):
        sub = _EvalCtx(
            ctx.project, ctx.minfo, ctx.cls, ctx.params,
            ctx.locals, ctx.forced_holes, ctx.depth + 1,
        )
        recv = _eval_parts(call.func.value, sub)
        if all(k == "lit" for k, _ in recv):
            tmpl = _parse_format_holes("".join(v for _, v in recv))
            binds: Dict[str, List[Part]] = {}
            for kw in call.keywords:
                if kw.arg:
                    binds[kw.arg] = _eval_parts(kw.value, sub)
            out: List[Part] = []
            for kind, val in tmpl:
                if kind == "hole" and val in binds:
                    out.extend(binds[val])
                else:
                    out.append((kind, val))
            return out
        return [("hole", "?")]
    # str(x) / x.encode() wrappers are value-side; keys never use them —
    # anything else: try inlining a project helper with a single return
    targets = ctx.project.resolve_call(ctx.minfo, ctx.cls, call)
    if len(targets) == 1:
        t = targets[0]
        ret = _single_return(t.node)
        if ret is not None:
            callee_mod = ctx.project.modules.get(t.module)
            if callee_mod is not None:
                binds = _bind_call_args(call, t.node, t.cls, ctx)
                sub = _EvalCtx(
                    ctx.project, callee_mod, t.cls,
                    set(), dict(binds), set(), ctx.depth + 1,
                )
                return _eval_parts(ret, sub)
    return [("hole", "?")]


def _bind_call_args(
    call: ast.Call, fnode: ast.AST, cls: Optional[str], ctx: _EvalCtx
) -> Dict[str, ast.expr]:
    """Map callee parameter names → caller arg expressions (positional
    + keyword + string-constant defaults). Unbound params are simply
    absent (they evaluate as holes in the callee)."""
    args = fnode.args
    pos = [a.arg for a in (args.posonlyargs + args.args)]
    if cls is not None and pos and pos[0] in ("self", "cls"):
        pos = pos[1:]
    binds: Dict[str, ast.expr] = {}
    # defaults first (rightmost params), overridden by explicit args
    all_named = args.posonlyargs + args.args
    defaults = args.defaults
    for prm, dflt in zip(all_named[len(all_named) - len(defaults):], defaults):
        binds[prm.arg] = dflt
    for prm, dflt in zip(args.kwonlyargs, args.kw_defaults):
        if dflt is not None:
            binds[prm.arg] = dflt
    for i, a in enumerate(call.args):
        if i < len(pos) and not isinstance(a, ast.Starred):
            binds[pos[i]] = a
    for kw in call.keywords:
        if kw.arg:
            binds[kw.arg] = kw.value
    return binds


# ---------------------------------------------------------------------------
# per-function harvest
# ---------------------------------------------------------------------------


@dataclass
class _RawOp:
    """A store op before interprocedural param expansion."""

    path: str
    line: int
    col: int
    func_qual: str  # module:name
    func_disp: str
    raw_op: str
    op: str
    parts: List[Part]
    in_loop: bool
    arg_names: FrozenSet[str]
    alloc_names: FrozenSet[str]


@dataclass
class _CallBinding:
    """caller → callee argument-template binding for expansion."""

    caller_qual: str
    callee_qual: str
    binds: Dict[str, List[Part]]


def _names_in(expr: ast.AST) -> Set[str]:
    return {n.id for n in ast.walk(expr) if isinstance(n, ast.Name)}


def _classify(attr: str, call: ast.Call) -> Tuple[str, str]:
    """(raw_op, op kind), downgrading `add` with a constant-0 amount to
    a read (the repo's value-probe idiom: `head = add(KEY, 0)`)."""
    kind = _STORE_OPS[attr]
    if attr == "add":
        amount = None
        if len(call.args) >= 2 and isinstance(call.args[1], ast.Constant):
            amount = call.args[1].value
        for kw in call.keywords:
            if kw.arg == "amount" and isinstance(kw.value, ast.Constant):
                amount = kw.value.value
        if amount == 0:
            kind = "read"
    return attr, kind


class _FuncHarvester:
    """Walk one function body collecting store ops and call bindings."""

    def __init__(
        self,
        project: Project,
        minfo: ModuleInfo,
        fq: str,
        disp: str,
        cls: Optional[str],
        node: ast.AST,
        config: StorelintConfig,
    ) -> None:
        self.project = project
        self.minfo = minfo
        self.fq = fq
        self.disp = disp
        self.cls = cls
        self.node = node
        self.config = config
        self.ops: List[_RawOp] = []
        self.bindings: List[_CallBinding] = []
        self.locals: Dict[str, ast.expr] = {}
        self.prefix_stores: Dict[str, List[Part]] = {}
        self.store_locals: Set[str] = set()
        args = node.args
        self.params = {
            a.arg
            for a in (
                args.posonlyargs + args.args + args.kwonlyargs
            )
            if a.arg not in ("self", "cls")
        }
        self._loop_depth = 0

    # -- receiver classification ------------------------------------

    def _is_store_recv(self, expr: ast.expr) -> bool:
        if isinstance(expr, ast.Name):
            if expr.id in self.store_locals or expr.id in self.prefix_stores:
                return True
            if expr.id in self.config.store_receivers:
                return True
        return _store_like_receiver(expr, self.cls)

    def _ctx(self) -> _EvalCtx:
        return _EvalCtx(
            self.project, self.minfo, self.cls,
            self.params, self.locals, set(),
        )

    # -- traversal ---------------------------------------------------

    def harvest(self) -> None:
        for stmt in self.node.body:
            self._stmt(stmt)

    def _stmt(self, stmt: ast.stmt) -> None:
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
            return  # nested defs are harvested as their own functions
        if isinstance(stmt, ast.Assign) and len(stmt.targets) == 1:
            tgt = stmt.targets[0]
            if isinstance(tgt, ast.Name):
                self._record_assign(tgt.id, stmt.value)
        elif isinstance(stmt, ast.AnnAssign) and stmt.value is not None:
            if isinstance(stmt.target, ast.Name):
                self._record_assign(stmt.target.id, stmt.value)
        loops = isinstance(stmt, (ast.For, ast.AsyncFor, ast.While))
        if loops:
            self._loop_depth += 1
        for child in ast.iter_child_nodes(stmt):
            if isinstance(child, ast.stmt):
                self._stmt(child)
            else:
                self._expr_scan(child)
        if loops:
            self._loop_depth -= 1

    def _record_assign(self, name: str, value: ast.expr) -> None:
        self.locals[name] = value
        if isinstance(value, ast.Call):
            cname = None
            f = value.func
            if isinstance(f, ast.Name):
                cname = f.id
            elif isinstance(f, ast.Attribute):
                cname = f.attr
            if cname in _STORE_CTORS:
                self.store_locals.add(name)
                if cname == "PrefixStore" and value.args:
                    self.prefix_stores[name] = _eval_parts(
                        value.args[0], self._ctx()
                    )

    def _expr_scan(self, node: ast.AST) -> None:
        for sub in ast.walk(node):
            if isinstance(sub, ast.Call):
                self._call(sub)

    # -- op + binding extraction ------------------------------------

    def _call(self, call: ast.Call) -> None:
        f = call.func
        if (
            isinstance(f, ast.Attribute)
            and f.attr in _STORE_OPS
            and self._is_store_recv(f.value)
        ):
            self._store_op(call, f)
            return
        # non-store call: record interprocedural arg bindings so ops
        # with param parts can be expanded at this call site
        targets = self.project.resolve_call(self.minfo, self.cls, call)
        if len(targets) == 1:
            t = targets[0]
            raw = _bind_call_args(call, t.node, t.cls, self._ctx())
            ctx = self._ctx()
            binds = {k: _eval_parts(v, ctx) for k, v in raw.items()}
            self.bindings.append(
                _CallBinding(self.fq, t.qualname, binds)
            )

    def _key_exprs(self, call: ast.Call, attr: str) -> List[ast.expr]:
        if not call.args:
            return []
        arg = call.args[0]
        if attr in ("check", "wait"):
            if isinstance(arg, (ast.List, ast.Tuple)):
                return list(arg.elts)
            if isinstance(arg, ast.Name) and arg.id in self.locals:
                bound = self.locals[arg.id]
                if isinstance(bound, (ast.List, ast.Tuple)):
                    return list(bound.elts)
                if isinstance(bound, ast.ListComp):
                    return [bound]  # handled as comp in _one_key
            if isinstance(arg, ast.ListComp):
                return [arg]
        return [arg]

    def _one_key(self, expr: ast.expr) -> List[Part]:
        ctx = self._ctx()
        if isinstance(expr, ast.ListComp):
            for gen in expr.generators:
                ctx.forced_holes.update(_names_in(gen.target))
            return _eval_parts(expr.elt, ctx)
        return _eval_parts(expr, ctx)

    def _store_op(self, call: ast.Call, f: ast.Attribute) -> None:
        raw_op, kind = _classify(f.attr, call)
        prefix: List[Part] = []
        if isinstance(f.value, ast.Name) and f.value.id in self.prefix_stores:
            prefix = list(self.prefix_stores[f.value.id]) + [("lit", "/")]
        arg_names = frozenset(
            n
            for a in list(call.args) + [kw.value for kw in call.keywords]
            for n in _names_in(a)
        )
        alloc: FrozenSet[str] = frozenset()
        if raw_op == "add":
            parent = getattr(call, "_storelint_assign", None)
            if parent:
                alloc = frozenset(parent)
        for key_expr in self._key_exprs(call, f.attr):
            parts = prefix + self._one_key(key_expr)
            self.ops.append(
                _RawOp(
                    path=self.minfo.path,
                    line=call.lineno,
                    col=call.col_offset,
                    func_qual=self.fq,
                    func_disp=self.disp,
                    raw_op=raw_op,
                    op=kind,
                    parts=parts,
                    in_loop=self._loop_depth > 0,
                    arg_names=arg_names,
                    alloc_names=alloc,
                )
            )


# ---------------------------------------------------------------------------
# project harvest + interprocedural expansion
# ---------------------------------------------------------------------------


def _mark_add_assigns(tree: ast.Module) -> None:
    """Annotate `x = store.add(...)` calls with their assign targets so
    the S007 allocator exemption can follow the seq dataflow."""
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign) and isinstance(node.value, ast.Call):
            call = node.value
            f = call.func
            if isinstance(f, ast.Attribute) and f.attr == "add":
                names = [
                    t.id for t in node.targets if isinstance(t, ast.Name)
                ]
                if names:
                    call._storelint_assign = names  # type: ignore[attr-defined]


def _has_params(parts: Sequence[Part]) -> bool:
    return any(k == "param" for k, _ in parts)


def _demote_params(parts: Sequence[Part]) -> Tuple[Part, ...]:
    return tuple(
        ("hole", v) if k == "param" else (k, v) for k, v in parts
    )


def _expand_parts(
    parts: Sequence[Part],
    fq: str,
    callins: Dict[str, List[_CallBinding]],
    depth: int = 5,
    limit: int = 64,
) -> List[Tuple[Part, ...]]:
    """All call-site expansions of a param-holding template (bounded);
    leftover params demote to holes."""
    if not _has_params(parts):
        return [tuple(parts)]
    bindings = callins.get(fq, [])
    if depth <= 0 or not bindings:
        return [_demote_params(parts)]
    out: List[Tuple[Part, ...]] = []
    for b in bindings:
        sub: List[Part] = []
        for kind, val in parts:
            if kind == "param":
                bound = b.binds.get(val)
                if bound is not None:
                    sub.extend(bound)
                else:
                    sub.append(("hole", val))
            else:
                sub.append((kind, val))
        out.extend(
            _expand_parts(sub, b.caller_qual, callins, depth - 1, limit)
        )
        if len(out) >= limit:
            break
    return out[:limit] or [_demote_params(parts)]


def collect_registry(
    root: str = ".",
    config: Optional[StorelintConfig] = None,
    project: Optional[Project] = None,
) -> Tuple[Registry, Project]:
    """Harvest every store key usage in the configured paths into the
    producer/consumer registry (the shared protocol model)."""
    config = config or load_config(root)
    if project is None:
        dcfg = _DistlintConfig(
            paths=list(config.paths), exclude=list(config.exclude)
        )
        project = build_project(config.paths, root, dcfg)
    raw_ops: List[_RawOp] = []
    callins: Dict[str, List[_CallBinding]] = {}
    for minfo in project.modules.values():
        _mark_add_assigns(minfo.tree)
        for fi in minfo.functions.values():
            h = _FuncHarvester(
                project, minfo, fi.qualname, fi.display, fi.cls,
                fi.node, config,
            )
            h.harvest()
            raw_ops.extend(h.ops)
            for b in h.bindings:
                callins.setdefault(b.callee_qual, []).append(b)
    reg = Registry()
    seen: Set[Tuple[str, int, str, str, str]] = set()
    for op in raw_ops:
        for parts in _expand_parts(op.parts, op.func_qual, callins):
            segs = tuple(_erase_segment(s) for s in _segments(parts))
            if not any(s != "*" for s in segs):
                reg.opaque += 1  # no literal anywhere: plumbing, drop
                continue
            text = _parts_text(parts)
            key = (op.path, op.line, op.raw_op, text, op.op)
            if key in seen:
                continue
            seen.add(key)
            reg.usages.append(
                KeyUsage(
                    path=op.path,
                    line=op.line,
                    col=op.col,
                    func=op.func_disp,
                    raw_op=op.raw_op,
                    op=op.op,
                    parts=tuple(parts),
                    text=text,
                    segs=segs,
                    base=_base_of(segs),
                    in_loop=op.in_loop,
                    arg_names=op.arg_names,
                    alloc_names=op.alloc_names,
                )
            )
    reg.usages.sort(key=lambda u: (u.path, u.line, u.col, u.text))
    return reg, project


# ---------------------------------------------------------------------------
# rules
# ---------------------------------------------------------------------------


def _matches_any(segs: Sequence[str], globs: Sequence[str]) -> bool:
    flat = "/".join(segs)
    return any(fnmatch.fnmatch(flat, g) for g in globs)


def _skew_or_scope(
    u: KeyUsage, others: List[KeyUsage]
) -> Optional[Tuple[str, KeyUsage]]:
    """When `u` found no unifiable counterpart but shares a literal
    base with one, classify the pair: S004 if exactly one side carries
    a scope segment, S003 otherwise."""
    if not u.base:
        return None
    cands = [o for o in others if o.base and o.base == u.base]
    if not cands:
        return None
    # nearest by segment-count distance → the most plausible intended pair
    other = min(cands, key=lambda o: abs(len(o.segs) - len(u.segs)))
    if u.scoped != other.scoped:
        return "S004", other
    return "S003", other


def run_rules(
    reg: Registry, config: Optional[StorelintConfig] = None
) -> List[Finding]:
    config = config or StorelintConfig()
    findings: List[Finding] = []
    pair_seen: Set[Tuple[str, frozenset]] = set()

    producers = [u for u in reg.usages if u.op in ("write", "cas")]
    readers = [u for u in reg.usages if u.op in ("read", "wait")]
    deletes = [u for u in reg.usages if u.op == "delete"]
    consumers = readers + deletes + [u for u in reg.usages if u.op == "cas"]

    def emit(rule: str, u: KeyUsage, msg: str) -> None:
        sev = config.rule_severity(rule)
        if sev == "off":
            return
        findings.append(
            Finding(
                path=u.path, line=u.line, col=u.col,
                rule=rule, message=msg, severity=sev,
            )
        )

    def emit_pair(rule: str, u: KeyUsage, other: KeyUsage) -> None:
        key = (rule, frozenset({u.text, other.text}))
        if key in pair_seen:
            return
        pair_seen.add(key)
        what = "scoping" if rule == "S004" else "format"
        emit(
            rule, u,
            f"key family {what} mismatch: '{u.text}' "
            f"({u.raw_op} in {u.func}) can never meet '{other.text}' "
            f"({other.raw_op} at {other.path}:{other.line})",
        )

    # S001 — waited on, never written
    for u in reg.usages:
        if u.op != "wait":
            continue
        if _matches_any(u.segs, config.external_producers):
            continue
        if any(_unify(u.segs, p.segs) for p in producers):
            continue
        pair = _skew_or_scope(u, producers)
        if pair:
            emit_pair(pair[0], u, pair[1])
            continue
        emit(
            "S001", u,
            f"'{u.text}' is waited on in {u.func} but never written "
            "anywhere in the project (hang-at-wait)",
        )

    # S002 — set, never read/waited/deleted (cas claims read themselves)
    flagged_s002: Set[Tuple[str, int, str]] = set()
    for u in reg.usages:
        if u.raw_op != "set":
            continue
        if _matches_any(u.segs, config.external_consumers):
            continue
        if any(_unify(u.segs, c.segs) for c in consumers):
            continue
        pair = _skew_or_scope(u, consumers)
        if pair:
            emit_pair(pair[0], u, pair[1])
            continue
        flagged_s002.add((u.path, u.line, u.text))
        emit(
            "S002", u,
            f"'{u.text}' is written in {u.func} but never read, waited "
            "on, or deleted (dead coordination / store leak)",
        )

    # S005 — unbounded family with producers but no delete path.
    # One finding per family, anchored at its first producer site.
    fams: Dict[Tuple[str, ...], List[KeyUsage]] = {}
    for p in producers + [
        u for u in reg.usages if u.raw_op == "add" and u.op == "write"
    ]:
        fams.setdefault(p.segs, []).append(p)
    for segs, fam in sorted(fams.items()):
        if not any(s.endswith("*") for s in segs):
            continue  # a bounded handful of fixed keys, not a leak
        if _matches_any(segs, config.retained_families):
            continue
        if any(_unify(segs, d.segs) for d in deletes):
            continue
        fam.sort(key=lambda u: (u.path, u.line))
        anchor = fam[0]
        if all(
            (p.path, p.line, p.text) in flagged_s002 for p in fam
        ):
            continue  # already reported dead outright by S002
        emit(
            "S005", anchor,
            f"retained key family '{anchor.text}': "
            f"{len(fam)} producer site(s) but no delete/GC path "
            "anywhere in the project",
        )

    # S006 — CAS with no rescan loop
    for u in reg.usages:
        if u.op != "cas" or u.in_loop:
            continue
        rescans = any(
            r.in_loop
            and (
                _unify(u.segs, r.segs)
                or (u.base and r.base == u.base)
            )
            for r in readers
        )
        if not rescans:
            emit(
                "S006", u,
                f"compare_set on '{u.text}' in {u.func} has no rescan "
                "loop: a lost race is never retried",
            )

    # S007 — counter written before its payload, per function
    by_func: Dict[str, List[KeyUsage]] = {}
    for u in reg.usages:
        if u.op == "write":
            by_func.setdefault(f"{u.path}:{u.func}", []).append(u)
    for ops in by_func.values():
        ops.sort(key=lambda u: (u.line, u.col))
        for i, c in enumerate(ops):
            last = c.segs[-1] if c.segs else ""
            if (
                last.endswith("*")
                or not _COUNTER_SEG_RE.search(last)
                or len(c.segs) < 2
            ):
                continue
            for p in ops[i + 1:]:
                if p.segs == c.segs:
                    continue
                if len(p.segs) < len(c.segs):
                    continue
                if not all(
                    _seg_compat(a, b)
                    for a, b in zip(c.segs[:-1], p.segs[: len(c.segs) - 1])
                ):
                    continue
                if not any(s.endswith("*") for s in p.segs):
                    continue
                if c.alloc_names and (c.alloc_names & p.arg_names):
                    continue  # allocator: the add result flows into the payload
                emit(
                    "S007", c,
                    f"counter '{c.text}' is written before its payload "
                    f"'{p.text}' ({p.path}:{p.line}) — a scanning "
                    "consumer can observe the bumped counter with no "
                    "payload behind it (ledger-race class)",
                )
                break

    findings.sort(key=lambda f: (f.path, f.line, f.col, f.rule))
    return findings


# ---------------------------------------------------------------------------
# suppression + fingerprints + lint entry
# ---------------------------------------------------------------------------


def _parse_suppressions(
    src: str,
) -> Tuple[Dict[int, Set[str]], Dict[str, int]]:
    """(line → suppressed rules, file-wide rule → declaring line);
    comments only — see `_lintcore.parse_suppressions`."""
    return parse_suppressions(src, "storelint")


def _apply_suppressions(
    findings: List[Finding], project: Project
) -> None:
    cache: Dict[str, Tuple[Dict[int, Set[str]], Dict[str, int]]] = {}
    for f in findings:
        minfo = project.by_path.get(f.path)
        if minfo is None:
            continue
        if f.path not in cache:
            cache[f.path] = _parse_suppressions(minfo.src)
        per_line, file_wide = cache[f.path]
        if f.rule in per_line.get(f.line, set()) or f.rule in file_wide:
            f.suppressed = True


def _assign_fingerprints(findings: List[Finding]) -> None:
    """Content fingerprints over (path, rule, family text) with an
    occurrence counter — stable across unrelated line moves."""
    occ: Dict[Tuple[str, str, str], int] = {}
    for f in sorted(findings, key=lambda f: (f.path, f.line, f.col)):
        fam = f.message.split("'")[1] if "'" in f.message else f.message
        key = (f.path, f.rule, fam)
        n = occ.get(key, 0)
        occ[key] = n + 1
        f.fingerprint = hashlib.sha1(
            f"{f.path}\x00{f.rule}\x00{fam}\x00{n}".encode()
        ).hexdigest()[:16]


def lint(
    root: str = ".",
    config: Optional[StorelintConfig] = None,
) -> Tuple[List[Finding], Registry]:
    """The full static half: harvest, rules, suppressions, prints."""
    config = config or load_config(root)
    reg, project = collect_registry(root, config)
    findings = run_rules(reg, config)
    _apply_suppressions(findings, project)
    _assign_fingerprints(findings)
    return findings, reg


# ---------------------------------------------------------------------------
# interleaving explorer — store model + controlled scheduler
# ---------------------------------------------------------------------------


class StoreTimeout(Exception):
    """A modeled blocking op ran past its virtual deadline."""


class _Aborted(Exception):
    """Raised inside an actor when the step budget is exhausted."""


class VirtualClock:
    """Per-actor virtual time: `sleep` advances only this actor's
    clock, so timing logic (grace windows, deadlines) is deterministic
    under every interleaving."""

    def __init__(self, start: float = 1000.0) -> None:
        self.t = float(start)


@dataclass
class _OpDesc:
    kind: str  # start / sleep / set / get / add / check / wait / cas / delete
    keys: FrozenSet[str]
    writes: bool

    def conflicts(self, other: "_OpDesc") -> bool:
        if not (self.keys & other.keys):
            return False
        return self.writes or other.writes


class _ActorCtl:
    def __init__(self, name: str, clock: VirtualClock) -> None:
        self.name = name
        self.clock = clock
        self.go = threading.Event()
        self.parked = False
        self.pending: Optional[_OpDesc] = None
        self.done = False
        self.exc: Optional[BaseException] = None
        self.thread: Optional[threading.Thread] = None


class Scheduler:
    """Lockstep scheduler: every actor parks at each store op / sleep;
    the scheduler grants exactly one actor per step. Branch candidates
    come from a backward dependency analysis (DPOR-style): when an op
    executes, the latest earlier conflicting op by ANOTHER actor marks
    a backtrack point — re-run with this actor scheduled there."""

    def __init__(self, max_steps: int = 400) -> None:
        self.max_steps = max_steps
        self.actors: List[_ActorCtl] = []
        self._by_ident: Dict[int, _ActorCtl] = {}
        self._cv = threading.Condition()
        self.schedule: List[str] = []  # actor name per executed step
        self.oplog: List[Tuple[int, str, str]] = []  # (step, actor, text)
        self.branches: List[Tuple[int, str]] = []  # (step idx, alt actor)
        self.budget_exhausted = False
        self._aborting = False
        # per-key last write/read indices for the backward analysis
        self._last_write: Dict[str, Tuple[int, str]] = {}
        self._last_reads: Dict[str, Dict[str, int]] = {}

    # -- actor side --------------------------------------------------

    def current_actor(self) -> Optional[_ActorCtl]:
        return self._by_ident.get(threading.get_ident())

    def yield_op(self, desc: _OpDesc) -> int:
        """Park until granted; returns the executed step index. A
        non-actor thread (scenario seeding) executes immediately."""
        a = self.current_actor()
        if a is None:
            return -1
        with self._cv:
            a.pending = desc
            a.parked = True
            self._cv.notify_all()
        a.go.wait()
        a.go.clear()
        if self._aborting:
            raise _Aborted()
        return len(self.schedule) - 1

    def log(self, step: int, actor: Optional[str], text: str) -> None:
        if step >= 0:
            self.oplog.append((step, actor or "?", text))

    # -- scheduler side ----------------------------------------------

    def spawn(self, name: str, fn: Callable, *args: Any) -> _ActorCtl:
        a = _ActorCtl(name, VirtualClock())
        self.actors.append(a)

        def run() -> None:
            self._by_ident[threading.get_ident()] = a
            try:
                self.yield_op(_OpDesc("start", frozenset(), False))
                fn(*args, a.clock)
            except _Aborted:
                pass
            except BaseException as e:  # recorded, surfaced as violation
                a.exc = e
            finally:
                with self._cv:
                    a.done = True
                    a.parked = False
                    self._cv.notify_all()

        a.thread = threading.Thread(target=run, daemon=True)
        return a

    def _all_settled(self) -> bool:
        return all(a.done or a.parked for a in self.actors)

    def _record_backtracks(self, step: int, a: _ActorCtl, d: _OpDesc) -> None:
        latest: Optional[int] = None
        for k in d.keys:
            lw = self._last_write.get(k)
            if lw and lw[1] != a.name:
                latest = lw[0] if latest is None else max(latest, lw[0])
            if d.writes:
                for actor, idx in self._last_reads.get(k, {}).items():
                    if actor != a.name:
                        latest = idx if latest is None else max(latest, idx)
        if latest is not None:
            self.branches.append((latest, a.name))
        for k in d.keys:
            if d.writes:
                self._last_write[k] = (step, a.name)
            else:
                self._last_reads.setdefault(k, {})[a.name] = step

    def run(self, prefix: Sequence[str] = ()) -> None:
        for a in self.actors:
            assert a.thread is not None
            a.thread.start()
        try:
            while True:
                with self._cv:
                    self._cv.wait_for(self._all_settled, timeout=30.0)
                    if not self._all_settled():
                        raise RuntimeError(
                            "storelint scheduler wedged (actor neither "
                            "parked nor done after 30s)"
                        )
                    enabled = [
                        a for a in self.actors if not a.done and a.parked
                    ]
                if not enabled:
                    return
                step = len(self.schedule)
                if step >= self.max_steps:
                    self.budget_exhausted = True
                    self._abort_all(enabled)
                    return
                chosen = enabled[0]
                if step < len(prefix):
                    for a in enabled:
                        if a.name == prefix[step]:
                            chosen = a
                            break
                desc = chosen.pending or _OpDesc("?", frozenset(), False)
                self.schedule.append(chosen.name)
                if desc.kind not in ("start", "sleep"):
                    self._record_backtracks(step, chosen, desc)
                self._grant(chosen)
        finally:
            for a in self.actors:
                if a.thread is not None and a.thread.is_alive():
                    a.thread.join(timeout=30.0)

    def _grant(self, a: _ActorCtl) -> None:
        with self._cv:
            a.parked = False
            a.pending = None
        a.go.set()

    def _abort_all(self, enabled: List[_ActorCtl]) -> None:
        self._aborting = True
        # grant each parked actor in turn; its yield raises _Aborted
        while True:
            with self._cv:
                self._cv.wait_for(self._all_settled, timeout=30.0)
                live = [a for a in self.actors if not a.done and a.parked]
            if not live:
                return
            self._grant(live[0])


class ModelStore:
    """In-memory store with HashStore-exact op semantics, every op a
    scheduler yield point. Blocking ops (get/wait) are modeled as
    bounded poll loops against the actor's virtual clock."""

    def __init__(self, sched: Scheduler, timeout: float = 5.0) -> None:
        self._sched = sched
        self._data: Dict[str, bytes] = {}
        self.timeout = float(timeout)
        self.cas_wins: Dict[str, int] = {}
        self.deleted_values: List[Tuple[str, Optional[bytes]]] = []

    # -- scheduling helpers ------------------------------------------

    def _yield(self, kind: str, keys: Set[str], writes: bool) -> int:
        return self._sched.yield_op(
            _OpDesc(kind, frozenset(keys), writes)
        )

    def _actor_name(self) -> Optional[str]:
        a = self._sched.current_actor()
        return a.name if a else None

    def _clock(self) -> Optional[VirtualClock]:
        a = self._sched.current_actor()
        return a.clock if a else None

    def _log(self, step: int, text: str) -> None:
        self._sched.log(step, self._actor_name(), text)

    # -- ops (HashStore semantics) -----------------------------------

    def set(self, key: str, value: bytes) -> None:
        step = self._yield("set", {key}, True)
        self._data[key] = bytes(value)
        self._log(step, f"set {key}")

    def add(self, key: str, amount: int) -> int:
        step = self._yield("add", {key}, True)
        cur = int(self._data.get(key, b"0")) + int(amount)
        self._data[key] = str(cur).encode()
        self._log(step, f"add {key} {amount:+d} -> {cur}")
        return cur

    def compare_set(
        self, key: str, expected: bytes, desired: bytes
    ) -> bytes:
        step = self._yield("cas", {key}, True)
        cur = self._data.get(key)
        if (cur is None and expected == b"") or cur == expected:
            self._data[key] = desired
            self.cas_wins[key] = self.cas_wins.get(key, 0) + 1
            self._log(step, f"cas {key} -> WON")
            return desired
        self._log(step, f"cas {key} -> lost")
        return cur if cur is not None else expected

    def check(self, keys: Sequence[str]) -> bool:
        step = self._yield("check", set(keys), False)
        ok = all(k in self._data for k in keys)
        self._log(step, f"check {','.join(keys)} -> {ok}")
        return ok

    def get(self, key: str) -> bytes:
        clock = self._clock()
        deadline = (clock.t if clock else 0.0) + self.timeout
        poll = max(self.timeout / 8.0, 1e-3)
        while True:
            step = self._yield("get", {key}, False)
            if key in self._data:
                self._log(step, f"get {key}")
                return self._data[key]
            self._log(step, f"get {key} (absent, polling)")
            if clock is None:
                raise StoreTimeout(key)
            clock.t += poll
            if clock.t >= deadline:
                raise StoreTimeout(key)

    def wait(self, keys: Sequence[str], timeout: Optional[float] = None) -> None:
        clock = self._clock()
        budget = float(timeout) if timeout is not None else self.timeout
        deadline = (clock.t if clock else 0.0) + budget
        poll = max(budget / 8.0, 1e-3)
        while True:
            step = self._yield("wait", set(keys), False)
            if all(k in self._data for k in keys):
                self._log(step, f"wait {','.join(keys)} -> ok")
                return
            self._log(step, f"wait {','.join(keys)} (polling)")
            if clock is None:
                raise StoreTimeout(",".join(keys))
            clock.t += poll
            if clock.t >= deadline:
                raise StoreTimeout(",".join(keys))

    def delete_key(self, key: str, expected: Optional[bytes] = None) -> bool:
        step = self._yield("delete", {key}, True)
        if expected is not None and self._data.get(key) != expected:
            self._log(step, f"delete {key} -> guarded, kept")
            return False
        val = self._data.pop(key, None)
        self.deleted_values.append((key, val))
        self._log(step, f"delete {key} -> {val is not None}")
        return val is not None

    def num_keys(self) -> int:
        step = self._yield("num_keys", set(), False)
        self._log(step, f"num_keys -> {len(self._data)}")
        return len(self._data)


@contextlib.contextmanager
def _patched_time(sched: Scheduler):
    """Dispatch time.time/monotonic/sleep to the current actor's
    virtual clock (non-actor threads keep the real functions).
    `sleep` is also a scheduler yield point."""
    real_time, real_mono, real_sleep = time.time, time.monotonic, time.sleep

    def v_time() -> float:
        a = sched.current_actor()
        return a.clock.t if a else real_time()

    def v_sleep(dt: float) -> None:
        a = sched.current_actor()
        if a is None:
            real_sleep(dt)
            return
        step = sched.yield_op(_OpDesc("sleep", frozenset(), False))
        a.clock.t += float(dt)
        sched.log(step, a.name, f"sleep {dt:g}")

    time.time = v_time  # type: ignore[assignment]
    time.monotonic = v_time  # type: ignore[assignment]
    time.sleep = v_sleep  # type: ignore[assignment]
    try:
        yield
    finally:
        time.time, time.monotonic, time.sleep = (
            real_time, real_mono, real_sleep,
        )


# ---------------------------------------------------------------------------
# exploration loop
# ---------------------------------------------------------------------------


@dataclass
class Scenario:
    """One protocol under test: named actor bodies `fn(store, clock)`,
    an optional unscheduled `seed(store)` run before the actors, and
    `invariants(store) -> [violation, ...]` checked at quiescence."""

    name: str
    actors: List[Tuple[str, Callable]]
    invariants: Callable[[ModelStore], List[str]]
    seed: Optional[Callable[[ModelStore], None]] = None
    store_timeout: float = 5.0
    max_steps: int = 400
    setup: Optional[Callable[[], None]] = None
    teardown: Optional[Callable[[], None]] = None


@dataclass
class _RunResult:
    schedule: List[str]
    oplog: List[Tuple[int, str, str]]
    branches: List[Tuple[int, str]]
    violations: List[str]
    budget_exhausted: bool


@dataclass
class ExploreReport:
    scenario: str
    ok: bool
    explored: int
    exhausted: bool  # True: the (pruned) schedule space was covered
    budget_runs: int  # runs cut off by the per-run step budget
    counterexample: Optional[_RunResult] = None


def _run_schedule(
    make: Callable[[], Scenario], prefix: Sequence[str]
) -> _RunResult:
    scen = make()
    sched = Scheduler(max_steps=scen.max_steps)
    store = ModelStore(sched, timeout=scen.store_timeout)
    if scen.setup is not None:
        scen.setup()
    try:
        if scen.seed is not None:
            scen.seed(store)  # main thread: ops execute unscheduled
        with _patched_time(sched):
            for name, fn in scen.actors:
                sched.spawn(name, fn, store)
            sched.run(prefix)
    finally:
        if scen.teardown is not None:
            scen.teardown()
    violations: List[str] = []
    for a in sched.actors:
        if a.exc is not None:
            violations.append(f"actor {a.name} raised {a.exc!r}")
    if not sched.budget_exhausted and not violations:
        violations.extend(scen.invariants(store))
    return _RunResult(
        schedule=sched.schedule,
        oplog=sched.oplog,
        branches=sched.branches,
        violations=violations,
        budget_exhausted=sched.budget_exhausted,
    )


def explore(
    make: Callable[[], Scenario],
    max_schedules: int = 1500,
) -> ExploreReport:
    """DFS over schedule prefixes with conflict-driven (backward
    DPOR-style) branch generation. Bounded: a clean report means no
    violation within the explored schedules, exhaustive only when
    `exhausted` is set."""
    name = make().name
    seen: Set[Tuple[str, ...]] = {()}
    stack: List[Tuple[str, ...]] = [()]
    explored = 0
    budget_runs = 0
    while stack and explored < max_schedules:
        prefix = stack.pop()
        res = _run_schedule(make, list(prefix))
        explored += 1
        if res.budget_exhausted:
            budget_runs += 1
        if res.violations:
            return ExploreReport(
                scenario=name, ok=False, explored=explored,
                exhausted=False, budget_runs=budget_runs,
                counterexample=res,
            )
        for idx, alt in res.branches:
            cand = tuple(res.schedule[:idx]) + (alt,)
            if cand not in seen:
                seen.add(cand)
                stack.append(cand)
    return ExploreReport(
        scenario=name, ok=True, explored=explored,
        exhausted=not stack, budget_runs=budget_runs,
    )


def render_trace(res: _RunResult, actors: Sequence[str]) -> str:
    """Counterexample as a per-actor step schedule: one column per
    actor, one row per executed step."""
    width = max(28, max((len(a) for a in actors), default=8) + 4)
    head = "step  " + "".join(a.ljust(width) for a in actors)
    lines = [head, "-" * len(head)]
    col = {a: i for i, a in enumerate(actors)}
    for step, actor, text in res.oplog:
        cells = [""] * len(actors)
        if actor in col:
            cells[col[actor]] = text
        lines.append(
            f"{step:>4}  " + "".join(c.ljust(width) for c in cells)
        )
    lines.append("")
    for v in res.violations:
        lines.append(f"VIOLATION: {v}")
    return "\n".join(lines)


# ---------------------------------------------------------------------------
# scenarios — the repo's REAL protocol functions under the model
# ---------------------------------------------------------------------------


class _StubQueue:
    def __init__(self) -> None:
        self._pending: List[Any] = []
        self.restored_rids: List[str] = []

    @property
    def depth(self) -> int:
        return len(self._pending)

    def requeue_front(self, req: Any) -> None:
        self._pending.insert(0, req)
        self.restored_rids.append(req.rid)

    def restore_tail(self, req: Any) -> None:
        self._pending.append(req)
        self.restored_rids.append(req.rid)


class _StubMetrics:
    def window_view(self) -> Dict:
        return {
            "window_s": 1.0, "classes": {}, "queue_depth_mean": 0.0,
            "occupancy_mean": 0.0, "pool_utilization_mean": 0.0,
        }

    def record_recovery(self, *a: Any, **k: Any) -> None:
        pass


class _Comp:
    def __init__(self, tokens: List[int]) -> None:
        self.tokens = tokens
        self.finish_reason = "stop"


class _StubEngine:
    """The minimal engine surface `ServeWorker` and `restore_into`
    touch: slot count, a depth-bounded queue, deterministic
    completions (tokens derived from the rid, so idempotency is
    byte-checkable across publishers)."""

    def __init__(self, slots: int = 2) -> None:
        self._slot_req: List[Any] = [None] * slots
        self.completions: Dict[str, _Comp] = {}
        self.queue = _StubQueue()
        self.metrics = _StubMetrics()

    def submit(self, prompt: Any, max_new_tokens: int, **kw: Any) -> None:
        rid = kw.get("rid", "")
        self.queue._pending.append(rid)

    def step(self) -> bool:
        if not self.queue._pending:
            return False
        rid = self.queue._pending.pop(0)
        self.completions[rid] = _Comp(_tokens_for(rid))
        return bool(self.queue._pending)

    def drain(self) -> Dict:
        return {"requests": [], "queued": [], "emitted": {}}


def _tokens_for(rid: str) -> List[int]:
    return [len(rid), sum(ord(c) for c in rid) % 97, 7]


def _scenario_ledger(revert_pr16: bool = False) -> Scenario:
    """Ledger publish/claim/scan: a GangRouter front door races 1-2
    ServeWorker scan loops. The invariant: no published seq is ever
    silently lost — a worker either claims it, parks its cursor at it
    (missing-grace), or the done key lands. ``revert_pr16`` zeroes the
    missing-grace window, reverting the consumer-side fix of the
    ledger race; the explorer must find the lost-seq interleaving."""
    from ..serve.worker import GangRouter, ServeWorker

    n_workers = 1 if revert_pr16 else 2
    n_rids = 2
    state: Dict[str, Any] = {"cursors": {}}

    def router(store: ModelStore, clock: VirtualClock) -> None:
        r = GangRouter(store, clock=lambda: clock.t)
        for i in range(n_rids):
            r.submit([1, 2, i], 4, rid=f"r{i}")

    def make_worker(rank: int) -> Callable:
        def run(store: ModelStore, clock: VirtualClock) -> None:
            eng = _StubEngine()
            w = ServeWorker(
                store, eng, rank=rank, gen=0, clock=lambda: clock.t
            )
            if revert_pr16:
                w._missing_grace_s = 0.0
            for _ in range(4):
                w._claim_available()
                while eng.step():
                    pass
                w._publish_completions()
                time.sleep(0.01)
            state["cursors"][rank] = w._cursor

        return run

    def invariants(store: ModelStore) -> List[str]:
        out: List[str] = []
        data = store._data
        head = int(data.get("serve/work/head", b"0"))
        for seq in range(1, head + 1):
            item = data.get(f"serve/work/item/{seq}")
            if item is None:
                continue
            rid = json.loads(item).get("rid", "")
            done = f"serve/done/{rid}" in data
            claimed = f"serve/work/claim/gen0/{seq}" in data
            # parked == some worker's cursor will rescan this seq; a
            # seq merely remembered in `_missing` after a grace-expiry
            # skip is NOT parked — the cursor moved past it for good
            parked = any(c <= seq for c in state["cursors"].values())
            if done:
                continue
            if claimed:
                out.append(
                    f"seq {seq} ({rid}) claimed but never published"
                )
            elif not parked:
                out.append(
                    f"seq {seq} ({rid}) LOST: item published, not "
                    "done, unclaimed, and every worker cursor moved "
                    "past it"
                )
        for key, wins in store.cas_wins.items():
            if key.startswith("serve/work/claim/") and wins > 1:
                out.append(f"claim {key} granted {wins} times")
        return out

    return Scenario(
        name="ledger" + ("-pr16-revert" if revert_pr16 else ""),
        actors=[("router", router)]
        + [(f"w{r}", make_worker(r)) for r in range(n_workers)],
        invariants=invariants,
    )


def _scenario_leader() -> Scenario:
    """Drain→seal→restore leader election: per-rank snapshot planes
    are pre-sealed with the REAL `save_serve_state`, then 2 workers
    race the REAL `_restore_geometry`. Invariants: exactly one leader
    per generation, the leader merges every non-done rid, the done
    marker lands, the election CAS grants at most once."""
    from ..serve import worker as worker_mod
    from ..serve.elastic import save_serve_state
    from ..serve.queue import Request

    workers: List[Any] = []
    rids = ["a0", "a1", "b0"]
    done_rid = "b0"

    def seed(store: ModelStore) -> None:
        for plane_rank, plane_rids in ((0, rids[:2]), (1, rids[2:])):
            reqs = []
            for i, rid in enumerate(plane_rids):
                req = Request(
                    prompt=[3, 1, i], max_new_tokens=4, rid=rid, seed=i
                )
                reqs.append(req.to_state())
            save_serve_state(
                store,
                3,
                {
                    "requests": reqs,
                    "queued": [],
                    "emitted": {},
                    "checkpoint_time": 999.0,
                },
                key_prefix=f"serve/ckpt/w{plane_rank}",
            )
            for i, rid in enumerate(plane_rids):
                store.set(f"serve/work/rid/{rid}", str(i + 1).encode())  # distlint: disable=R007 -- scenario seed into the per-run ModelStore, not a live daemon
        store.set(  # distlint: disable=R007 -- scenario seed into the per-run ModelStore, not a live daemon
            f"serve/done/{done_rid}",
            json.dumps({"rid": done_rid, "tokens": [1]}).encode(),
        )

    def make_worker(rank: int) -> Callable:
        def run(store: ModelStore, clock: VirtualClock) -> None:
            eng = _StubEngine()
            w = worker_mod.ServeWorker(
                store, eng, rank=rank, gen=4,
                leader_wait_s=0.2, clock=lambda: clock.t,
            )
            w._restore_geometry()
            workers.append(w)

        return run

    def invariants(store: ModelStore) -> List[str]:
        out: List[str] = []
        leaders = [w for w in workers if w.is_leader]
        if len(leaders) != 1:
            out.append(f"{len(leaders)} leaders elected (want exactly 1)")
            return out
        want = {r for r in rids if r != done_rid}
        got = set(leaders[0].engine.queue.restored_rids)
        if got != want:
            out.append(
                f"leader restored {sorted(got)}, want {sorted(want)} "
                "(every non-done rid must be merged)"
            )
        if "serve/restored/gen4/done" not in store._data:
            out.append("restore done-marker never landed")
        if store.cas_wins.get("serve/restored/gen4", 0) > 1:
            out.append("election CAS granted more than once")
        return out

    saved = worker_mod._MAX_RANKS

    def setup() -> None:
        worker_mod._MAX_RANKS = 4  # bound the plane walk to the model

    def teardown() -> None:
        worker_mod._MAX_RANKS = saved

    return Scenario(
        name="leader",
        actors=[(f"w{r}", make_worker(r)) for r in range(2)],
        invariants=invariants,
        seed=seed,
        setup=setup,
        teardown=teardown,
    )


def _scenario_resize() -> Scenario:
    """Resize-target stamp/act/consume: two controllers race the REAL
    `_stamp_resize` while an agent tick runs the REAL monitor act path
    (peek → stale check → clamp → consume → mark done). Invariants:
    acted stamps strictly increase (replay/duplicate safety) and the
    persisted high-water matches the last act."""
    from ..elastic import agent as agent_mod

    acted: List[Tuple[int, int]] = []
    consumed: List[bytes] = []

    def controller(nproc: int) -> Callable:
        def run(store: ModelStore, clock: VirtualClock) -> None:
            agent_mod._stamp_resize(store, nproc)

        return run

    def agent_actor(store: ModelStore, clock: VirtualClock) -> None:
        ag = agent_mod.LocalElasticAgent.__new__(
            agent_mod.LocalElasticAgent
        )
        ag.spec = type(
            "Spec", (), {"min_nproc": 1, "nproc_per_node": 8}
        )()
        ag.active_nproc = 2
        ag._resize_done = None
        for _ in range(6):
            raw = agent_mod.LocalElasticAgent._peek(
                store, agent_mod._RESIZE_KEY
            )
            if raw is None or raw == b"":
                time.sleep(0.01)
                continue
            nproc, seq = agent_mod._parse_resize(raw)
            stale = seq is not None and seq <= ag._resize_done_seq(store)
            target = ag._clamp_resize(nproc)
            if not stale and target != ag.active_nproc:
                acted.append((seq if seq is not None else -1, target))
                ag.active_nproc = target
                consumed.append(raw)
                ag._consume_resize_key(store, raw)
                ag._mark_resize_done(store, seq)
            else:
                consumed.append(raw)
                ag._consume_resize_key(store, raw)
                if not stale:
                    ag._mark_resize_done(store, seq)

    def invariants(store: ModelStore) -> List[str]:
        out: List[str] = []
        seqs = [s for s, _ in acted]
        if seqs != sorted(set(seqs)):
            out.append(
                f"acted stamps not strictly increasing: {seqs} "
                "(stale replay or double-act)"
            )
        if acted:
            raw = store._data.get(agent_mod._RESIZE_DONE_KEY)
            if raw is not None and int(raw) < max(seqs):
                out.append(
                    f"high-water {int(raw)} below last acted seq "
                    f"{max(seqs)}"
                )
        # the consume must never destroy a stamp it did not act on
        # (the CAS-tombstone contract; a peek-then-delete regression
        # shows up here as a destroyed un-consumed stamp)
        for key, val in store.deleted_values:
            if key != agent_mod._RESIZE_KEY:
                continue
            if val not in consumed and val not in (None, b""):
                out.append(
                    f"resize stamp {val!r} destroyed without being "
                    "acted on (consume raced a newer publish)"
                )
        return out

    return Scenario(
        name="resize",
        actors=[
            ("ctl3", controller(3)),
            ("ctl5", controller(5)),
            ("agent", agent_actor),
        ],
        invariants=invariants,
    )


def _scenario_done() -> Scenario:
    """`serve/done` idempotent completion: two workers that both hold
    the same finished rid race `_publish_completions`. The done row's
    TOKENS must be identical under every write order (the rank field
    differs by design — idempotency is token-level)."""
    from ..serve.worker import ServeWorker

    rid = "dup0"

    def make_worker(rank: int) -> Callable:
        def run(store: ModelStore, clock: VirtualClock) -> None:
            eng = _StubEngine()
            eng.completions[rid] = _Comp(_tokens_for(rid))
            w = ServeWorker(
                store, eng, rank=rank, gen=0, clock=lambda: clock.t
            )
            w._publish_completions()

        return run

    def invariants(store: ModelStore) -> List[str]:
        raw = store._data.get(f"serve/done/{rid}")
        if raw is None:
            return ["done key never published"]
        row = json.loads(raw)
        if row.get("tokens") != _tokens_for(rid):
            return [
                f"done tokens {row.get('tokens')} != expected "
                f"{_tokens_for(rid)} (non-idempotent completion)"
            ]
        return []

    return Scenario(
        name="done",
        actors=[(f"w{r}", make_worker(r)) for r in range(2)],
        invariants=invariants,
    )


SCENARIOS: Dict[str, Callable[..., Scenario]] = {
    "ledger": _scenario_ledger,
    "leader": _scenario_leader,
    "resize": _scenario_resize,
    "done": _scenario_done,
}


def run_scenarios(
    names: Optional[Sequence[str]] = None,
    seed_revert: Optional[str] = None,
    max_schedules: int = 1500,
) -> List[ExploreReport]:
    """Explore the named scenarios (default: all). ``seed_revert``
    ("pr16") additionally runs the ledger scenario with the ledger
    race's consumer-side fix reverted — that run MUST produce a
    counterexample, proving the explorer can see the bug class."""
    names = list(names) if names else list(SCENARIOS)
    reports: List[ExploreReport] = []
    for name in names:
        make = SCENARIOS[name]
        reports.append(
            explore(lambda m=make: m(), max_schedules=max_schedules)
        )
    if seed_revert == "pr16":
        reports.append(
            explore(
                lambda: _scenario_ledger(revert_pr16=True),
                max_schedules=max_schedules,
            )
        )
    return reports


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------


def _print_keys(reg: Registry) -> None:
    rows = sorted(
        {(u.text, u.op, u.path, u.line) for u in reg.usages}
    )
    width = max((len(t) for t, *_ in rows), default=20) + 2
    for text, op, path, line in rows:
        print(f"{text.ljust(width)}{op:<7}{path}:{line}")
    print(
        f"-- {len(reg.usages)} usages, "
        f"{len({u.text for u in reg.usages})} families, "
        f"{reg.opaque} opaque key expression(s) dropped",
        file=sys.stderr,
    )


def _run_explore(args: Any) -> int:
    names = args.scenario or list(SCENARIOS)
    unknown = [n for n in names if n not in SCENARIOS]
    if unknown:
        print(
            f"storelint: unknown scenario(s) {', '.join(unknown)} "
            f"(have: {', '.join(SCENARIOS)})",
            file=sys.stderr,
        )
        return 2
    max_schedules = args.max_schedules
    if args.quick:
        max_schedules = min(max_schedules, 150)
    rc = 0
    reports = run_scenarios(
        names, seed_revert=args.seed_revert, max_schedules=max_schedules
    )
    for rep in reports:
        seeded = rep.scenario.endswith("-revert")
        tag = "seeded-revert " if seeded else ""
        if rep.counterexample is None:
            cov = "exhausted" if rep.exhausted else "bounded"
            line = (
                f"storelint: {tag}scenario '{rep.scenario}': no "
                f"violation in {rep.explored} schedule(s) [{cov}"
                + (
                    f", {rep.budget_runs} budget-cut run(s)]"
                    if rep.budget_runs
                    else "]"
                )
            )
            if seeded:
                # the revert MUST be caught — a clean pass means the
                # explorer lost its teeth
                print(line, file=sys.stderr)
                print(
                    "storelint: FAIL — seeded pr16 revert was NOT "
                    "caught",
                    file=sys.stderr,
                )
                rc = 1
            else:
                print(line)
        else:
            # actor names straight from the counterexample log keep the
            # trace faithful to what actually ran (revert variants drop
            # a worker)
            seen: List[str] = []
            for _, a, _t in rep.counterexample.oplog:
                if a not in seen:
                    seen.append(a)
            print(
                f"storelint: {tag}scenario '{rep.scenario}': VIOLATION "
                f"after {rep.explored} schedule(s); counterexample:"
            )
            print(render_trace(rep.counterexample, seen))
            if not seeded:
                rc = 1
            else:
                print(
                    "storelint: seeded pr16 revert caught as a "
                    "counterexample (explorer is sound for this bug "
                    "class)"
                )
    return rc


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="storelint",
        description=(
            "coordination-plane analyzer: static store key-space rules "
            "(S001-S007) + exhaustive interleaving exploration of the "
            "repo's real store protocols (--explore)"
        ),
    )
    ap.add_argument("--root", default=".", help="repo root")
    ap.add_argument(
        "--format", choices=("human", "json", "sarif"), default="human"
    )
    ap.add_argument("--baseline", help="baseline file (ratchet)")
    ap.add_argument("--update-baseline", action="store_true")
    ap.add_argument("--force-baseline-growth", action="store_true")
    ap.add_argument("--show-suppressed", action="store_true")
    ap.add_argument(
        "--keys", action="store_true",
        help="dump the harvested key registry, run no rules",
    )
    ap.add_argument(
        "--explore", action="store_true",
        help="run the interleaving explorer instead of the static rules",
    )
    ap.add_argument(
        "--scenario", action="append",
        help="explore only this scenario (repeatable; default all)",
    )
    ap.add_argument(
        "--seed-revert", choices=("pr16",),
        help="also explore with the named fix reverted; the run must "
        "produce a counterexample",
    )
    ap.add_argument(
        "--quick", action="store_true",
        help="bounded explorer budget for tier-1 (<=150 schedules)",
    )
    ap.add_argument(
        "--max-schedules", type=int, default=1500,
        help="explorer schedule budget per scenario",
    )
    args = ap.parse_args(argv)
    if args.update_baseline and not args.baseline:
        print(
            "storelint: --update-baseline requires --baseline FILE",
            file=sys.stderr,
        )
        return 2

    if args.explore:
        return _run_explore(args)

    try:
        config = load_config(args.root)
    except ValueError as e:
        print(f"storelint: {e}", file=sys.stderr)
        return 2
    try:
        findings, reg = lint(args.root, config)
    except FileNotFoundError as e:
        print(
            f"storelint: {e}\n"
            "(the configured lint paths are resolved under --root; "
            f"to lint a bare directory, give it a {CONFIG_PATH} with "
            '[tool.storelint] paths = ["."])',
            file=sys.stderr,
        )
        return 2

    if args.keys:
        _print_keys(reg)
        return 0

    stale_entries: List[Dict] = []
    if args.baseline:
        try:
            baseline = load_baseline(args.baseline)
        except FileNotFoundError:
            baseline = {"findings": []}
        except (OSError, ValueError) as e:
            print(f"storelint: {e}", file=sys.stderr)
            return 2
        _, _, stale_entries = apply_baseline(findings, baseline)
        if args.update_baseline:
            try:
                n = write_baseline(
                    args.baseline,
                    findings,
                    allow_growth=args.force_baseline_growth,
                    tool="storelint",
                )
            except ValueError as e:
                print(f"storelint: {e}", file=sys.stderr)
                return 2
            print(
                f"storelint: baseline updated ({n} entries)",
                file=sys.stderr,
            )

    if args.format == "json":
        print(json.dumps([f.to_dict() for f in findings], indent=2))
    elif args.format == "sarif":
        print(
            json.dumps(
                render_sarif(
                    findings,
                    args.show_suppressed,
                    baseline_mode=bool(args.baseline),
                    tool_name="storelint",
                    rules=RULES,
                    information_uri=_INFO_URI,
                    fingerprint_key="storelint/v1",
                ),
                indent=2,
            )
        )
    else:
        print(
            render_report(
                findings, args.show_suppressed, tool="storelint"
            )
        )
    if stale_entries:
        print(
            f"storelint: {len(stale_entries)} stale baseline entr"
            f"{'y' if len(stale_entries) == 1 else 'ies'} — run "
            "--update-baseline to shrink the ratchet",
            file=sys.stderr,
        )
    active = [
        f
        for f in findings
        if not f.suppressed and not f.baselined and f.severity == "error"
    ]
    return 1 if active else 0


if __name__ == "__main__":
    sys.exit(main())
