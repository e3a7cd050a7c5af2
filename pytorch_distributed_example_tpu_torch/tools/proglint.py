"""proglint — the port's program-plane analyzer, with first-call
cross-rank schedule agreement.

The port of the reference's `tools/proglint.py`. distlint proves the
SOURCE plane cannot diverge (R001-R011, R013-R015 over the project call
graph) and the runtime ScheduleVerifier (`schedule.py`,
`TDX_SCHEDULE_CHECK=1`) catches a divergent EXECUTED schedule, but only
after a collective has been issued. proglint pins the PROGRAMS: the
serve engine's decode programs, the DDP train steps (replicated and
ZeRO), the planner's schedule bodies.

The port compiles nothing, so a program's identity is what it does on
its first call. Its **program fingerprint** is the ordered list of the
collectives that call issues, taken at the two collective seams
(`schedule.tap`): `ProcessGroup._dispatch` (the c10d core, beside the
ScheduleVerifier's `record`) and `nn/functional.py`'s axis collectives
(whose multiproc lowering through `_core` is hidden, so each collective
is listed once). Each entry is the op under the reference's primitive
name (`reduce_scatter` is `psum_scatter`, an all-reduce is `psum` /
`pmax` / `pmin` by its reduce op, `permute` is `ppermute`), the axis
names (a process group's ranks are the axis `_ranks`, as the
reference's group mesh names them), one rank's operand shape and dtype,
the permutation and the op's parameters. A c10d reduce-scatter or
all-gather over a group is the tiled dim-0 form of the reference's
(the W blocks of one rank's input are the tiled flat buffer). The
collectives a backward pass issues through `nn/functional.py`'s
Functions are the forward's transposes and are not listed.

Rules on top of the fingerprint:

  J001  collective axis name absent from the program's mesh and from the
        project-wide mesh-axis registry (distlint R015's harvest, read
        through `distlint.harvested_mesh_axes`: one source of truth for
        both planes)
  J002  ppermute permutation structurally invalid (duplicate
        sources/destinations, out-of-range endpoints) or inconsistent
        with the registered plan artifact's round sequence
        (`plan/schedules.py`)
  J004  quantized-wire program carrying a >1-byte payload dtype through
        a collective (`ops/quant.py`; `quantized_wire_violations` is the
        helper its tests pin)
  J005  cross-rank schedule agreement, a runtime rule: under
        `TDX_PROGLINT=1` a registered program's first call agrees every
        collective with the other ranks of the default group through
        `schedule.agree_program` BEFORE it dispatches (a store round per
        position, keyed `reg{seq}/c{k}`, the last carrying the whole
        fingerprint), then registers the fingerprint (`reg{seq}`). A
        mismatch raises `ProgramScheduleMismatchError` naming the first
        divergent collective, where the run would otherwise hang in it.

Not owed: J003 (donated argument not aliased). The port accepts
`donate=` and ignores it, so there is no donation to drop; asking for it
by name (a severity entry, ``--explain J003``) fails with that reason.
The canonical fingerprint has no `donated` / `aliased` fields.

Register-on-compile seams (`TDX_PROGLINT=1` only, one env read per
build): `serve/decode.py`'s slot and paged programs, `parallel/ddp.py`'s
train step (`ddp.train_step.{zero,replicated}`) and `plan/driver.py`'s
`compiled_body`. Each wraps its program in `instrument()`, which
fingerprints, agrees and registers on the first call only.

The CLI (`python -m pytorch_distributed_example_tpu_torch.tools.proglint`)
builds the same programs at tiny shapes in driver mode on the CPU, as
the reference builds its programs on a CPU mesh (it is a host tool, not
a fallback from the card), runs J001, J002 and J004 over all of them,
and reports human/JSON/SARIF with the content-fingerprinted baseline
ratchet (`pytorch_distributed_example_tpu_torch/tools/baselines/
proglint.json`). ``--corpus`` gates the golden corpus
(`tests/fixtures/proglint_torch/`, rewritten by ``--update-corpus``).
"""

from __future__ import annotations

import argparse
import contextlib
import hashlib
import json
import os
import sys
import threading
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

from .. import traceguard
from ._lintcore import (
    Finding,
    apply_baseline,
    load_baseline,
    load_config_section,
    parse_severity_table,
    render_report,
    render_sarif,
    scoped_env,
    write_baseline,
)
from .distlint import NotOwedRuleError, harvested_mesh_axes

__all__ = [
    "RULES",
    "NOT_OWED",
    "CollectiveEqn",
    "ProgramFingerprint",
    "collecting",
    "collect_collectives",
    "quantized_wire_violations",
    "fingerprint_program",
    "check_fingerprint",
    "expected_perms_from_plan",
    "explain_rule",
    "armed",
    "instrument",
    "registry",
    "register_fingerprint",
    "build_repo_programs",
    "lint_repo_programs",
    "corpus_diff",
    "write_corpus",
    "load_config",
    "main",
]

RULES = {
    "J001": "collective axis name absent from the program's mesh and the "
            "harvested mesh-axis registry",
    "J002": "ppermute permutation invalid or inconsistent with the "
            "registered plan artifact",
    "J004": "quantized-wire program moves a >1-byte payload dtype "
            "through a collective",
    "J005": "cross-rank program schedule disagreement (runtime rule: "
            "ProgramScheduleMismatchError at the first call)",
}

# Rules of the reference that the port does not owe, with the reason a
# request for one by name fails with.
NOT_OWED = {
    "J003": (
        "J003 (donated argument not aliased) is not owed by the port: it "
        "accepts `donate=` and ignores it, so no program donates a buffer "
        "and no donation can be dropped"
    ),
}

_ENV = "TDX_PROGLINT"
_PKG = "pytorch_distributed_example_tpu_torch"

_CANONICAL = {"reduce_scatter": "psum_scatter", "permute": "ppermute"}
_REDUCE_PRIMS = {"SUM": "psum", "AVG": "psum", "PREMUL_SUM": "psum",
                 "MAX": "pmax", "MIN": "pmin"}

# op parameters that must agree across ranks but are invisible in
# (primitive, axes, operand), in the reference's order, then the port's
_DETAIL_PARAMS = (
    "scatter_dimension",
    "all_gather_dimension",
    "split_axis",
    "concat_axis",
    "tiled",
    "op",
    "src",
    "dst",
    "detail",
)


# ---------------------------------------------------------------------------
# collective collection (the two seams, through schedule.tap)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class CollectiveEqn:
    """One collective in issue order."""

    index: int
    primitive: str                                   # canonical name
    axes: Tuple[str, ...]                            # named mesh axes
    operands: Tuple[Tuple[str, Tuple[int, ...]], ...]  # (dtype, shape)
    perm: Optional[Tuple[Tuple[int, int], ...]] = None
    detail: str = ""

    def descriptor(self) -> str:
        ops = ",".join(
            f"{d}[{'x'.join(str(s) for s in shp)}]"
            for d, shp in self.operands
        )
        base = f"{self.primitive}|axes={','.join(self.axes)}|{ops}"
        if self.perm is not None:
            base += "|perm=" + ";".join(f"{a}>{b}" for a, b in self.perm)
        if self.detail:
            base += f"|{self.detail}"
        return base


def _reduce_name(text: str) -> str:
    """The ReduceOp a detail string names ("ReduceOp.SUM", "SUM", a
    PREMUL_SUM object's repr), or ""."""
    up = str(text).upper()
    for name in ("PREMUL_SUM", "SUM", "AVG", "MAX", "MIN", "PRODUCT", "BAND", "BOR", "BXOR"):
        if name in up:
            return name
    return ""


def _parse_perm(detail: str) -> Optional[Tuple[Tuple[int, int], ...]]:
    """The pairs of a c10d permute's detail, ``perm=[(0, 1), (1, 0)]``."""
    import ast as _ast

    if not detail.startswith("perm="):
        return None
    try:
        pairs = _ast.literal_eval(detail[len("perm="):])
    except (ValueError, SyntaxError):
        return None
    return tuple((int(a), int(b)) for a, b in pairs)


def _eqn_of(record: Tuple, index: int) -> CollectiveEqn:
    """Canonicalize one raw seam record into the reference's vocabulary."""
    source, op, axes, shape, dtype, params = record
    params = dict(params)
    perm = params.pop("perm", None)
    detail = params.pop("detail", "")
    prim = _CANONICAL.get(op, op)
    if op == "all_reduce":
        red = _reduce_name(params.pop("reduce_op", detail))
        detail = ""
        prim = _REDUCE_PRIMS.get(red, "all_reduce")
        if prim == "all_reduce":
            params["op"] = red
    elif op == "reduce":
        red = _reduce_name(params.pop("reduce_op", ""))
        params["op"] = red
    elif source == "c10d":
        if op == "reduce_scatter":
            red = _reduce_name(detail)
            detail = ""
            if red not in ("SUM", "AVG", "PREMUL_SUM"):
                params["op"] = red
            # one rank's W blocks are the tiled flat buffer
            shape = (shape[0] * shape[1],) + tuple(shape[2:]) if len(shape) >= 2 else shape
            params.update(scatter_dimension=0, tiled=True)
        elif op == "all_gather":
            params.update(all_gather_dimension=0, tiled=True)
        elif op == "all_to_all":
            params.update(split_axis=0, concat_axis=0)
        elif op == "permute":
            perm = _parse_perm(detail)
            detail = ""
    details = []
    for k in _DETAIL_PARAMS:
        v = detail if k == "detail" else params.get(k)
        if v is not None and v is not False and v != "":
            details.append(f"{k}={v}")
    return CollectiveEqn(
        index=index,
        primitive=prim,
        axes=tuple(a for a in axes if isinstance(a, str)),
        operands=((dtype, tuple(int(d) for d in shape)),) if dtype else (),
        perm=tuple((int(a), int(b)) for a, b in perm) if perm is not None else None,
        detail="|".join(details),
    )


@contextlib.contextmanager
def collecting():
    """Collect, in issue order, the collectives the calling thread issues
    inside the block: yields the list the CollectiveEqns land in."""
    from .. import schedule

    out: List[CollectiveEqn] = []

    def sink(*record):
        out.append(_eqn_of(record, len(out)))

    with schedule.tap(sink):
        yield out


def collect_collectives(fn, *args, **kwargs) -> Tuple[List[CollectiveEqn], Any]:
    """(the collectives one call of ``fn`` issues, its result): the shared
    collection behind the fingerprint, rule J004 and the quantized-wire
    pin of the port's tests."""
    with collecting() as eqns:
        out = fn(*args, **kwargs)
    return list(eqns), out


def _itemsize(dtype: str) -> int:
    import torch

    return getattr(torch, dtype).itemsize


def quantized_wire_violations(
    eqns: Sequence[CollectiveEqn],
) -> List[Tuple[CollectiveEqn, Tuple[str, Tuple[int, ...]], int]]:
    """Operands violating the quantized-wire contract, as
    (eqn, (dtype, shape), nbytes) triples: rule J004's core.

    Contract: in a wire-quantized program the PAYLOAD moving through
    every collective is a 1-byte dtype; wider operands are legitimate
    only as small sidecars (per-block scales: float32, but a fraction of
    the payload bytes). So: let B be the largest 1-byte collective
    operand in the program; any >1-byte operand at or above B bytes is
    a payload regression, and if NO 1-byte operand exists at all the
    wire is simply unquantized and every >1-byte operand is flagged."""
    sized = []
    best_1byte = 0
    for eq in eqns:
        for dt, shape in eq.operands:
            item = _itemsize(dt)
            n = 1
            for s in shape:
                n *= int(s)
            nbytes = n * item
            sized.append((eq, dt, shape, nbytes, item))
            if item == 1:
                best_1byte = max(best_1byte, nbytes)
    out = []
    for eq, dt, shape, nbytes, item in sized:
        if item <= 1:
            continue
        if best_1byte == 0 or nbytes >= best_1byte:
            out.append((eq, (dt, shape), nbytes))
    return out


# ---------------------------------------------------------------------------
# program fingerprints
# ---------------------------------------------------------------------------


@dataclass
class ProgramFingerprint:
    """Canonical identity of one program: its ordered collective sequence.
    `digest` is what ranks agree on (J005); `canonical()` is what the
    golden corpus ratchets."""

    name: str
    path: str = ""
    eqns: Tuple[CollectiveEqn, ...] = ()
    mesh_axes: Tuple[str, ...] = ()     # the binding mesh's axis names
    world: Optional[int] = None

    def eqn_descriptors(self) -> List[str]:
        return [e.descriptor() for e in self.eqns]

    def canonical(self) -> Dict[str, Any]:
        return {
            "name": self.name,
            "eqns": self.eqn_descriptors(),
            "mesh_axes": list(self.mesh_axes),
            "world": self.world,
            "digest": self.digest,
        }

    @property
    def digest(self) -> str:
        body = json.dumps({"eqns": self.eqn_descriptors()}, sort_keys=True)
        return hashlib.sha256(body.encode()).hexdigest()[:32]


def fingerprint_program(
    name: str,
    fn,
    args: Sequence[Any],
    kwargs: Optional[Dict[str, Any]] = None,
    *,
    path: str = "",
    mesh_axes: Sequence[str] = (),
    world: Optional[int] = None,
) -> ProgramFingerprint:
    """Fingerprint ``fn`` by calling it once on ``args`` (the port's
    programs run eagerly: the collectives of a call are its program)."""
    eqns, _ = collect_collectives(fn, *args, **(kwargs or {}))
    return ProgramFingerprint(
        name=name, path=path, eqns=tuple(eqns), mesh_axes=tuple(mesh_axes),
        world=world,
    )


# ---------------------------------------------------------------------------
# rules J001, J002, J004 (J005 is the runtime agreement below)
# ---------------------------------------------------------------------------


def explain_rule(rule: str) -> str:
    """``RULE: description``; a not-owed rule raises `NotOwedRuleError`
    with its reason, an unknown one `KeyError`."""
    rule = rule.strip().upper()
    if rule in NOT_OWED:
        raise NotOwedRuleError(NOT_OWED[rule])
    return f"{rule}: {RULES[rule]}"


def _finding_fingerprint(program: str, rule: str, detail: str) -> str:
    return hashlib.sha256(
        f"{program}|{rule}|{detail}".encode()
    ).hexdigest()[:16]


def expected_perms_from_plan(plan) -> Tuple[Tuple[Tuple[int, int], ...], ...]:
    """Per-round canonical ppermute pairs of a `plan.schedules.Plan`
    artifact: each round's send steps as sorted (src, dst) pairs. The
    J002 consistency reference: a driver body whose ppermute sequence
    no longer matches the registered artifact's rounds is flagged."""
    rounds = []
    for rnd in plan.rounds:
        pairs = set()
        for r, steps in enumerate(rnd.steps):
            for s in steps:
                if s.kind == "send":
                    pairs.add((int(r), int(s.peer)))
        if pairs:
            rounds.append(tuple(sorted(pairs)))
    return tuple(rounds)


def check_fingerprint(
    fp: ProgramFingerprint,
    *,
    registry_axes: frozenset = frozenset(),
    quantized_wire: bool = False,
    expected_perms: Optional[Sequence] = None,
    suppress: Sequence[Tuple[str, str]] = (),
    severity: Optional[Dict[str, str]] = None,
) -> List[Finding]:
    """Run J001, J002 and J004 over one program fingerprint. ``suppress``
    is a sequence of (rule, reason) pairs from the program's catalog
    entry: a reasoned suppression marks the finding suppressed (reported
    with --show-suppressed, never fails the gate)."""
    severity = severity or {}
    suppressed_rules = {r for r, _ in suppress}
    findings: List[Finding] = []
    path = fp.path or f"<program:{fp.name}>"

    def emit(rule: str, message: str, detail: str) -> None:
        sev = severity.get(rule, "error")
        if sev == "off":
            return
        findings.append(
            Finding(
                path=path,
                line=1,
                col=1,
                rule=rule,
                message=f"program {fp.name!r}: {message}",
                severity=sev,
                suppressed=rule in suppressed_rules,
                fingerprint=_finding_fingerprint(fp.name, rule, detail),
            )
        )

    # J001: axis names must come from somewhere real
    known = set(fp.mesh_axes) | set(registry_axes)
    for eq in fp.eqns:
        for ax in eq.axes:
            if ax not in known:
                emit(
                    "J001",
                    f"collective eqn #{eq.index + 1} "
                    f"({eq.primitive}) binds axis {ax!r}, which is "
                    f"neither in the program's mesh {list(fp.mesh_axes)} "
                    "nor in the project-wide mesh-axis registry "
                    "(distlint R015 harvest)",
                    f"{eq.descriptor()}|{ax}",
                )

    # J002: ppermute structural validity + plan-artifact consistency
    permutes = [e for e in fp.eqns if e.primitive == "ppermute"]
    size = fp.world
    for eq in permutes:
        perm = eq.perm or ()
        srcs = [a for a, _ in perm]
        dsts = [b for _, b in perm]
        problems = []
        if not perm:
            problems.append("empty permutation")
        if len(set(srcs)) != len(srcs):
            problems.append("duplicate sources")
        if len(set(dsts)) != len(dsts):
            problems.append("duplicate destinations")
        if size is not None and any(
            v < 0 or v >= size for v in srcs + dsts
        ):
            problems.append(f"endpoint outside world {size}")
        elif size is None and any(v < 0 for v in srcs + dsts):
            problems.append("negative endpoint")
        if problems:
            emit(
                "J002",
                f"collective eqn #{eq.index + 1} ppermute permutation "
                f"{list(eq.perm or ())} is invalid: "
                + ", ".join(problems),
                f"{eq.descriptor()}|invalid",
            )
    if expected_perms is not None:
        actual = [tuple(sorted(e.perm or ())) for e in permutes]
        want = [tuple(sorted(p)) for p in expected_perms]
        if actual != want:
            k = next(
                (i for i, (a, b) in enumerate(zip(actual, want)) if a != b),
                min(len(actual), len(want)),
            )
            emit(
                "J002",
                f"ppermute sequence diverges from the registered plan "
                f"artifact at round {k + 1}: program has "
                f"{actual[k] if k < len(actual) else '<none>'}, artifact "
                f"expects {want[k] if k < len(want) else '<none>'} "
                f"({len(actual)} ppermute eqn(s) vs {len(want)} "
                "artifact round(s))",
                f"artifact|{k}|{actual}|{want}",
            )

    # J004: quantized wire discipline
    if quantized_wire:
        for eq, (dt, shape), nbytes in quantized_wire_violations(fp.eqns):
            emit(
                "J004",
                f"collective eqn #{eq.index + 1} ({eq.primitive}) "
                f"carries a {dt} payload of shape {list(shape)} "
                f"({nbytes} bytes) on a wire-quantized path: payloads "
                "must be 1-byte dtypes (scale sidecars are exempt by "
                "the payload-size test)",
                f"{eq.descriptor()}|{dt}|{shape}",
            )

    return findings


# ---------------------------------------------------------------------------
# runtime registry + register-on-compile instrumentation (J005)
# ---------------------------------------------------------------------------


def armed() -> bool:
    """True when TDX_PROGLINT=1: the seams register their programs and
    each registration runs the cross-rank agreement."""
    return os.environ.get(_ENV, "0") == "1"


class ProgramRegistry:
    """Process-global record of fingerprinted programs."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._entries: List[Tuple[str, int, ProgramFingerprint]] = []
        self._counts: Dict[str, int] = {}
        self._next = 0

    def reserve(self) -> int:
        """The next global registration sequence: the J005 agreement
        rounds of a program's first call are keyed by it (in SPMD every
        rank registers programs in the same order, so rank A running a
        DIFFERENT program at sequence k than rank B is itself a
        divergence the agreement names; keying by name would make skewed
        ranks wait on keys that never appear)."""
        with self._lock:
            seq = self._next
            self._next += 1
            return seq

    def record(self, fp: ProgramFingerprint, seq: Optional[int] = None) -> Tuple[int, int]:
        """Record; returns (global registration sequence, per-name ordinal)."""
        if seq is None:
            seq = self.reserve()
        with self._lock:
            k = self._counts.get(fp.name, 0)
            self._counts[fp.name] = k + 1
            self._entries.append((fp.name, k, fp))
            return seq, k

    def entries(self) -> List[Tuple[str, int, ProgramFingerprint]]:
        with self._lock:
            return list(self._entries)

    def get(self, name: str) -> List[ProgramFingerprint]:
        with self._lock:
            return [fp for n, _, fp in self._entries if n == name]

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()
            self._counts.clear()
            self._next = 0


_registry = ProgramRegistry()


def registry() -> ProgramRegistry:
    """The process-global registry of the CANONICAL module instance. When
    this file runs as __main__ (`python -m ...tools.proglint`) it exists
    twice, the __main__ copy and the instance the seams import, each with
    its own globals; the seams record into the canonical import, so every
    reader resolves through it too."""
    import importlib

    return importlib.import_module(f"{_PKG}.tools.proglint")._registry


def _agreement_group():
    """(group-scoped store, rank, world) of the default group in a
    multiproc gang, else None: in driver mode one process runs every
    rank's program from one schedule, so the ranks agree structurally."""
    from .. import distributed as dist
    from ..store import PrefixStore

    w = dist._world
    pg = w.default_pg
    if w.mode != "multiproc" or pg is None or pg.store is None or pg.size() <= 1:
        return None
    return PrefixStore("proglint", pg.store), pg.rank(), pg.size()


def _agree(target, key: str, name: str, descriptors: List[str]) -> None:
    from .. import schedule as _schedule

    store, rank, world = target
    digest = hashlib.sha256(
        json.dumps({"eqns": descriptors}, sort_keys=True).encode()
    ).hexdigest()[:32]
    _schedule.agree_program(
        store, rank, world, key, {"name": name, "digest": digest, "eqns": descriptors}
    )


_END = "<end of program>"


class _FirstCall:
    """The collectives of a program's first call; in a multiproc gang each
    one is agreed with the other ranks before it dispatches (a store round
    at position k, `reg{seq}/c{k}`), and the end of the program takes the
    next position, so a rank that issues one collective more than another
    is caught at that position instead of waiting in it."""

    def __init__(self, name: str, seq: int, target) -> None:
        self.name, self.seq, self.target = name, seq, target
        self.eqns: List[CollectiveEqn] = []

    def sink(self, *record) -> None:
        eq = _eqn_of(record, len(self.eqns))
        self.eqns.append(eq)
        if self.target is not None:
            _agree(self.target, f"reg{self.seq}/c{eq.index}", self.name,
                   [e.descriptor() for e in self.eqns])

    def finish(self) -> None:
        if self.target is not None:
            _agree(self.target, f"reg{self.seq}/c{len(self.eqns)}", self.name,
                   [e.descriptor() for e in self.eqns] + [_END])


def _maybe_agree(fp: ProgramFingerprint, seq: int) -> None:
    """J005: publish + verify the whole fingerprint through the default
    group's scoped store (multiproc only)."""
    from .. import schedule as _schedule

    target = _agreement_group()
    if target is None:
        return
    store, rank, world = target
    _schedule.agree_program(store, rank, world, f"reg{seq}", fp.canonical())


def register_fingerprint(fp: ProgramFingerprint, agree: bool = True,
                         seq: Optional[int] = None) -> int:
    """Record a fingerprint in the process registry and (multiproc) run
    the J005 agreement: raises ProgramScheduleMismatchError on
    divergence. Returns the fingerprint's per-name ordinal."""
    seq, ordinal = registry().record(fp, seq)
    if agree:
        _maybe_agree(fp, seq)
    return ordinal


def instrument(
    name: str,
    fn,
    *,
    path: str = "",
    mesh_axes: Sequence[str] = (),
    world: Optional[int] = None,
):
    """The register-on-first-call hook: wrap a program so its FIRST call
    records its collectives, agrees each one across the gang before it
    dispatches (multiproc) and registers the fingerprint. Returns ``fn``
    unchanged when TDX_PROGLINT is off: the seams pay one env read and
    nothing else. Later calls go straight to ``fn``."""
    if not armed():
        return fn
    from .. import schedule

    lock = threading.RLock()
    done: List[bool] = []

    def wrapper(*args, **kwargs):
        # registration is a HOST effect (store rounds): inside a torch.func
        # transform or a torch.compile trace it would run once per trace,
        # so it waits for the first call outside one
        if not done and not traceguard.under_tracing():
            with lock:
                if not done:
                    seq = registry().reserve()
                    first = _FirstCall(name, seq, _agreement_group())
                    with schedule.tap(first.sink):
                        out = fn(*args, **kwargs)
                    first.finish()
                    register_fingerprint(
                        ProgramFingerprint(name=name, path=path, eqns=tuple(first.eqns),
                                           mesh_axes=tuple(mesh_axes), world=world),
                        seq=seq,
                    )
                    done.append(True)
                    return out
        return fn(*args, **kwargs)

    wrapper.__name__ = getattr(fn, "__name__", name)
    wrapper.__dict__.update(getattr(fn, "__dict__", {}))
    # `_unwrap` strips exactly this one layer
    wrapper._proglint_wrapped = fn
    return wrapper


# ---------------------------------------------------------------------------
# the port's registered program catalog (CLI / self-gate / corpus)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ProgramMeta:
    """Per-program rule knobs carried by the catalog."""

    quantized_wire: bool = False
    expected_perms: Optional[Tuple] = None
    suppress: Tuple[Tuple[str, str], ...] = ()


def _unwrap(fn):
    return getattr(fn, "_proglint_wrapped", fn)


def _tiny_model():
    import torch

    from ..models.transformer import TransformerConfig, TransformerLM

    cfg = TransformerConfig(
        vocab_size=32, d_model=16, n_layers=1, n_heads=2, max_seq_len=16,
        use_flash=False, dtype=torch.float32,
    )
    return TransformerLM(cfg, device="cpu", generator=torch.Generator().manual_seed(0))


def _serve_programs() -> List[Tuple[ProgramFingerprint, ProgramMeta]]:
    import torch

    from .. import prng
    from ..models.generate import init_cache
    from ..serve import decode as _decode
    from ..serve.cache import PagedKVCache

    model = _tiny_model()
    path = f"{_PKG}/serve/decode.py"
    S = 2
    out: List[Tuple[ProgramFingerprint, ProgramMeta]] = []

    def lanes():
        return (torch.zeros(S, dtype=torch.int32), torch.zeros(S, dtype=torch.int32),
                prng.split(prng.PRNGKey(0), S))

    prefill, write_slot, step = map(_unwrap, _decode.slot_programs(model, 0.0, None))
    prompt = torch.zeros((1, 8), dtype=torch.int32)
    pre, _, first, key = prefill(prompt, 8, 0)
    for name, fn, args in (
        ("serve.slot.prefill", prefill, (prompt, 8, 0)),
        ("serve.slot.write_slot", write_slot,
         (init_cache(model, S), *lanes(), pre, 0, 8, first, key)),
        ("serve.slot.step", step, (init_cache(model, S), *lanes())),
    ):
        out.append((fingerprint_program(name, fn, args, path=path), ProgramMeta()))

    pool = PagedKVCache(model, slots=S, num_blocks=8, block_size=4)
    nb = pool.block_tables.shape[1]
    pc, ft, at, st = map(_unwrap, _decode.paged_programs(model, 0.0, None))
    bt = torch.zeros((S, nb), dtype=torch.int32)
    chunk = torch.zeros((1, 8), dtype=torch.int32)
    logits = torch.zeros((8, model.cfg.vocab_size), dtype=torch.float32)
    for name, fn, args in (
        ("serve.paged.prefill_chunk", pc, (pool.tree, chunk, bt[:1], 0)),
        ("serve.paged.first_token", ft, (logits, 7, 0)),
        ("serve.paged.attach", at, (*lanes(), 0, 8, first, key)),
        ("serve.paged.step", st, (pool.tree, *lanes(), bt)),
    ):
        out.append((fingerprint_program(name, fn, args, path=path), ProgramMeta()))
    return out


def _ddp_programs(group) -> List[Tuple[ProgramFingerprint, ProgramMeta]]:
    """Fingerprint the DDP trainer's steps by driving ONE tiny step of each
    through the real factory with the registry armed: going through the
    seam also proves the register-on-first-call hook end to end."""
    import torch

    from .. import optim
    from ..parallel.ddp import make_ddp_train_step

    W = group.size()

    def apply_fn(params, x):
        return x @ params["w"] + params["b"]

    def loss_fn(logits, y):
        return ((logits - y) ** 2).mean()

    optimizer = optim.adam(1e-3)
    x = torch.zeros((2 * W, 4))
    y = torch.zeros((2 * W, 3))
    out = []
    with scoped_env(**{_ENV: "1"}):
        for mode in ("auto", "off"):
            params = {"w": torch.zeros((4, 3)), "b": torch.zeros((3,))}
            before = {id(fp) for _, _, fp in registry().entries()}
            step = make_ddp_train_step(apply_fn, loss_fn, optimizer, group=group,
                                       shard_weight_update=mode)
            step(params, step.init_opt_state(params), x, y)
            for name, _, fp in registry().entries():
                if id(fp) not in before and name.startswith("ddp."):
                    out.append((fp, ProgramMeta()))
    return out


def _plan_programs(group) -> List[Tuple[ProgramFingerprint, ProgramMeta]]:
    import torch

    from ..plan import driver as plan_driver
    from ..plan import schedules, topology

    W = group.size()
    path = f"{_PKG}/plan/driver.py"
    topo = topology.Topology(W, (tuple(range(W)),), "cpu")
    n = 8
    out = []
    cases = (
        ("all_reduce", "ring", (W, n)),
        ("all_reduce", "rhd", (W, n)),
        ("all_gather", "ring", (W, n)),
        ("reduce_scatter", "ring", (W, W, n)),
    )
    for op_name, alg, shape in cases:
        prog = _unwrap(plan_driver.compiled_body(op_name, alg, W, plan_driver.AXIS))
        if alg == "rhd" or op_name in ("all_gather", "reduce_scatter"):
            expected = expected_perms_from_plan(schedules.synthesize(op_name, alg, W, n, topo))
        else:
            expected = ()  # driver ring all_reduce: no ppermutes at all
        fp = fingerprint_program(
            f"plan.{op_name}.{alg}", prog, (torch.zeros(shape),), path=path,
            mesh_axes=(plan_driver.AXIS,), world=W,
        )
        out.append((fp, ProgramMeta(expected_perms=tuple(expected))))
    return out


def _traced_programs(group) -> List[Tuple[ProgramFingerprint, ProgramMeta]]:
    """Fingerprint the trace-time planner dispatch seam (`plan/traced.py`)
    with a seeded schedule table: the bodies TP/FSDP/ZeRO call sites run
    once `prepare()` has agreed a non-stock schedule. Each artifact's
    `expected_perms` pins the J002 consistency contract."""
    import torch

    from ..plan import driver as plan_driver
    from ..plan import schedules, topology, traced

    AXIS = plan_driver.AXIS
    W = group.size()
    path = f"{_PKG}/plan/traced.py"
    topo = topology.Topology(W, (tuple(range(W)),), "cpu")
    n, m, k, p = 8, 2, 4, 3
    ring_rounds = tuple(
        tuple(sorted((i, (i + 1) % W) for i in range(W)))
        for _ in range(W - 1)
    )

    def _expected(op, alg):
        if op == "all_reduce" and alg == "ring":
            return ()  # psum_scatter + all_gather body: no ppermutes
        return expected_perms_from_plan(schedules.synthesize(op, alg, W, n, topo))

    cases = [
        ("all_reduce", alg, lambda t: traced.all_reduce(t, AXIS, reduce_kind="sum"),  # distlint: disable=R004 -- seeded-table catalog body: the axis routes it, no group dispatch under test
         (torch.zeros((W, n)),), n * 4, _expected("all_reduce", alg))
        for alg in ("ring", "rhd")
        if plan_driver.supports("all_reduce", alg, W, "sum")
    ]
    cases.append(("all_gather", "ring", lambda t: traced.all_gather(t, AXIS, dim=0, tiled=True),  # distlint: disable=R004 -- seeded-table catalog body: the axis routes it, no group dispatch under test
                  (torch.zeros((W, n)),), n * 4, _expected("all_gather", "ring")))
    cases.append(("reduce_scatter", "ring",
                  lambda t: traced.reduce_scatter(t, AXIS, reduce_kind="sum"),  # distlint: disable=R004 -- seeded-table catalog body: the axis routes it, no group dispatch under test
                  (torch.zeros((W, W * n)),), W * n * 4, _expected("reduce_scatter", "ring")))
    # the overlapped collective-matmul: its own ppermute loop (one ring
    # hop per round)
    cases.append(("all_gather_matmul", "ring",
                  lambda t, wm: traced.all_gather_matmul(t, wm, AXIS),  # distlint: disable=R004 -- seeded-table catalog body: the axis routes it, no group dispatch under test
                  (torch.zeros((W, m, k)), torch.zeros((k, p))), m * k * 4, ring_rounds))

    out = []
    # pin the dispatch ladder to the seeded table: planner env off (no
    # force/planner fallbacks), overlap on (decomposed gathers)
    with scoped_env(TDX_COLLECTIVE_PLANNER="0", TDX_PLANNER_FORCE=None, TDX_PLANNER_OVERLAP="1"):
        try:
            for op_name, alg, body, args, nbytes, expected in cases:
                traced.reset()
                traced.seed("all_gather" if op_name == "all_gather_matmul" else op_name, alg,
                            world=W, nbytes=nbytes, source="proglint")
                fp = fingerprint_program(
                    f"plan.traced.{op_name}.{alg}", body, args, path=path,
                    mesh_axes=(AXIS,), world=W,
                )
                out.append((fp, ProgramMeta(expected_perms=tuple(expected))))
        finally:
            traced.reset()
    return out


def _quant_programs(group) -> List[Tuple[ProgramFingerprint, ProgramMeta]]:
    import torch

    from ..ops.quant import quantized_all_reduce

    W = group.size()
    fp = fingerprint_program(
        "ops.quantized_all_reduce",
        lambda t: quantized_all_reduce(t, group),
        (torch.zeros((W, 512)),),
        path=f"{_PKG}/ops/quant.py",
        mesh_axes=tuple(group.mesh.axis_names),
        world=W,
    )
    return [(fp, ProgramMeta(quantized_wire=True))]


_BUILT: List = []


def build_repo_programs() -> List[Tuple[ProgramFingerprint, ProgramMeta]]:
    """Fingerprint every registered program of the port at tiny shapes, in
    driver mode at world 2 on the CPU (each program runs once; the DDP
    steps take one step of a 4x3 linear model, through the seam). Built
    once a process: a driver-mode default group of 2 CPU ranks is brought
    up for the build when none exists (and torn down after), else the
    default group's first two ranks are used."""
    if _BUILT:
        return list(_BUILT[0])
    import torch

    from .. import distributed as dist

    owned = not dist.is_initialized()
    if owned:
        dist.init_process_group(world_size=2, device="cpu")
    try:
        group = dist._get_default_group()
        if dist._world.mode != "driver" or group.device.type != "cpu" or group.size() < 2:
            raise RuntimeError(
                "proglint: builds the port's programs in driver mode on the CPU "
                "(no default group, or a driver-mode CPU group of >= 2 ranks)"
            )
        if group.size() != 2:
            group = dist.new_group([0, 1])
        out: List[Tuple[ProgramFingerprint, ProgramMeta]] = []
        with torch.no_grad():
            out.extend(_serve_programs())
        out.extend(_ddp_programs(group))
        with torch.no_grad():
            out.extend(_plan_programs(group))
            out.extend(_traced_programs(group))
            out.extend(_quant_programs(group))
    finally:
        if owned:
            dist.destroy_process_group()
    _BUILT.append(out)
    return list(out)


# ---------------------------------------------------------------------------
# config + lint entry + corpus
# ---------------------------------------------------------------------------


@dataclass
class ProglintConfig:
    severity: Dict[str, str] = field(default_factory=dict)
    corpus: str = "tests/fixtures/proglint_torch"


def load_config(root: str = ".") -> ProglintConfig:
    """``[tool.proglint]`` from the port's lint config under ``root``
    (missing → defaults). A severity entry for a not-owed rule raises
    `NotOwedRuleError` with its reason."""
    cfg = ProglintConfig()
    section = load_config_section(root, "proglint")
    if "corpus" in section:
        cfg.corpus = str(section["corpus"])
    cfg.severity = parse_severity_table(section, "proglint")
    for rule in cfg.severity:
        if rule in NOT_OWED:
            raise NotOwedRuleError(
                f"[tool.proglint.severity] names {rule}: {NOT_OWED[rule]}"
            )
    return cfg


def lint_repo_programs(
    root: str = ".",
    pairs: Optional[List[Tuple[ProgramFingerprint, ProgramMeta]]] = None,
    config: Optional[ProglintConfig] = None,
) -> List[Finding]:
    """J001, J002 and J004 over the port's registered programs, with J001
    fed by distlint's harvested mesh-axis registry (one source of truth)."""
    config = config or load_config(root)
    axes = harvested_mesh_axes(root)
    if pairs is None:
        pairs = build_repo_programs()
    findings: List[Finding] = []
    for fp, meta in pairs:
        findings.extend(
            check_fingerprint(
                fp,
                registry_axes=axes,
                quantized_wire=meta.quantized_wire,
                expected_perms=meta.expected_perms,
                suppress=meta.suppress,
                severity=config.severity,
            )
        )
    return findings


def corpus_diff(
    pairs: List[Tuple[ProgramFingerprint, ProgramMeta]],
    corpus_dir: str,
    names: Optional[Sequence[str]] = None,
) -> List[str]:
    """Drift report between live fingerprints and the golden corpus: one
    line per divergence (missing file, changed collective sequence).
    Empty list == no drift."""
    problems: List[str] = []
    wanted = set(names) if names is not None else None
    for fp, _ in pairs:
        if wanted is not None and fp.name not in wanted:
            continue
        fn = os.path.join(corpus_dir, fp.name.replace("/", "_") + ".json")
        if not os.path.isfile(fn):
            problems.append(
                f"{fp.name}: no golden corpus entry at {fn} "
                "(run --update-corpus)"
            )
            continue
        with open(fn, "r", encoding="utf-8") as fh:
            want = json.load(fh)
        have = fp.canonical()
        if have == want:
            continue
        mine = [
            f"{fp.name}: {key} drifted from the golden corpus: "
            f"have {have.get(key)!r}, corpus {want.get(key)!r}"
            for key in ("eqns", "mesh_axes", "world")
            if have.get(key) != want.get(key)
        ]
        if not mine and have["digest"] != want.get("digest"):
            # per-field lists match but the recorded digest does not
            # (hand-edited corpus entry)
            mine = [
                f"{fp.name}: digest drifted "
                f"({want.get('digest')} -> {have['digest']})"
            ]
        problems.extend(mine)
    return problems


def write_corpus(
    pairs: List[Tuple[ProgramFingerprint, ProgramMeta]],
    corpus_dir: str,
    names: Optional[Sequence[str]] = None,
) -> int:
    os.makedirs(corpus_dir, exist_ok=True)
    wanted = set(names) if names is not None else None
    n = 0
    for fp, _ in pairs:
        if wanted is not None and fp.name not in wanted:
            continue
        fn = os.path.join(corpus_dir, fp.name.replace("/", "_") + ".json")
        with open(fn, "w", encoding="utf-8") as fh:
            json.dump(fp.canonical(), fh, indent=1, sort_keys=True)
            fh.write("\n")
        n += 1
    return n


# Golden-corpus membership (the drift gate in tier-1): the paged decode
# step, the ZeRO train step, and the ppermute-carrying planner bodies.
CORPUS_PROGRAMS = (
    "serve.paged.step",
    "ddp.train_step.zero",
    "plan.all_reduce.ring",
    "plan.all_reduce.rhd",
    "plan.all_gather.ring",
    "plan.reduce_scatter.ring",
)


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------


_INFO_URI = f"{_PKG}/tools/proglint.py"


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="proglint",
        description=(
            "program-plane analyzer (rules J001, J002, J004, J005) over "
            "the port's registered programs"
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
    ap.add_argument("--explain", metavar="RULE", help="describe one rule and exit")
    ap.add_argument(
        "--list", action="store_true",
        help="list registered programs + fingerprints, run no rules",
    )
    ap.add_argument(
        "--corpus", action="store_true",
        help="also gate the golden corpus (config [tool.proglint] corpus)",
    )
    ap.add_argument(
        "--update-corpus", action="store_true",
        help="rewrite the golden corpus from the live fingerprints",
    )
    args = ap.parse_args(argv)
    if args.explain:
        try:
            print(explain_rule(args.explain))
        except NotOwedRuleError as e:
            print(f"proglint: {e}", file=sys.stderr)
            return 2
        except KeyError:
            print(f"proglint: unknown rule {args.explain!r}", file=sys.stderr)
            return 2
        return 0
    if args.update_baseline and not args.baseline:
        print(
            "proglint: --update-baseline requires --baseline FILE",
            file=sys.stderr,
        )
        return 2

    try:
        config = load_config(args.root)
    except ValueError as e:
        print(f"proglint: {e}", file=sys.stderr)
        return 2
    pairs = build_repo_programs()

    if args.list:
        for fp, meta in pairs:
            tags = []
            if meta.quantized_wire:
                tags.append("quantized-wire")
            if meta.expected_perms is not None:
                tags.append("plan-artifact")
            print(
                f"{fp.name}  digest={fp.digest}  eqns={len(fp.eqns)}"
                + (f"  [{', '.join(tags)}]" if tags else "")
            )
        return 0

    findings = lint_repo_programs(args.root, pairs, config)

    corpus_problems: List[str] = []
    corpus_dir = os.path.join(args.root, config.corpus)
    if args.update_corpus:
        n = write_corpus(pairs, corpus_dir, CORPUS_PROGRAMS)
        print(f"proglint: corpus updated ({n} programs)", file=sys.stderr)
    elif args.corpus:
        corpus_problems = corpus_diff(pairs, corpus_dir, CORPUS_PROGRAMS)

    stale_entries: List[Dict] = []
    if args.baseline:
        try:
            baseline = load_baseline(args.baseline)
        except FileNotFoundError:
            baseline = {"findings": []}
        except (OSError, ValueError) as e:
            print(f"proglint: {e}", file=sys.stderr)
            return 2
        _, _, stale_entries = apply_baseline(findings, baseline)
        if args.update_baseline:
            try:
                n = write_baseline(
                    args.baseline,
                    findings,
                    allow_growth=args.force_baseline_growth,
                    tool="proglint",
                )
            except ValueError as e:
                print(f"proglint: {e}", file=sys.stderr)
                return 2
            print(f"proglint: baseline updated ({n} entries)", file=sys.stderr)

    if args.format == "json":
        print(json.dumps([f.to_dict() for f in findings], indent=2))
    elif args.format == "sarif":
        print(
            json.dumps(
                render_sarif(
                    findings,
                    args.show_suppressed,
                    baseline_mode=bool(args.baseline),
                    tool_name="proglint",
                    rules=RULES,
                    information_uri=_INFO_URI,
                    fingerprint_key="proglint/v1",
                ),
                indent=2,
            )
        )
    else:
        print(render_report(findings, args.show_suppressed, tool="proglint"))
    for p in corpus_problems:
        print(f"proglint: corpus drift: {p}", file=sys.stderr)
    if stale_entries:
        print(
            f"proglint: {len(stale_entries)} stale baseline entr"
            f"{'y' if len(stale_entries) == 1 else 'ies'}: run "
            "--update-baseline to shrink the ratchet",
            file=sys.stderr,
        )
    active = [
        f
        for f in findings
        if not f.suppressed and not f.baselined and f.severity == "error"
    ]
    return 1 if (active or corpus_problems) else 0


if __name__ == "__main__":
    sys.exit(main())
