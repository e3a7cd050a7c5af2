"""numlint — the port's numerics/determinism-plane analyzer and geometry
parity sweeper.

The port of the reference's `tools/numlint.py`. The other guard planes
check *structure*: distlint proves the SOURCE cannot diverge, proglint
pins the PROGRAMS' collective sequences, storelint the coordination KEY
SPACE. None of them checks *values*: a dtype drift, an
accumulation-order change or a reused PRNG key sails through them until
a parity test happens to trip. numlint enforces the port's NUMERICS
CONTRACTS (`@numerics_contract` in `numerics.py`: the bitwise ZeRO
update and checkpoint round trip, the token-exact serve and migration
streams, the tolerance envelopes of the codecs).

Static half: rules over distlint's whole-project call graph, with
contract reachability propagated along call edges (a helper CALLED BY a
bitwise-contracted function is itself on a bitwise path):

  N001  matmul-family call (`matmul`, `mm`, `bmm`, `einsum`,
        `tensordot`, `linear`, `addmm`, `baddbmm`, `conv*d`, the `@`
        operator) on a bitwise-contract path in a module with
        low-precision evidence (bf16/fp16/fp8), whose operands are not
        made float32 at the call (`.float()`, `.to(torch.float32)`,
        `dtype=torch.float32`) and whose result dtype is not stated
        (`out_dtype=`): on the card a bf16 product may reduce in reduced
        precision (`torch.backends.cuda.matmul.
        allow_bf16_reduced_precision_reduction`), so library code pins
        per call
  N002  geometry-dependent reduction-order decomposition (the
        `nn/functional.py` collectives `reduce_scatter`, `all_gather`,
        `all_to_all`, `all_to_all_single`, `ppermute`, and the
        `ProcessGroup` forms `reduce_scatter_tensor`,
        `all_gather_into_tensor`) reachable from a bitwise contract and
        not whitelisted parity-preserving in `[tool.numlint]`
  N003  quantize encode whose scale plane is discarded at the call site,
        or whose paired decode is never called project-wide (codec
        family registry)
  N004  checkpoint save-side dtype cast (`.astype`, `.to(<dtype>)`,
        `.half()`, `.bfloat16()`, `.float()`, `.double()`) with no
        load-side dtype restore (save/load family registry)
  N005  PRNG key of `prng.py` (`PRNGKey`, `split`, `uniform`, `gumbel`,
        `categorical`, `random_bits`) consumed twice (or loop-consumed)
        without an intervening `split` rebind on a token-exact or bitwise
        path; and, on a token-exact path, a `torch.Generator` re-seeded
        (`manual_seed`), the torch form of reuse (two draws from one
        generator are not a reuse: it advances its own state)
  N006  host nondeterminism feeding traced values: time-family /
        host-random calls or set-literal iteration inside a function
        distlint marks trace-context (R011's roots: `torch.compile`, the
        `torch.func` transforms, `torch.vmap`, checkpoint)
  N007  test tolerance looser than the contract tier it verifies
        (`torch.testing.assert_close`, `torch.allclose`, `torch.isclose`
        beside numpy's): bitwise/token_exact claims verified with ANY
        nonzero rtol/atol, tolerance claims verified looser than the
        decorator's declared envelope

Toolchain (human/json/SARIF, content-fingerprint baseline ratchet,
reasoned comment suppressions `# numlint: disable=Nnnn -- reason`,
`[tool.numlint]` in `pytorch_distributed_example_tpu_torch/tools/
lint.toml`) is the shared `tools/_lintcore.py`.

Dynamic half (``--sweep``): runs the registered contracts as the port's
own programs across a geometry matrix (world size x planner schedule x
lowering mode, in driver mode), hashes the raw bytes of every output
tensor, and on divergence names the FIRST DIVERGENT OP: each variant
runs under a `TorchDispatchMode` that records every aten op (name,
shapes, dtypes, a hash of its outputs), with the collectives of the two
seams (`schedule.tap`) in the same stream, and the report names the
first index where the streams differ in structure, else in bits.
``--seed-revert pr10`` re-runs the ZeRO-update subject with the AVG
reduce-scatter reassociated into ``sum(x/w)`` (the class the bitwise
ZeRO claim forbids) and REQUIRES the sweep to catch and localize it at
every eligible geometry, after checking that the revert changes the
update's bits there, so the gate can never silently lose its teeth.
``TDX_NUMLINT_SWEEP=quick`` (or ``--quick``) bounds each subject to its
first two geometries; the full matrix runs otherwise.

Both halves run on the CPU, as the reference's do (its sweep forces the
CPU platform): they are host tools, not a fallback from the card.
"""

from __future__ import annotations

import argparse
import ast
import contextlib
import fnmatch
import hashlib
import json
import os
import re
import sys
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence, Set, Tuple

from ._lintcore import (
    Finding,
    apply_baseline,
    load_baseline,
    load_config_section,
    parse_severity_table,
    parse_suppressions,
    render_report,
    render_sarif,
    scoped_env,
    write_baseline,
)
from .distlint import FunctionInfo, ModuleInfo, Project, build_project
from .distlint import load_config as _load_distlint_config

__all__ = [
    "RULES",
    "NumlintConfig",
    "load_config",
    "harvest_contracts",
    "contract_reach",
    "run_rules",
    "lint",
    "SUBJECTS",
    "first_divergence",
    "run_sweep",
    "main",
]

RULES = {
    "N001": "matmul without a float32 operand cast or out_dtype on a "
            "bitwise-contract path (low-precision module)",
    "N002": "geometry-dependent reduction-order decomposition reachable "
            "from a bitwise contract, not whitelisted parity-preserving",
    "N003": "quantize encode without a scale-plane-paired decode "
            "(scale discarded, or paired decoder never called)",
    "N004": "checkpoint save-side dtype cast with no load-side restore "
            "(save/load dtype skew)",
    "N005": "PRNG key reuse without a split rebind, or a re-seeded "
            "generator, on a token-exact/bitwise path",
    "N006": "host nondeterminism (time/host-random/set iteration) inside "
            "a traced context",
    "N007": "test tolerance looser than the contract tier it verifies",
}

_INFO_URI = "pytorch_distributed_example_tpu_torch/tools/numlint.py"

# The port package, the card smoke script and the port's tests.
DEFAULT_PATHS = [
    "pytorch_distributed_example_tpu_torch",
    "chip_smoke.py",
    "tests/test_torch_*.py",
]
# every fixture corpus carries DELIBERATE findings and stays out of the
# self-scan
DEFAULT_EXCLUDE = ["csrc/", "tests/fixtures/"]

# `path-glob::name-glob` pairs whose reduction-order decomposition is
# PROVED parity-preserving: the ZeRO wire shape (the bitwise ZeRO tests
# cover exactly these three: reduce-scatter chunk i sums in the same
# order the all-reduce sums element i, and the update's all-gather
# moves bits, it never re-reduces them).
DEFAULT_PARITY_PRESERVING = [
    "pytorch_distributed_example_tpu_torch/parallel/zero.py::reduce_scatter_mean",
    "pytorch_distributed_example_tpu_torch/parallel/zero.py::unshard",
    "pytorch_distributed_example_tpu_torch/parallel/zero.py::shard_of",
]

# "encoder:decoder" trailing-name pairs: the scale-plane families
# (`ops/quant.py`).
DEFAULT_CODEC_FAMILIES = [
    "quantize_blockwise:dequantize_blockwise",
    "quantize_blockwise_fp8:dequantize_blockwise_fp8",
    "quantize_kv:dequantize_kv",
    "_wire_encode:_wire_decode",
]

# "save:load" trailing-name pairs for N004 (`checkpoint.py`,
# `checkpoint_sharded.py`).
DEFAULT_CHECKPOINT_FAMILIES = [
    "save_checkpoint:load_checkpoint",
    "dcp_save:dcp_load",
]

# matmul-family trailing call names whose accumulation dtype floats with
# the backend unless pinned.
_MATMUL_NAMES = {
    "matmul",
    "mm",
    "bmm",
    "einsum",
    "tensordot",
    "linear",
    "addmm",
    "baddbmm",
    "conv1d",
    "conv2d",
    "conv3d",
}

# evidence that a module actually mixes precisions (N001 stays quiet in
# pure-f32 code: the product is deterministic per geometry there).
_LOW_PRECISION_RE = re.compile(
    r"bfloat16|bf16|float16|fp16|float8|fp8|e4m3|e5m2|\bhalf\b", re.IGNORECASE
)

# dtype attribute names that count as a float32 (or wider) pin.
_F32_NAMES = {"float32", "float", "float64", "double"}
# zero-argument casting methods, and the ones that pin float32 or wider.
_CAST_METHODS = {"half", "bfloat16", "float", "double"}
_F32_METHODS = {"float", "double"}
# torch dtype attribute names (N004's `.to(<dtype>)` casts).
_DTYPE_NAMES = {
    "float16", "half", "bfloat16", "float32", "float", "float64", "double",
    "float8_e4m3fn", "float8_e5m2", "int8", "uint8", "int16", "int32", "int64",
}

# geometry-dependent decomposition surface for N002: each of these
# changes WHERE partial sums happen when the mesh changes.
_DECOMP_NAMES = {
    "reduce_scatter",
    "all_gather",
    "all_to_all",
    "all_to_all_single",
    "ppermute",
    "reduce_scatter_tensor",
    "all_gather_into_tensor",
}

# `prng.py` samplers: consuming a key twice through these forks replay.
_SAMPLER_NAMES = {"uniform", "gumbel", "categorical", "random_bits"}
# deriving ops: produce fresh keys, never "consume" for reuse purposes.
_KEY_DERIVE_NAMES = {"split", "fold_in", "PRNGKey", "clone"}

_TIME_ATTRS = {
    "time": {"time", "time_ns", "perf_counter", "perf_counter_ns",
             "monotonic", "monotonic_ns"},
    "os": {"urandom", "getrandom"},
    "uuid": {"uuid1", "uuid4"},
    "random": {"random", "randint", "randrange", "shuffle", "choice",
               "sample", "getrandbits", "gauss"},
}

_TOLERANCE_FN_NAMES = {"allclose", "assert_allclose", "isclose", "assert_close"}

# strictness order for N007 (strictest governs when a test touches
# several contracts).
_TIER_RANK = {"bitwise": 2, "token_exact": 1, "tolerance": 0}


# ---------------------------------------------------------------------------
# config
# ---------------------------------------------------------------------------


@dataclass
class NumlintConfig:
    paths: List[str] = field(default_factory=lambda: list(DEFAULT_PATHS))
    exclude: List[str] = field(default_factory=lambda: list(DEFAULT_EXCLUDE))
    parity_preserving: List[str] = field(
        default_factory=lambda: list(DEFAULT_PARITY_PRESERVING)
    )
    codec_families: List[str] = field(
        default_factory=lambda: list(DEFAULT_CODEC_FAMILIES)
    )
    checkpoint_families: List[str] = field(
        default_factory=lambda: list(DEFAULT_CHECKPOINT_FAMILIES)
    )
    severity: Dict[str, str] = field(default_factory=dict)

    def rule_severity(self, rule: str) -> str:
        return self.severity.get(rule, "error")


def load_config(root: str) -> NumlintConfig:
    """Read ``[tool.numlint]`` from the port's lint config under ``root``
    (missing file/section → defaults)."""
    cfg = NumlintConfig()
    section = load_config_section(root, "numlint")
    for name in (
        "paths",
        "exclude",
        "parity_preserving",
        "codec_families",
        "checkpoint_families",
    ):
        if name in section:
            setattr(cfg, name, [str(p) for p in section[name]])
    cfg.severity = parse_severity_table(section, "numlint")
    return cfg


# ---------------------------------------------------------------------------
# contract harvest + reachability
# ---------------------------------------------------------------------------


@dataclass
class ContractSite:
    fi: FunctionInfo
    tier: str
    rtol: Optional[float]
    atol: Optional[float]
    line: int


def _num_literal(node: ast.AST) -> Optional[float]:
    """Numeric value of a literal (handles unary minus); None if not a
    literal: a computed tolerance is out of static reach."""
    if isinstance(node, ast.Constant) and isinstance(node.value, (int, float)):
        return float(node.value)
    if (
        isinstance(node, ast.UnaryOp)
        and isinstance(node.op, ast.USub)
        and isinstance(node.operand, ast.Constant)
        and isinstance(node.operand.value, (int, float))
    ):
        return -float(node.operand.value)
    return None


def _decorator_contract(node: ast.AST) -> Optional[Tuple[str, Optional[float], Optional[float]]]:
    """(tier, rtol, atol) when ``node`` is a numerics_contract decorator."""
    if not isinstance(node, ast.Call):
        return None
    f = node.func
    name = f.id if isinstance(f, ast.Name) else (
        f.attr if isinstance(f, ast.Attribute) else None
    )
    if name != "numerics_contract":
        return None
    tier = None
    if node.args and isinstance(node.args[0], ast.Constant):
        tier = node.args[0].value
    if not isinstance(tier, str):
        return None
    rtol = atol = None
    for kw in node.keywords:
        if kw.arg == "rtol":
            rtol = _num_literal(kw.value)
        elif kw.arg == "atol":
            atol = _num_literal(kw.value)
    return tier, rtol, atol


def harvest_contracts(project: Project) -> Dict[int, ContractSite]:
    """id(FunctionInfo) -> ContractSite for every decorated function,
    harvested from the AST (no module is imported)."""
    out: Dict[int, ContractSite] = {}
    for minfo in project.modules.values():
        for fi in minfo.functions.values():
            for deco in getattr(fi.node, "decorator_list", None) or []:
                got = _decorator_contract(deco)
                if got is not None:
                    tier, rtol, atol = got
                    out[id(fi)] = ContractSite(
                        fi=fi, tier=tier, rtol=rtol, atol=atol,
                        line=getattr(fi.node, "lineno", 1),
                    )
                    break
    return out


def contract_reach(
    project: Project, contracts: Dict[int, ContractSite]
) -> Dict[int, Dict[str, Tuple[str, ...]]]:
    """id(fi) -> {tier: chain} for every function reachable DOWN the call
    graph from a contracted function (the contracted function itself
    included). BFS per contract root, so the recorded chain is a
    shortest path: the message a human debugs with."""
    reach: Dict[int, Dict[str, Tuple[str, ...]]] = {}
    for site in contracts.values():
        root = site.fi
        tier = site.tier
        seen: Set[int] = set()
        queue: List[Tuple[FunctionInfo, Tuple[str, ...]]] = [(root, (root.display,))]
        while queue:
            fi, chain = queue.pop(0)
            if id(fi) in seen or len(chain) > 8:
                continue
            seen.add(id(fi))
            tiers = reach.setdefault(id(fi), {})
            if tier not in tiers:
                tiers[tier] = chain
            for _line, callee in fi.edges:
                if id(callee) not in seen:
                    queue.append((callee, chain + (callee.display,)))
    return reach


def _callee_contracts(
    fi: FunctionInfo,
    contracts: Dict[int, ContractSite],
    _depth: int = 0,
    _seen: Optional[Set[int]] = None,
) -> List[ContractSite]:
    """Contracted functions transitively CALLED by ``fi`` (the N007
    direction: does this test verify a contract?)."""
    if _seen is None:
        _seen = set()
    if _depth > 6 or id(fi) in _seen:
        return []
    _seen.add(id(fi))
    out: List[ContractSite] = []
    for _line, callee in fi.edges:
        site = contracts.get(id(callee))
        if site is not None:
            out.append(site)
        out.extend(_callee_contracts(callee, contracts, _depth + 1, _seen))
    return out


# ---------------------------------------------------------------------------
# shared AST helpers
# ---------------------------------------------------------------------------


def _trailing_name(call: ast.Call) -> Optional[str]:
    f = call.func
    if isinstance(f, ast.Name):
        return f.id
    if isinstance(f, ast.Attribute):
        return f.attr
    return None


def _receiver_name(call: ast.Call) -> Optional[str]:
    """Leftmost Name of the call's receiver chain (`a` in a.b.c())."""
    f = call.func
    while isinstance(f, ast.Attribute):
        f = f.value
    if isinstance(f, ast.Name):
        return f.id
    return None


def _dtype_attr(node: ast.AST) -> Optional[str]:
    """`float32` for `torch.float32` (any `<x>.<dtype>` attribute)."""
    if isinstance(node, ast.Attribute) and node.attr in _DTYPE_NAMES:
        return node.attr
    return None


def _is_f32_cast(node: ast.AST) -> bool:
    """An expression made float32 (or wider) right there: `.float()`,
    `.double()`, `.to(torch.float32)`, `.to(dtype=torch.float32)`,
    `.type(torch.float32)`."""
    if not isinstance(node, ast.Call) or not isinstance(node.func, ast.Attribute):
        return False
    name = node.func.attr
    if name in _F32_METHODS and not node.args:
        return True
    if name in ("to", "type"):
        cands = list(node.args) + [kw.value for kw in node.keywords if kw.arg == "dtype"]
        return any(_dtype_attr(c) in _F32_NAMES for c in cands)
    return False


def _matmul_pinned(node: ast.AST) -> bool:
    """A matmul whose operands are made float32 at the call or whose
    result dtype is stated."""
    if isinstance(node, ast.BinOp):
        return _is_f32_cast(node.left) or _is_f32_cast(node.right)
    for kw in node.keywords:
        if kw.arg == "out_dtype":
            return True
        if kw.arg == "dtype" and _dtype_attr(kw.value) in _F32_NAMES:
            return True
    return any(_is_f32_cast(a) for a in node.args)


def _is_dtype_cast(node: ast.AST) -> bool:
    """N004's save-side cast: `.astype(...)`, `.to(<dtype>)`, `.type(<dtype>)`,
    `.half()` / `.bfloat16()` / `.float()` / `.double()`."""
    if not isinstance(node, ast.Call) or not isinstance(node.func, ast.Attribute):
        return False
    name = node.func.attr
    if name == "astype":
        return True
    if name in _CAST_METHODS and not node.args:
        return True
    if name in ("to", "type"):
        cands = list(node.args) + [kw.value for kw in node.keywords if kw.arg == "dtype"]
        return any(_dtype_attr(c) is not None for c in cands)
    return False


def _whitelisted(fi: FunctionInfo, patterns: Sequence[str]) -> bool:
    for pat in patterns:
        if "::" in pat:
            path_g, name_g = pat.split("::", 1)
        else:
            path_g, name_g = pat, "*"
        if fnmatch.fnmatch(fi.path, path_g) and fnmatch.fnmatch(fi.name, name_g):
            return True
    return False


def _split_families(entries: Sequence[str], what: str) -> List[Tuple[str, str]]:
    out = []
    for e in entries:
        if ":" not in e:
            raise ValueError(
                f"[tool.numlint] {what} entry {e!r} must be 'producer:consumer'"
            )
        a, b = e.split(":", 1)
        out.append((a.strip(), b.strip()))
    return out


# ---------------------------------------------------------------------------
# rules
# ---------------------------------------------------------------------------


def _emit(
    findings: List[Finding],
    cfg: NumlintConfig,
    path: str,
    node: ast.AST,
    rule: str,
    message: str,
    chain: Tuple[str, ...] = (),
) -> None:
    sev = cfg.rule_severity(rule)
    if sev == "off":
        return
    findings.append(
        Finding(
            path=path,
            line=getattr(node, "lineno", 1),
            col=getattr(node, "col_offset", 0) + 1,
            rule=rule,
            message=message,
            severity=sev,
            trace=chain,
        )
    )


def _rule_n001_n002(
    project: Project,
    cfg: NumlintConfig,
    reach: Dict[int, Dict[str, Tuple[str, ...]]],
    findings: List[Finding],
) -> None:
    for minfo in project.modules.values():
        low_prec_module = bool(_LOW_PRECISION_RE.search(minfo.src))
        for fi in minfo.functions.values():
            tiers = reach.get(id(fi))
            if not tiers or "bitwise" not in tiers:
                continue
            chain = tiers["bitwise"]
            for node in ast.walk(fi.node):
                is_matmul_op = isinstance(node, ast.BinOp) and isinstance(node.op, ast.MatMult)
                if not isinstance(node, ast.Call) and not is_matmul_op:
                    continue
                name = "@" if is_matmul_op else _trailing_name(node)
                if (is_matmul_op or name in _MATMUL_NAMES) and low_prec_module:
                    if not _matmul_pinned(node):
                        _emit(
                            findings, cfg, fi.path, node, "N001",
                            f"`{name}` on the bitwise-contract path "
                            f"`{' -> '.join(chain)}` neither makes its "
                            "operands float32 at the call nor states "
                            "`out_dtype=` in a module that mixes "
                            "precisions; on the card a bf16 product may "
                            "reduce in reduced precision "
                            "(torch.backends.cuda.matmul."
                            "allow_bf16_reduced_precision_reduction), so "
                            "library callers pin per call",
                            chain,
                        )
                if name in _DECOMP_NAMES:
                    if _whitelisted(fi, cfg.parity_preserving):
                        continue
                    _emit(
                        findings, cfg, fi.path, node, "N002",
                        f"`{name}` decomposes the reduction order on the "
                        f"bitwise-contract path `{' -> '.join(chain)}`; "
                        "geometry changes reassociate its partial sums. "
                        "Prove parity and whitelist the enclosing "
                        "function under [tool.numlint] parity_preserving, "
                        "or demote the contract to 'tolerance'",
                        chain,
                    )


def _rule_n003(
    project: Project, cfg: NumlintConfig, findings: List[Finding]
) -> None:
    families = _split_families(cfg.codec_families, "codec_families")
    encoders = {enc: dec for enc, dec in families}
    # one project-wide pass: which trailing names are ever called?
    called: Set[str] = set()
    for minfo in project.modules.values():
        for node in ast.walk(minfo.tree):
            if isinstance(node, ast.Call):
                n = _trailing_name(node)
                if n:
                    called.add(n)
    for minfo in project.modules.values():
        for node in ast.walk(minfo.tree):
            # scale plane discarded at the assignment: q, _ = enc(...)
            if isinstance(node, ast.Assign) and isinstance(node.value, ast.Call):
                enc = _trailing_name(node.value)
                if enc in encoders and len(node.targets) == 1:
                    tgt = node.targets[0]
                    if (
                        isinstance(tgt, (ast.Tuple, ast.List))
                        and len(tgt.elts) >= 2
                        and isinstance(tgt.elts[1], ast.Name)
                        and tgt.elts[1].id.startswith("_")
                    ):
                        _emit(
                            findings, cfg, minfo.path, node, "N003",
                            f"`{enc}` scale plane bound to "
                            f"`{tgt.elts[1].id}` and discarded — the int8 "
                            "payload is undecodable without it (pair with "
                            f"`{encoders[enc]}`)",
                        )
            # payload-only projection: enc(...)[0]
            if (
                isinstance(node, ast.Subscript)
                and isinstance(node.value, ast.Call)
                and _trailing_name(node.value) in encoders
                and isinstance(node.slice, ast.Constant)
                and node.slice.value == 0
            ):
                enc = _trailing_name(node.value)
                _emit(
                    findings, cfg, minfo.path, node, "N003",
                    f"`{enc}(...)[0]` keeps the payload and drops the "
                    "scale plane — undecodable (pair with "
                    f"`{encoders[enc]}`)",
                )
            # encoder used while its paired decoder never appears
            if isinstance(node, ast.Call):
                enc = _trailing_name(node)
                if enc in encoders and encoders[enc] not in called:
                    _emit(
                        findings, cfg, minfo.path, node, "N003",
                        f"`{enc}` is called but its paired decoder "
                        f"`{encoders[enc]}` is never called anywhere in "
                        "the project — every consumer path reads raw "
                        "int8 without the scale plane",
                    )


def _local_subtrees(
    minfo: ModuleInfo, fi: FunctionInfo, depth: int = 2
) -> List[ast.AST]:
    """fi's body plus same-module helpers it calls (N004 looks through
    one save -> _to_host style hop)."""
    out = [fi.node]
    frontier = [fi.node]
    for _ in range(depth):
        nxt = []
        for sub in frontier:
            for node in ast.walk(sub):
                if isinstance(node, ast.Call):
                    name = _trailing_name(node)
                    callee = minfo.functions.get(name) if name else None
                    if callee is not None and callee.node not in out:
                        out.append(callee.node)
                        nxt.append(callee.node)
        frontier = nxt
    return out


def _rule_n004(
    project: Project, cfg: NumlintConfig, findings: List[Finding]
) -> None:
    families = _split_families(cfg.checkpoint_families, "checkpoint_families")
    # trailing name -> [(minfo, fi), ...]; a save is paired with the load
    # IN ITS OWN MODULE when one exists, falling back to the first
    # project-wide definition for split save/load modules
    by_name: Dict[str, List[Tuple[ModuleInfo, FunctionInfo]]] = {}
    for minfo in project.modules.values():
        for fi in minfo.functions.values():
            by_name.setdefault(fi.name.rsplit(".", 1)[-1], []).append((minfo, fi))
    for save_name, load_name in families:
        loads = by_name.get(load_name, [])
        if not loads:
            continue
        for save_minfo, save_fi in by_name.get(save_name, []):
            load_minfo, load_fi = next(
                ((lm, lf) for lm, lf in loads if lm.name == save_minfo.name),
                loads[0],
            )
            cast_sites = [
                node
                for sub in _local_subtrees(save_minfo, save_fi)
                for node in ast.walk(sub)
                if _is_dtype_cast(node)
            ]
            if not cast_sites:
                continue
            load_blob = "\n".join(
                ast.dump(sub) for sub in _local_subtrees(load_minfo, load_fi)
            )
            if "astype" in load_blob or "dtype" in load_blob:
                continue
            for node in cast_sites:
                _emit(
                    findings, cfg, save_minfo.path, node, "N004",
                    f"`{save_name}` casts leaves with "
                    f"`.{node.func.attr}` on the way out but `{load_name}` "
                    "never restores dtypes (no cast back and no dtype "
                    "manifest read) — a round-trip silently re-types the "
                    "live param tree",
                )


class _KeyFlow:
    """Linear-ish per-function key-consumption walker for N005."""

    def __init__(
        self,
        cfg: NumlintConfig,
        path: str,
        chain: Tuple[str, ...],
        findings: List[Finding],
    ):
        self.cfg = cfg
        self.path = path
        self.chain = chain
        self.findings = findings

    # -- expression scan: returns names consumed by samplers, in order
    def _consumptions(self, node: ast.AST) -> List[Tuple[str, ast.Call]]:
        out = []
        for sub in ast.walk(node):
            if isinstance(sub, ast.Call):
                name = _trailing_name(sub)
                if name in _SAMPLER_NAMES and sub.args:
                    arg = sub.args[0]
                    if isinstance(arg, ast.Name):
                        out.append((arg.id, sub))
        return out

    def _assigned_names(self, stmt: ast.stmt) -> Set[str]:
        names: Set[str] = set()
        targets: List[ast.AST] = []
        if isinstance(stmt, ast.Assign):
            targets = list(stmt.targets)
        elif isinstance(stmt, (ast.AugAssign, ast.AnnAssign)):
            targets = [stmt.target]
        elif isinstance(stmt, ast.For):
            targets = [stmt.target]
        for t in targets:
            for sub in ast.walk(t):
                if isinstance(sub, ast.Name):
                    names.add(sub.id)
        return names

    def run(self, body: List[ast.stmt], state: Dict[str, str]) -> None:
        for stmt in body:
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue  # nested defs have their own FunctionInfo/reach
            if isinstance(stmt, (ast.For, ast.While)):
                rebound = set()
                for inner in ast.walk(stmt):
                    if isinstance(inner, ast.stmt):
                        rebound |= self._assigned_names(inner)
                loop_body = stmt.body + getattr(stmt, "orelse", [])
                for name, call in self._consumptions(
                    ast.Module(body=loop_body, type_ignores=[])
                ):
                    if name in state and name not in rebound:
                        self._fire(name, call, looped=True)
                        state[name] = "consumed"
                # run the body once for ordinary double-use inside it
                self.run(loop_body, state)
                continue
            if isinstance(stmt, ast.If):
                s1, s2 = dict(state), dict(state)
                self.run(stmt.body, s1)
                self.run(stmt.orelse, s2)
                for k in set(s1) | set(s2):
                    if s1.get(k) == "consumed" or s2.get(k) == "consumed":
                        state[k] = "consumed"
                    else:
                        state[k] = s1.get(k, s2.get(k, "fresh"))
                continue
            # plain statement: consumptions left-to-right, then rebinds
            for name, call in self._consumptions(stmt):
                if state.get(name) == "consumed":
                    self._fire(name, call, looped=False)
                else:
                    state[name] = "consumed"
            for name in self._assigned_names(stmt):
                state[name] = "fresh"

    def _fire(self, name: str, call: ast.Call, looped: bool) -> None:
        how = (
            "consumed on every loop iteration without a split rebind "
            "inside the loop"
            if looped
            else "consumed twice without an intervening split rebind"
        )
        _emit(
            self.findings, self.cfg, self.path, call, "N005",
            f"PRNG key `{name}` {how} on the contract path "
            f"`{' -> '.join(self.chain)}` — identical samples / forked "
            "replay",
            self.chain,
        )


def _rule_n005(
    project: Project,
    cfg: NumlintConfig,
    reach: Dict[int, Dict[str, Tuple[str, ...]]],
    findings: List[Finding],
) -> None:
    for minfo in project.modules.values():
        for fi in minfo.functions.values():
            tiers = reach.get(id(fi))
            if not tiers:
                continue
            tier = (
                "token_exact" if "token_exact" in tiers
                else ("bitwise" if "bitwise" in tiers else None)
            )
            if tier is None:
                continue
            chain = tiers[tier]
            body = getattr(fi.node, "body", None)
            if not body:
                continue
            state: Dict[str, str] = {}
            # parameters named like keys start live
            args = getattr(fi.node, "args", None)
            if args is not None:
                for a in args.posonlyargs + args.args + args.kwonlyargs:
                    if re.search(r"key|rng|seed", a.arg, re.IGNORECASE):
                        state[a.arg] = "fresh"
            _KeyFlow(cfg, fi.path, chain, findings).run(body, state)
            if "token_exact" not in tiers:
                continue
            tchain = tiers["token_exact"]
            for node in _own_nodes(fi.node):
                if isinstance(node, ast.Call) and _trailing_name(node) == "manual_seed":
                    recv = _receiver_name(node) or "generator"
                    _emit(
                        findings, cfg, fi.path, node, "N005",
                        f"`{recv}.manual_seed` re-seeds a generator on the "
                        f"token-exact path `{' -> '.join(tchain)}` — its "
                        "stream restarts, so later draws repeat earlier "
                        "ones (derive a fresh key with `prng.split` "
                        "instead)",
                        tchain,
                    )


def _own_nodes(fn_node: ast.AST):
    """The nodes of a function body, nested defs excluded (they have their
    own FunctionInfo and reach)."""
    stack = list(getattr(fn_node, "body", []))
    while stack:
        node = stack.pop()
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
            continue
        yield node
        stack.extend(ast.iter_child_nodes(node))


def _rule_n006(
    project: Project, cfg: NumlintConfig, findings: List[Finding]
) -> None:
    for minfo in project.modules.values():
        # does bare `random` here mean the stdlib module?
        random_is_std = minfo.import_aliases.get("random") == "random"
        for fi in minfo.functions.values():
            if fi.trace_ctx is None:
                continue
            where = fi.trace_ctx.describe()
            for node in ast.walk(fi.node):
                if isinstance(node, ast.Call):
                    recv = _receiver_name(node)
                    name = _trailing_name(node)
                    mod_attrs = _TIME_ATTRS.get(recv or "", set())
                    if name in mod_attrs:
                        if recv == "random" and not random_is_std:
                            continue
                        _emit(
                            findings, cfg, fi.path, node, "N006",
                            f"host call `{recv}.{name}()` inside a traced "
                            f"context ({where}) — its value is baked into "
                            "the trace on ONE rank/run and replayed on "
                            "every other (nondeterministic constant "
                            "folding)",
                        )
                if isinstance(node, ast.For):
                    it = node.iter
                    is_set = isinstance(it, ast.Set) or (
                        isinstance(it, ast.Call) and _trailing_name(it) == "set"
                    )
                    if is_set:
                        _emit(
                            findings, cfg, fi.path, node, "N006",
                            "iteration over a set inside a traced context "
                            f"({where}) — set order is hash-seed "
                            "dependent, so the traced program differs "
                            "between processes",
                        )


def _rule_n007(
    project: Project,
    cfg: NumlintConfig,
    contracts: Dict[int, ContractSite],
    findings: List[Finding],
) -> None:
    for minfo in project.modules.values():
        for fi in minfo.functions.values():
            tail = fi.name.rsplit(".", 1)[-1]
            if not tail.startswith("test_"):
                continue
            sites = _callee_contracts(fi, contracts)
            if not sites:
                continue
            strictest = max(sites, key=lambda s: _TIER_RANK[s.tier])
            for node in ast.walk(fi.node):
                if not isinstance(node, ast.Call):
                    continue
                if _trailing_name(node) not in _TOLERANCE_FN_NAMES:
                    continue
                tols: Dict[str, float] = {}
                for kw in node.keywords:
                    if kw.arg in ("rtol", "atol"):
                        v = _num_literal(kw.value)
                        if v is not None:
                            tols[kw.arg] = v
                if not tols:
                    continue  # exact-default or non-literal: out of reach
                if strictest.tier in ("bitwise", "token_exact"):
                    loose = {k: v for k, v in tols.items() if v > 0.0}
                    if loose:
                        _emit(
                            findings, cfg, fi.path, node, "N007",
                            f"test verifies `{strictest.fi.display}` "
                            f"({strictest.tier} contract) with "
                            + ", ".join(f"{k}={v:g}" for k, v in sorted(loose.items()))
                            + " — a bitwise/token-exact claim admits NO "
                            "tolerance; compare exactly (or suppress with "
                            "the reason this assertion checks a different "
                            "property)",
                        )
                else:
                    over = []
                    if strictest.rtol is not None and tols.get("rtol", 0.0) > strictest.rtol:
                        over.append(f"rtol={tols['rtol']:g} > declared {strictest.rtol:g}")
                    if strictest.atol is not None and tols.get("atol", 0.0) > strictest.atol:
                        over.append(f"atol={tols['atol']:g} > declared {strictest.atol:g}")
                    if over:
                        _emit(
                            findings, cfg, fi.path, node, "N007",
                            f"test verifies `{strictest.fi.display}` "
                            "looser than its declared tolerance envelope "
                            f"({'; '.join(over)}) — the test would pass "
                            "on a codec that violates the claim",
                        )


# ---------------------------------------------------------------------------
# suppressions, fingerprints, lint()
# ---------------------------------------------------------------------------


def _apply_suppressions(findings: List[Finding], project: Project) -> None:
    cache: Dict[str, Tuple[Dict[int, Set[str]], Dict[str, int]]] = {}
    for f in findings:
        minfo = project.by_path.get(f.path)
        if minfo is None:
            continue
        if f.path not in cache:
            cache[f.path] = parse_suppressions(minfo.src, "numlint")
        per_line, file_wide = cache[f.path]
        if f.rule in per_line.get(f.line, set()) or f.rule in file_wide:
            f.suppressed = True


def _assign_fingerprints(findings: List[Finding]) -> None:
    """Content fingerprints over (path, rule, salient token) with an
    occurrence counter, stable across unrelated line moves (the
    reference's, so a finding has the same identity in both packages)."""
    occ: Dict[Tuple[str, str, str], int] = {}
    for f in sorted(findings, key=lambda f: (f.path, f.line, f.col)):
        m = re.search(r"`([^`]+)`", f.message)
        salient = m.group(1) if m else f.message[:60]
        key = (f.path, f.rule, salient)
        n = occ.get(key, 0)
        occ[key] = n + 1
        f.fingerprint = hashlib.sha1(
            f"{f.path}\x00{f.rule}\x00{salient}\x00{n}".encode()
        ).hexdigest()[:16]


def run_rules(project: Project, cfg: NumlintConfig) -> List[Finding]:
    contracts = harvest_contracts(project)
    reach = contract_reach(project, contracts)
    findings: List[Finding] = []
    _rule_n001_n002(project, cfg, reach, findings)
    _rule_n003(project, cfg, findings)
    _rule_n004(project, cfg, findings)
    _rule_n005(project, cfg, reach, findings)
    _rule_n006(project, cfg, findings)
    _rule_n007(project, cfg, contracts, findings)
    # nested defs are walked inside their enclosing function too: dedup
    seen: Set[Tuple[str, int, int, str]] = set()
    uniq: List[Finding] = []
    for f in sorted(findings, key=lambda f: (f.path, f.line, f.col, f.rule)):
        key = (f.path, f.line, f.col, f.rule)
        if key not in seen:
            seen.add(key)
            uniq.append(f)
    return uniq


def lint(
    root: str = ".", config: Optional[NumlintConfig] = None
) -> Tuple[List[Finding], Project]:
    """The full static half: project build (distlint's call graph with
    numlint's path scope), contract harvest, rules, suppressions,
    fingerprints."""
    config = config or load_config(root)
    dl_cfg = _load_distlint_config(root)
    dl_cfg.paths = list(config.paths)
    dl_cfg.exclude = list(config.exclude)
    project = build_project(config.paths, root, dl_cfg)
    findings = run_rules(project, config)
    _apply_suppressions(findings, project)
    _assign_fingerprints(findings)
    return findings, project


# ---------------------------------------------------------------------------
# dynamic half: geometry parity sweep
# ---------------------------------------------------------------------------
#
# Each SUBJECT realizes one registered contract as the port's own program
# and runs it across a geometry matrix in driver mode on the CPU. Outputs
# are hashed BITWISE; a bitwise-tier divergence (or a tolerance-tier
# envelope violation) is localized to the first divergent op.


def _bytes_of(t) -> bytes:
    """The raw bytes of a tensor (any dtype, bfloat16 included)."""
    import torch

    t = t.detach().cpu().contiguous().reshape(-1)
    return t.view(torch.uint8).numpy().tobytes() if t.numel() else b""


def _tensors(values) -> List[Any]:
    import torch
    from torch.utils import _pytree as pytree

    return [v for v in pytree.tree_leaves(values) if isinstance(v, torch.Tensor)]


def _tree_hash(values) -> str:
    h = hashlib.sha256()
    for t in _tensors(values):
        h.update(str(t.dtype).encode())
        h.update(_bytes_of(t))
    return h.hexdigest()[:16]


def _op_tape():
    """A TorchDispatchMode that records every aten op run under it as
    (structure, bits hash, outputs), structure being the op's name and its
    tensor inputs' and outputs' shapes and dtypes."""
    from torch.utils._python_dispatch import TorchDispatchMode

    def sig(values) -> str:
        return ",".join(
            f"{str(t.dtype).removeprefix('torch.')}[{'x'.join(str(d) for d in t.shape)}]"
            for t in _tensors(values)
        )

    class _Tape(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.stream: List[Tuple[str, str, List[Any]]] = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            outs = [t.detach().clone() for t in _tensors(out)]
            self.stream.append((f"{func} {sig((args, kwargs))} -> {sig(out)}",
                                _tree_hash(outs), outs))
            return out

        def collective(self, source, op, axes, shape, dtype, params):
            desc = (f"collective {op}|axes={','.join(axes)}|"
                    f"{dtype}[{'x'.join(str(d) for d in shape)}]|"
                    + ",".join(f"{k}={v}" for k, v in sorted(params.items())))
            self.stream.append((desc, "", []))

    return _Tape()


def _recorded(fn) -> Tuple[List[Tuple[str, str, List[Any]]], Any]:
    """(op stream, result) of one call of ``fn``: the aten ops under the
    dispatch mode, the collectives of the two seams in the same stream."""
    from .. import schedule

    tape = _op_tape()
    with schedule.tap(tape.collective), tape:
        out = fn()
    return tape.stream, out


def first_divergence(fn_a, fn_b) -> str:
    """Localize why two program variants diverge: structural alignment of
    their op streams first (a reordered reduction shows up HERE: the
    pr10 revert class), then the first op whose outputs differ in bits."""
    sa, _ = _recorded(fn_a)
    sb, _ = _recorded(fn_b)
    for i, (a, b) in enumerate(zip(sa, sb)):
        if a[0] != b[0]:
            return f"first divergent op #{i + 1}: subject `{a[0]}` vs reference `{b[0]}`"
    if len(sa) != len(sb):
        i = min(len(sa), len(sb))
        longer, who = (sa, "subject") if len(sa) > len(sb) else (sb, "reference")
        return f"first divergent op #{i + 1}: {who} carries extra op `{longer[i][0]}`"
    for i, (a, b) in enumerate(zip(sa, sb)):
        if a[1] != b[1]:
            delta = max(
                (float((x.double() - y.double()).abs().max()) for x, y in zip(a[2], b[2])
                 if x.shape == y.shape and x.numel() and x.is_floating_point()),
                default=float("nan"),
            )
            return (f"first divergent op #{i + 1}: `{a[0]}` outputs differ "
                    f"(max |delta| = {delta:.3g})")
    return f"op streams identical over {len(sa)} ops, outputs included"


# -- subjects ---------------------------------------------------------------


def _det_array(n: int, scale: float = 0.37, bias: float = 1.23):
    """Deterministic non-trivial-mantissa data (no host RNG: N006)."""
    import torch

    i = torch.arange(n, dtype=torch.float32)
    return torch.sin(i * scale + bias) * (1.0 + 0.01 * i)


@contextlib.contextmanager
def _cpu_world():
    """A driver-mode default group of 8 CPU ranks for the sweep (torn down
    after), or the caller's own driver-mode CPU group."""
    from .. import distributed as dist

    owned = not dist.is_initialized()
    if owned:
        dist.init_process_group(world_size=8, device="cpu")
    try:
        g = dist._get_default_group()
        if dist._world.mode != "driver" or g.device.type != "cpu":
            raise RuntimeError("numlint sweep: runs in driver mode on the CPU")
        yield g
    finally:
        if owned:
            dist.destroy_process_group()


def _group_of(world: int):
    from .. import distributed as dist

    g = dist._get_default_group()
    if g.size() < world:
        raise RuntimeError(f"numlint sweep: needs a CPU world of {world}, have {g.size()}")
    return g if g.size() == world else dist.new_group(list(range(world)))


# the ZeRO subject's update: momentum SGD over 2 steps. The gradients are
# O(1) against O(1e-2) params and lr 1, so the update carries the
# gradient's low bits into the params instead of rounding them away.
_Z_N, _Z_STEPS, _Z_LR, _Z_MOM = 257, 2, 1.0, 0.9


def _zero_data(world: int):
    G = _det_array(world * _Z_STEPS * _Z_N).reshape(world, _Z_STEPS, _Z_N)
    p = _det_array(_Z_N, scale=0.11, bias=0.7) * 0.01
    return G, p


def _zero_update_fn(world: int, rs_impl=None):
    """The ZeRO-sharded momentum-SGD update of the port (`parallel/zero.py`:
    the layout's packed gradients reduce-scattered to their owners, the
    owned shards updated, the params all-gathered back): returns the
    gathered params."""
    from ..parallel import zero

    def run():
        import torch

        g = _group_of(world)
        rs = rs_impl or zero.reduce_scatter_mean
        G, p = _zero_data(world)
        layout = zero.ShardLayout([(_Z_N,)], world)
        psh = zero.shard_rows({"p": p}, g)["p"]
        msh = torch.zeros_like(psh)
        for s in range(_Z_STEPS):
            gsh = rs(layout.pack([G[:, s]], lead=1), g)
            msh = _Z_MOM * msh + gsh
            psh = psh - _Z_LR * msh
        return layout.unpack(zero.unshard(psh, g))[0]

    return run


def _zero_reference_fn(world: int):
    """The unsharded DDP update (AVG all-reduce, then the full elementwise
    update): what the sharded path must match bitwise."""
    from .. import distributed as dist
    from ..tensor import DistTensor
    from ..types import ReduceOp

    def run():
        import torch

        g = _group_of(world)
        G, p = _zero_data(world)
        m = torch.zeros_like(p)
        for s in range(_Z_STEPS):
            gbar = DistTensor.wrap(G[:, s].clone(), g)
            dist.all_reduce(gbar, ReduceOp.AVG, g)
            m = _Z_MOM * m + gbar.tensor[0]
            p = p - _Z_LR * m
        return p

    return run


def _perturbed_reduce_scatter_mean(packed, group):
    """The seeded pr10 revert: the mean division reassociated INTO the
    scatter (sum(x)/w -> sum(x/w)): the same collective on the same
    shapes, a different reduction order, bitwise-divergent in float32."""
    from .. import distributed as dist
    from ..tensor import DistTensor
    from ..types import ReduceOp

    return dist.reduce_scatter(
        DistTensor.wrap(packed / group.size(), group), ReduceOp.SUM, group
    ).tensor


def _run_zero_update(geom: Dict[str, Any], rs_impl=None) -> Dict[str, Any]:
    world = geom["world"]
    sub_fn = _zero_update_fn(world, rs_impl)
    ref_fn = _zero_reference_fn(world)
    sub, ref = sub_fn(), ref_fn()
    ok = _bytes_of(sub) == _bytes_of(ref)
    detail = ""
    if not ok:
        # localize the SHARDED variant against the shipped sharded update
        # when an impl override diverged (the seed-revert path); against
        # the reference program otherwise
        base = _zero_update_fn(world) if rs_impl is not None else ref_fn
        detail = first_divergence(sub_fn, base)
        detail += f"; max output |delta| = {float((sub - ref).abs().max()):.3g}"
    return {"ok": ok, "detail": detail, "hash": _tree_hash(sub)}


def _run_planned_allreduce(geom: Dict[str, Any]) -> Dict[str, Any]:
    """world x algorithm x lowering-mode parity for planned all-reduce.

    ``mode``:
      - ``eager``        — `plan/driver.py::compiled_body`, the eager
        planner's program;
      - ``traced``       — the trace-time dispatch seam (`plan/traced.py`)
        reading a seeded agreed-table entry, what TP/FSDP/ZeRO call
        sites run after `prepare()`;
      - ``traced_force`` — the same seam driven by `TDX_PLANNER_FORCE`
        (empty table).

    Traced modes must be BITWISE the eager body for the same algorithm
    (both run `driver.body_for`); a mismatch is localized to the first
    divergent op. Every mode keeps the envelope contract: ranks agree
    bitwise, and the result is within 1e-5 of the exact float32 sum."""
    import torch

    from ..plan import driver, traced

    world, alg = geom["world"], geom["schedule"]
    mode = geom.get("mode", "eager")
    eager_prog = driver.compiled_body("all_reduce", alg, world, driver.AXIS)
    x = _det_array(world * 64).reshape(world, 64)

    if mode == "eager":
        env: Dict[str, Optional[str]] = {}
    elif mode == "traced_force":
        env = {"TDX_COLLECTIVE_PLANNER": "1", "TDX_PLANNER_FORCE": alg}
    else:
        env = {"TDX_PLANNER_FORCE": None}
    with scoped_env(**env):
        try:
            if mode == "eager":
                sub_fn = lambda: eager_prog(x)  # noqa: E731
            else:
                traced.reset()
                if mode == "traced":
                    traced.seed("all_reduce", alg, world=world, nbytes=64 * 4,
                                source="numlint-sweep")

                def sub_fn():
                    with torch.no_grad():
                        return traced.all_reduce(x, driver.AXIS, reduce_kind="sum")
            out = sub_fn()
            exact = x.sum(0, dtype=torch.float32)
            rows_agree = all(_bytes_of(out[r]) == _bytes_of(out[0]) for r in range(world))
            env_ok = bool(torch.allclose(out[0], exact, rtol=1e-5, atol=1e-5))
            detail = ""
            traced_ok = True
            if mode != "eager":
                ref = eager_prog(x)
                traced_ok = _bytes_of(out) == _bytes_of(ref)
                if not traced_ok:
                    detail = (
                        "traced lowering diverges bitwise from the eager body for "
                        f"schedule '{alg}'; "
                        + first_divergence(sub_fn, lambda: eager_prog(x))
                        + f"; max output |delta| = {float((out - ref).abs().max()):.3g}"
                    )
        finally:
            if mode != "eager":
                traced.reset()
    ok = rows_agree and env_ok and traced_ok
    if not detail:
        if not rows_agree:
            detail = "ranks disagree bitwise on the all-reduce result"
        elif not env_ok:
            detail = (f"envelope violated: max |delta| = "
                      f"{float((out[0] - exact).abs().max()):.3g}")
    return {"ok": ok, "detail": detail, "hash": _tree_hash(out)}


def _run_codec_roundtrip(geom: Dict[str, Any]) -> Dict[str, Any]:
    import torch

    from ..ops import quant

    x = _det_array(4 * 64).reshape(4, 64)
    if geom["codec"] == "kv":
        q, s = quant.quantize_kv(x)
        dq = quant.dequantize_kv(q, s, torch.float32)
        bound = s[..., None] * 0.5 + 1e-7
    else:
        bs = geom["block"]
        q, s = quant.quantize_blockwise(x, bs)
        dq = quant.dequantize_blockwise(q, s, bs)
        bound = s.repeat_interleave(bs, dim=-1).reshape(x.shape) * 0.5 + 1e-7
    err = (dq - x).abs()
    ok = bool((err <= bound).all())
    detail = ""
    if not ok:
        detail = ("round-trip error exceeds the scale/2 envelope by "
                  f"{float((err - bound).max()):.3g}")
    return {"ok": ok, "detail": detail, "hash": _tree_hash(dq)}


def _run_prng_stream(geom: Dict[str, Any]) -> Dict[str, Any]:
    """Token-exact subject: per-request streams must not depend on batch
    packing (the serve resize claim in miniature): R request lanes, each
    keyed from its own seed and split every step as the engine's decode
    lanes are (`serve/decode.py`), sampled through the engine's sampler,
    computed in `world` chunks must equal one full batch."""
    import torch

    from .. import prng
    from ..models.generate import sample_logits

    world = geom["world"]
    R, T, V = 8, 12, 17
    logits = _det_array(V)

    def stream(seeds: List[int]):
        keys = torch.stack([prng.split(prng.PRNGKey(s))[0] for s in seeds])
        cols = []
        for _ in range(T):
            split = prng.split(keys)  # (B, 2, 2)
            subs, keys = split[:, 0], split[:, 1]
            cols.append(sample_logits(logits.expand(len(seeds), V), subs, 1.0, None))
        return torch.stack(cols, dim=1)

    seeds = [101 + r for r in range(R)]
    full = stream(seeds)
    merged = torch.empty_like(full)
    for i in range(world):
        merged[i::world] = stream(seeds[i::world])
    ok = _bytes_of(merged) == _bytes_of(full)
    detail = ""
    if not ok:
        bad = (merged != full).nonzero()
        r, t = (int(bad[0][0]), int(bad[0][1])) if len(bad) else (-1, -1)
        detail = f"token stream forked at request {r}, step {t} when batched in {world} chunks"
    return {"ok": ok, "detail": detail, "hash": _tree_hash(full)}


def _geoms_zero(quick: bool) -> List[Dict[str, Any]]:
    # the non-power-of-two worlds are load-bearing: a mean division by a
    # power-of-two world is EXACT in IEEE, so a reassociated `/world` (the
    # pr10 revert class) is bitwise-invisible at 2 and 4; only 3 and 6
    # expose it. Sweeping geometries is the whole point (and the quick
    # tier's first two carry one of them).
    worlds = [2, 3, 1, 4, 6]
    return [{"world": w} for w in (worlds[:2] if quick else worlds)]


def _geoms_plan(quick: bool) -> List[Dict[str, Any]]:
    # world x algorithm x TDX_PLANNER_FORCE x eager/traced lowering:
    # modes innermost, traced seam first, so the two-geometry quick slice
    # covers agreed-table + force-env dispatch on the smallest geometry
    # (each traced run compares against the eager body anyway)
    from ..plan import driver

    forced = os.environ.get("TDX_PLANNER_FORCE")
    out = []
    for world in (2, 4):
        for alg in ("ring", "rhd", "hier"):
            if forced and alg != forced:
                continue
            if not driver.supports("all_reduce", alg, world):
                continue
            for mode in ("traced", "traced_force", "eager"):
                out.append({"world": world, "schedule": alg, "mode": mode})
    return out[:2] if quick else out


def _geoms_codec(quick: bool) -> List[Dict[str, Any]]:
    out = [
        {"codec": "blockwise", "block": 8},
        {"codec": "blockwise", "block": 32},
        {"codec": "kv"},
    ]
    return out[:2] if quick else out


def _geoms_prng(quick: bool) -> List[Dict[str, Any]]:
    worlds = [1, 2] if quick else [1, 2, 4]
    return [{"world": w} for w in worlds]


def _run_disagg_migration(geom: Dict[str, Any]) -> Dict[str, Any]:
    """Token-exact subject for the disagg migration plane
    (`serve/disagg/`): every completion routed prefill-pool → KV
    migration → decode-pool must be the colocated engine's token for
    token, at BOTH sampling modes (greedy and temperature > 0: the carry
    key must survive the pool hop), across prefill/decode TP degrees and
    the int8 KV pool."""
    import numpy as np
    import torch

    from ..mesh import DeviceMesh
    from ..models.transformer import TransformerConfig, TransformerLM
    from ..serve.disagg import DisaggRouter
    from ..serve.engine import ServeEngine
    from ..store import HashStore

    p_tp, d_tp = geom["prefill_tp"], geom["decode_tp"]
    kv_quant = geom["kv_quant"]
    cfg = TransformerConfig(vocab_size=64, d_model=32, n_layers=2, n_heads=4,
                            max_seq_len=32, use_flash=False, dtype=torch.float32)
    model = TransformerLM(cfg, device="cpu", generator=torch.Generator().manual_seed(0))

    def mesh_for(n):
        return None if n == 1 else DeviceMesh(["cpu"] * n, (n,), ("tp",))

    def make(role, tp, temperature, top_k):
        return ServeEngine(model, slots=4, temperature=temperature, top_k=top_k,
                           block_size=4, pool_blocks=64, prefill_chunk_tokens=8,
                           mesh=mesh_for(tp), kv_quant=kv_quant, role=role)

    gen = np.random.default_rng(3)
    prompts = [gen.integers(0, 64, (n,)).astype(np.int32) for n in (5, 9, 13)]

    def drive(submit, run):
        for i, p in enumerate(prompts):
            submit(p, 6, rid=f"r{i}", seed=11 + i)
        return {rid: c.tokens for rid, c in run().items()}

    mismatches = []
    hashes = []
    for mode, (temp, top_k) in (("greedy", (0.0, None)), ("sampled", (0.8, 8))):
        colo = make("both", p_tp, temp, top_k)

        def run_colo(eng=colo):
            for _ in range(4096):
                if not eng.step():
                    break
            return eng.completions

        base = drive(colo.submit, run_colo)
        router = DisaggRouter(
            HashStore(),
            lambda i: make("prefill", p_tp, temp, top_k),
            lambda i: make("decode", d_tp, temp, top_k),
            chunk_blocks=2,
        )
        got = drive(router.submit, lambda: router.run(max_steps=4096))
        for rid in sorted(base):
            if got.get(rid) != base[rid]:
                mismatches.append(f"{mode}/{rid}: colocated={base[rid]} disagg={got.get(rid)}")
        if router.migrations == 0:
            mismatches.append(f"{mode}: no migrations occurred — the disagg path "
                              "was not exercised")
        hashes.append(_tree_hash([torch.tensor(base[r]) for r in sorted(base)]))
    return {
        "ok": not mismatches,
        "detail": "; ".join(mismatches[:3]),
        "hash": hashlib.sha256("".join(hashes).encode()).hexdigest()[:16],
    }


def _geoms_disagg(quick: bool) -> List[Dict[str, Any]]:
    # TP on both sides of the migration plus the int8 KV pool: raw block
    # transport must be invisible at every combination
    out = [
        {"prefill_tp": 1, "decode_tp": 1, "kv_quant": False},
        {"prefill_tp": 1, "decode_tp": 2, "kv_quant": True},
        {"prefill_tp": 2, "decode_tp": 1, "kv_quant": False},
        {"prefill_tp": 2, "decode_tp": 2, "kv_quant": True},
        {"prefill_tp": 1, "decode_tp": 1, "kv_quant": True},
        {"prefill_tp": 2, "decode_tp": 1, "kv_quant": True},
    ]
    return out[:2] if quick else out


@dataclass
class Subject:
    name: str
    tier: str
    contract: str  # the registered contract this realizes
    geometries: Callable[[bool], List[Dict[str, Any]]]
    run: Callable[[Dict[str, Any]], Dict[str, Any]]


_P = "pytorch_distributed_example_tpu_torch"

SUBJECTS: Dict[str, Subject] = {
    "zero_update": Subject(
        "zero_update", "bitwise", f"{_P}.parallel.ddp:make_ddp_train_step",
        _geoms_zero, _run_zero_update,
    ),
    "planned_allreduce": Subject(
        "planned_allreduce", "tolerance", f"{_P}.ops.quant:quantized_all_reduce",
        _geoms_plan, _run_planned_allreduce,
    ),
    "codec_roundtrip": Subject(
        "codec_roundtrip", "tolerance", f"{_P}.ops.quant:quantize_blockwise",
        _geoms_codec, _run_codec_roundtrip,
    ),
    "prng_stream": Subject(
        "prng_stream", "token_exact", f"{_P}.serve.engine:ServeEngine.step",
        _geoms_prng, _run_prng_stream,
    ),
    "disagg_migration": Subject(
        "disagg_migration", "token_exact", f"{_P}.serve.disagg.migrate:migrate_request",
        _geoms_disagg, _run_disagg_migration,
    ),
}


def _geom_label(geom: Dict[str, Any]) -> str:
    return " ".join(f"{k}={v}" for k, v in sorted(geom.items()))


def _revert_geometries(quick: bool) -> List[Dict[str, Any]]:
    """The zero_update geometries where the pr10 revert is observable:
    worlds > 1 that are not powers of two (division by a power of two is
    exact, so the reassociated mean is bitwise the shipped one there)."""
    return [
        g for g in SUBJECTS["zero_update"].geometries(quick)
        if g["world"] > 1 and (g["world"] & (g["world"] - 1)) != 0
    ]


def revert_changes_bits(geom: Dict[str, Any]) -> bool:
    """Does the pr10 revert change the ZeRO update's output bits at this
    geometry? (The gate counts a revert caught only where it does.)"""
    world = geom["world"]
    shipped = _zero_update_fn(world)()
    reverted = _zero_update_fn(world, _perturbed_reduce_scatter_mean)()
    return _bytes_of(shipped) != _bytes_of(reverted)


def run_sweep(
    quick: bool = False,
    seed_revert: Optional[str] = None,
    only: Optional[str] = None,
    out=sys.stdout,
) -> int:
    """Run the geometry parity sweep; returns the process exit code.

    With ``seed_revert='pr10'`` the ZeRO-update subject is re-run with
    `_perturbed_reduce_scatter_mean` swapped in: at every eligible
    geometry the revert MUST change the update's bits, and the sweep
    MUST catch it and localize it to a first divergent op, or the
    sweeper itself has lost its teeth (exit 1)."""
    import torch

    failures = 0
    total = 0
    with _cpu_world(), torch.no_grad():
        for name, subj in SUBJECTS.items():
            if only and name != only:
                continue
            geoms = subj.geometries(quick)
            print(
                f"numlint sweep: subject '{name}' [{subj.tier}] "
                f"contract {subj.contract} ({len(geoms)} geometries)",
                file=out,
            )
            for geom in geoms:
                total += 1
                try:
                    res = subj.run(geom)
                except Exception as e:  # a crashed geometry is a failure
                    res = {"ok": False, "detail": f"subject crashed: {e!r}"}
                if res["ok"]:
                    print(f"  geometry {_geom_label(geom)}: parity OK "
                          f"(hash {res.get('hash', '?')})", file=out)
                else:
                    failures += 1
                    print(f"  geometry {_geom_label(geom)}: DIVERGED — {res['detail']}",
                          file=out)
        print(f"numlint sweep: {total - failures}/{total} geometries parity-clean", file=out)

        rc = 1 if failures else 0
        if seed_revert is None:
            return rc
        if seed_revert != "pr10":
            print(f"unknown seed-revert {seed_revert!r}", file=out)
            return 2

        print(
            "numlint sweep [seed-revert pr10]: perturbing "
            "zero.reduce_scatter_mean (mean division reassociated into the "
            "scatter — the reduction-order class the bitwise ZeRO claim "
            "forbids)",
            file=out,
        )
        geoms = _revert_geometries(quick)
        caught = 0
        for geom in geoms:
            if not revert_changes_bits(geom):
                print(f"  geometry {_geom_label(geom)}: the revert leaves the "
                      "update's bits unchanged here — cannot count it caught", file=out)
                continue
            res = _run_zero_update(geom, rs_impl=_perturbed_reduce_scatter_mean)
            localized = "first divergent op" in res.get("detail", "")
            if not res["ok"] and localized:
                caught += 1
                print(f"  geometry {_geom_label(geom)}: DIVERGED (required) — "
                      f"{res['detail']}", file=out)
            elif not res["ok"]:
                print(f"  geometry {_geom_label(geom)}: diverged but NOT "
                      f"localized — {res['detail']}", file=out)
            else:
                print(f"  geometry {_geom_label(geom)}: NOT caught — the "
                      "perturbed update passed parity", file=out)
    if caught == len(geoms) and geoms:
        print(
            f"seed-revert pr10: caught and localized at {caught}/"
            f"{len(geoms)} eligible geometries — the sweep gate still has teeth",
            file=out,
        )
        return rc
    print(
        f"seed-revert pr10: only {caught}/{len(geoms)} geometries "
        "caught+localized — the sweeper LOST ITS TEETH",
        file=out,
    )
    return 1


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="numlint",
        description=(
            "numerics/determinism-plane analyzer (N001-N007) + geometry "
            "parity sweeper"
        ),
    )
    ap.add_argument("--root", default=".", help="project root")
    ap.add_argument("--format", choices=("human", "json", "sarif"), default="human")
    ap.add_argument("--baseline", default=None)
    ap.add_argument("--update-baseline", action="store_true")
    ap.add_argument("--force-baseline-growth", action="store_true")
    ap.add_argument("--show-suppressed", action="store_true")
    ap.add_argument(
        "--sweep", action="store_true",
        help="run the dynamic geometry parity sweep instead of the static rules",
    )
    ap.add_argument(
        "--quick", action="store_true",
        help="bound the sweep to 2 geometries per subject (also via "
        "TDX_NUMLINT_SWEEP=quick)",
    )
    ap.add_argument("--subject", default=None, help="restrict the sweep to one subject")
    ap.add_argument(
        "--seed-revert", default=None, metavar="NAME",
        help="re-run the sweep with a seeded historical revert (pr10: "
        "ZeRO update reduction order) that MUST be caught",
    )
    args = ap.parse_args(argv)

    if args.sweep:
        quick = args.quick or (os.environ.get("TDX_NUMLINT_SWEEP", "") == "quick")
        return run_sweep(quick=quick, seed_revert=args.seed_revert, only=args.subject)

    try:
        config = load_config(args.root)
    except ValueError as e:
        print(f"numlint: {e}", file=sys.stderr)
        return 2
    findings, _project = lint(args.root, config)

    stale_entries: List[Dict] = []
    if args.baseline and os.path.isfile(args.baseline) and not args.update_baseline:
        baseline = load_baseline(args.baseline)
        _new, _matched, stale_entries = apply_baseline(findings, baseline)
    if args.update_baseline:
        path = args.baseline or os.path.join(
            args.root, "pytorch_distributed_example_tpu_torch/tools/baselines/numlint.json")
        n = write_baseline(path, findings, allow_growth=args.force_baseline_growth,
                           tool="numlint")
        print(f"numlint: baseline updated ({n} entries)", file=sys.stderr)

    if args.format == "json":
        print(json.dumps([f.to_dict() for f in findings], indent=2))
    elif args.format == "sarif":
        print(
            json.dumps(
                render_sarif(
                    findings,
                    args.show_suppressed,
                    baseline_mode=bool(args.baseline),
                    tool_name="numlint",
                    rules=RULES,
                    information_uri=_INFO_URI,
                    fingerprint_key="numlint/v1",
                ),
                indent=2,
            )
        )
    else:
        print(render_report(findings, args.show_suppressed, tool="numlint"))
    if stale_entries:
        print(
            f"numlint: {len(stale_entries)} stale baseline entr"
            f"{'y' if len(stale_entries) == 1 else 'ies'} — run "
            "--update-baseline to shrink the ratchet",
            file=sys.stderr,
        )
    active = [
        f for f in findings
        if not f.suppressed and not f.baselined and f.severity == "error"
    ]
    return 1 if active else 0


if __name__ == "__main__":
    sys.exit(main())
