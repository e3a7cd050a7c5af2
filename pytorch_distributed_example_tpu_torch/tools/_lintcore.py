"""_lintcore — the toolchain the port's analyzer planes share.

The port of the reference's `tools/_lintcore.py`: a `Finding` record
with severity/suppression/baseline state, a content-fingerprinted
baseline RATCHET (grandfathered entries may only shrink; a fixed finding
must never buy a slot for a new one), SARIF 2.1.0 + human reports, and
tokenize-based comment-only suppression parsing (`# <tool>: disable=Xnnn
-- reason`). distlint (source plane) and storelint (coordination plane)
render through this one module, so a renderer fix lands in both.

The port's tools keep their own config and baselines: the `[tool.*]`
tables of the root `pyproject.toml` serve the JAX package, so
`load_config_section` reads the same table and key names from
`CONFIG_PATH` (`pytorch_distributed_example_tpu_torch/tools/lint.toml`)
under the lint root instead, and the ratchets live in `BASELINE_DIR`.

Nothing in this module imports the analyzers (or torch): it is the leaf
of the tools package. distlint re-exports these names unchanged.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import re
import tokenize
import tomllib
from dataclasses import dataclass
from typing import Dict, List, Optional, Set, Tuple

__all__ = [
    "SEVERITIES",
    "CONFIG_PATH",
    "BASELINE_DIR",
    "Finding",
    "parse_suppressions",
    "load_config_section",
    "parse_severity_table",
    "baseline_entries",
    "load_baseline",
    "apply_baseline",
    "write_baseline",
    "render_report",
    "render_sarif",
    "scoped_env",
]

SEVERITIES = ("error", "warning", "off")

# The port's lint config and committed ratchets, relative to the lint root.
CONFIG_PATH = "pytorch_distributed_example_tpu_torch/tools/lint.toml"
BASELINE_DIR = "pytorch_distributed_example_tpu_torch/tools/baselines"


@dataclass
class Finding:
    path: str
    line: int
    col: int
    rule: str
    message: str
    suppressed: bool = False
    severity: str = "error"
    baselined: bool = False
    fingerprint: str = ""
    trace: Tuple[str, ...] = ()

    def to_dict(self) -> Dict:
        d = {
            "path": self.path,
            "line": self.line,
            "col": self.col,
            "rule": self.rule,
            "message": self.message,
            "suppressed": self.suppressed,
            "severity": self.severity,
            "baselined": self.baselined,
            "fingerprint": self.fingerprint,
        }
        if self.trace:
            d["trace"] = list(self.trace)
        return d

    def render(self) -> str:
        tags = []
        if self.severity != "error":
            tags.append(self.severity)
        if self.baselined:
            tags.append("baselined")
        if self.suppressed:
            tags.append("suppressed")
        tag = f" ({', '.join(tags)})" if tags else ""
        return f"{self.path}:{self.line}:{self.col}: {self.rule} {self.message}{tag}"


# ---------------------------------------------------------------------------
# suppressions
# ---------------------------------------------------------------------------

_SUPPRESS_RE_CACHE: Dict[str, Tuple[re.Pattern, re.Pattern]] = {}


def _suppress_res(tool: str) -> Tuple[re.Pattern, re.Pattern]:
    pair = _SUPPRESS_RE_CACHE.get(tool)
    if pair is None:
        pair = (
            re.compile(rf"#\s*{re.escape(tool)}:\s*disable=([A-Za-z0-9_,\s]+)"),
            re.compile(
                rf"#\s*{re.escape(tool)}:\s*disable-file=([A-Za-z0-9_,\s]+)"
            ),
        )
        _SUPPRESS_RE_CACHE[tool] = pair
    return pair


def parse_suppressions(
    src: str, tool: str
) -> Tuple[Dict[int, Set[str]], Dict[str, int]]:
    """(line -> suppressed rules, file-wide rule -> declaring line).

    Only genuine COMMENT tokens count: a suppression-shaped string inside
    a docstring or test fixture neither suppresses nor goes stale."""
    line_re, file_re = _suppress_res(tool)
    per_line: Dict[int, Set[str]] = {}
    file_wide: Dict[str, int] = {}

    def absorb(text: str, lineno: int) -> None:
        m = line_re.search(text)
        if m:
            rules = {r.strip().upper() for r in m.group(1).split(",") if r.strip()}
            per_line.setdefault(lineno, set()).update(rules)
        m = file_re.search(text)
        if m:
            for r in m.group(1).split(","):
                r = r.strip().upper()
                if r:
                    file_wide.setdefault(r, lineno)

    try:
        for tok in tokenize.generate_tokens(io.StringIO(src).readline):
            if tok.type == tokenize.COMMENT:
                absorb(tok.string, tok.start[0])
    except (tokenize.TokenError, IndentationError, SyntaxError):
        # unparsable tail (rare): fall back to the raw line scan
        for i, line in enumerate(src.splitlines(), start=1):
            if "#" in line:
                absorb(line, i)
    return per_line, file_wide


# ---------------------------------------------------------------------------
# config plumbing
# ---------------------------------------------------------------------------


def load_config_section(root: str, tool: str) -> Dict:
    """The ``[tool.<tool>]`` table of ``<root>/CONFIG_PATH`` (missing
    file/section → {}; an unparsable file raises — a broken config must
    not silently lint with defaults)."""
    pp = os.path.join(root, CONFIG_PATH)
    if not os.path.isfile(pp):
        return {}
    try:
        with open(pp, "rb") as f:
            doc = tomllib.load(f)
    except Exception as e:
        raise ValueError(f"could not parse {pp}: {e}") from e
    return dict(doc.get("tool", {}).get(tool, {}))


def parse_severity_table(section: Dict, tool: str) -> Dict[str, str]:
    """Validate ``[tool.<tool>.severity]`` → {RULE: severity}."""
    out: Dict[str, str] = {}
    for rule, sev in dict(section.get("severity", {})).items():
        sev = str(sev).lower()
        if sev not in SEVERITIES:
            raise ValueError(
                f"[tool.{tool}.severity] {rule} = {sev!r}: must be one of "
                f"{SEVERITIES}"
            )
        out[str(rule).upper()] = sev
    return out


# ---------------------------------------------------------------------------
# baseline & ratchet
# ---------------------------------------------------------------------------


def baseline_entries(findings: List[Finding]) -> List[Dict]:
    """The baseline records unsuppressed error-severity findings."""
    return [
        {
            "path": f.path,
            "rule": f.rule,
            "fingerprint": f.fingerprint,
            "message": f.message,
        }
        for f in findings
        if not f.suppressed and f.severity == "error"
    ]


def load_baseline(path: str) -> Dict:
    with open(path, "r", encoding="utf-8") as fh:
        doc = json.load(fh)
    if not isinstance(doc, dict) or "findings" not in doc:
        raise ValueError(f"{path}: not a lint baseline (no 'findings' key)")
    return doc


def apply_baseline(
    findings: List[Finding], baseline: Dict
) -> Tuple[List[Finding], List[Finding], List[Dict]]:
    """Mark baselined findings; returns (new, baselined, stale_entries).

    Matching is by (path, rule, fingerprint); each baseline entry absorbs
    at most one finding."""
    pool: Dict[Tuple[str, str, str], List[Dict]] = {}
    for e in baseline.get("findings", []):
        pool.setdefault((e["path"], e["rule"], e["fingerprint"]), []).append(e)
    new: List[Finding] = []
    matched: List[Finding] = []
    for f in findings:
        if f.suppressed or f.severity != "error":
            continue
        key = (f.path, f.rule, f.fingerprint)
        entries = pool.get(key)
        if entries:
            entries.pop()
            if not entries:
                del pool[key]
            f.baselined = True
            matched.append(f)
        else:
            new.append(f)
    stale = [e for entries in pool.values() for e in entries]
    return new, matched, stale


def write_baseline(
    path: str,
    findings: List[Finding],
    naive_count: Optional[int] = None,
    allow_growth: bool = False,
    tool: str = "distlint",
) -> int:
    """Write the ratchet file. Refuses to admit any entry that was not
    already grandfathered (identity by path+rule+fingerprint, NOT by
    count — fixing one finding must never buy a slot for a new one)
    unless ``allow_growth``."""
    entries = baseline_entries(findings)
    prev_naive = None
    if os.path.isfile(path):
        try:
            prev = load_baseline(path)
        except (OSError, ValueError):
            prev = {"findings": []}
        prev_naive = prev.get("naive_first_run_count")
        prev_keys = {
            (e["path"], e["rule"], e["fingerprint"])
            for e in prev.get("findings", [])
        }
        added = [
            e
            for e in entries
            if (e["path"], e["rule"], e["fingerprint"]) not in prev_keys
        ]
        if added and not allow_growth:
            raise ValueError(
                f"ratchet violation: {len(added)} finding(s) not in the "
                "existing baseline would be grandfathered "
                f"(first: {added[0]['path']} {added[0]['rule']} "
                f"{added[0]['message'][:60]}...); fix or suppress them "
                "instead (--force-baseline-growth to override)"
            )
    doc = {
        "version": 1,
        "tool": tool,
        "naive_first_run_count": (
            naive_count if naive_count is not None
            else (prev_naive if prev_naive is not None else len(entries))
        ),
        "findings": entries,
    }
    with open(path, "w", encoding="utf-8") as fh:
        json.dump(doc, fh, indent=1, sort_keys=True)
        fh.write("\n")
    return len(entries)


# ---------------------------------------------------------------------------
# reporting
# ---------------------------------------------------------------------------


def render_report(
    findings: List[Finding],
    show_suppressed: bool = False,
    show_baselined: bool = False,
    tool: str = "distlint",
) -> str:
    lines: List[str] = []
    active = [
        f for f in findings
        if not f.suppressed and not f.baselined and f.severity == "error"
    ]
    warnings = [
        f for f in findings
        if not f.suppressed and not f.baselined and f.severity == "warning"
    ]
    shown = [
        f for f in findings
        if (show_suppressed or not f.suppressed)
        and (show_baselined or not f.baselined)
    ]
    for f in shown:
        lines.append(f.render())
    n_sup = sum(1 for f in findings if f.suppressed)
    n_base = sum(1 for f in findings if f.baselined)
    by_rule: Dict[str, int] = {}
    for f in active:
        by_rule[f.rule] = by_rule.get(f.rule, 0) + 1
    summary = ", ".join(f"{r}: {n}" for r, n in sorted(by_rule.items())) or "none"
    lines.append(
        f"{tool}: {len(active)} finding(s) ({summary}); "
        f"{len(warnings)} warning(s); {n_base} baselined; {n_sup} suppressed"
    )
    return "\n".join(lines)


_SARIF_LEVEL = {"error": "error", "warning": "warning"}


def render_sarif(
    findings: List[Finding],
    show_suppressed: bool = False,
    baseline_mode: Optional[bool] = None,
    tool_name: str = "distlint",
    rules: Optional[Dict[str, str]] = None,
    information_uri: Optional[str] = None,
    fingerprint_key: str = "distlint/v1",
) -> Dict:
    """SARIF 2.1.0 document. When a baseline was applied, baselined
    findings carry baselineState=unchanged and the rest baselineState=new.
    Pass ``baseline_mode`` explicitly when an EMPTY baseline was applied —
    auto-detection (any f.baselined) cannot see the difference between
    "no baseline" and "baseline that matched nothing", and a consumer
    filtering on baselineState=='new' must not lose findings then.

    ``tool_name``/``rules``/``information_uri``/``fingerprint_key`` let
    every analyzer emit its own driver block through this one renderer
    instead of forking the SARIF layout."""
    if baseline_mode is None:
        baseline_mode = any(f.baselined for f in findings)
    results = []
    for f in findings:
        if f.rule == "E000":
            level = "error"
        else:
            level = _SARIF_LEVEL.get(f.severity, "note")
        if f.suppressed and not show_suppressed:
            continue
        res = {
            "ruleId": f.rule,
            "level": level,
            "message": {"text": f.message},
            "locations": [
                {
                    "physicalLocation": {
                        "artifactLocation": {"uri": f.path},
                        "region": {"startLine": max(f.line, 1), "startColumn": max(f.col, 1)},
                    }
                }
            ],
            "partialFingerprints": {fingerprint_key: f.fingerprint},
        }
        if f.trace:
            res["message"]["text"] += "  [chain: " + " -> ".join(f.trace) + "]"
        if f.suppressed:
            res["suppressions"] = [{"kind": "inSource"}]
        # only error-severity findings live in the ratchet: a warning can
        # never be baselined (apply_baseline skips it by design), so
        # marking it "new" forever would fail consumers gating on
        # baselineState for findings the tool itself deems non-failing
        if baseline_mode and not f.suppressed and f.severity == "error":
            res["baselineState"] = "unchanged" if f.baselined else "new"
        results.append(res)
    return {
        "$schema": "https://json.schemastore.org/sarif-2.1.0.json",
        "version": "2.1.0",
        "runs": [
            {
                "tool": {
                    "driver": {
                        "name": tool_name,
                        "informationUri": (
                            information_uri
                            or "pytorch_distributed_example_tpu_torch/tools/distlint.py"
                        ),
                        "rules": [
                            {
                                "id": rid,
                                "shortDescription": {"text": desc},
                            }
                            for rid, desc in sorted((rules or {}).items())
                        ],
                    }
                },
                "results": results,
            }
        ],
    }


# ---------------------------------------------------------------------------
# environment
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def scoped_env(**values):
    """Set (a str) or unset (None) environment variables for the block and
    restore them after: the dynamic halves drive the port's env-selected
    paths (`TDX_PROGLINT`, the planner's knobs) without leaking them."""
    prev = {k: os.environ.get(k) for k in values}
    for k, v in values.items():
        if v is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = v
    try:
        yield
    finally:
        for k, v in prev.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
