"""The port's unified lint entry point: its guard-plane analyzers, one
artifact, one exit code.

    python -m pytorch_distributed_example_tpu_torch.tools.lint \
        --sarif-out lint.sarif

runs, in order (the reference's):

  distlint   source plane    R001-R011, R013-R015 (call-graph divergence/trace)
  proglint   program plane   J001, J002, J004     (registered programs' collectives)
  storelint  coordination    S001-S007            (store key-space registry)
  numlint    numerics plane  N001-N007            (contract registry + parity)

each against its committed baseline ratchet
(`pytorch_distributed_example_tpu_torch/tools/baselines/<tool>.json`),
exactly as its standalone CLI would (`<tool> --format sarif --baseline
...`), and merges the SARIF documents into ONE artifact with one `runs`
entry per tool. The exit code is 0 iff every analyzer exited 0, so a
single command gates a change on every plane.

The dynamic halves (storelint ``--explore``, numlint ``--sweep``) and
proglint's runtime J005 stay on their own CLIs and seams: they run real
protocols and programs and have their own gates
(tests/test_torch_storelint.py, tests/test_torch_numlint.py,
tests/test_torch_proglint.py).
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import sys
from typing import Dict, List, Optional, Sequence, Tuple

from . import distlint, numlint, proglint, storelint
from ._lintcore import BASELINE_DIR

__all__ = ["TOOLS", "run_all", "main"]

# (name, main callable, committed baseline ratchet relative to the root)
TOOLS: Tuple[Tuple[str, object, str], ...] = (
    ("distlint", distlint.main, f"{BASELINE_DIR}/distlint.json"),
    ("proglint", proglint.main, f"{BASELINE_DIR}/proglint.json"),
    ("storelint", storelint.main, f"{BASELINE_DIR}/storelint.json"),
    ("numlint", numlint.main, f"{BASELINE_DIR}/numlint.json"),
)


def run_all(
    root: str = ".", only: Optional[Sequence[str]] = None
) -> Tuple[Dict, Dict[str, int]]:
    """Run every analyzer in-process; returns (merged_sarif, rc_by_tool).

    Each tool runs through its own ``main()`` with the exact flags its
    standalone gate uses, so baseline semantics, suppressions, and
    severity tables cannot drift between the unified and per-tool
    paths. A tool with no committed baseline runs baseline-less rather
    than failing the whole run on a missing file."""
    merged: Dict = {
        "$schema": (
            "https://raw.githubusercontent.com/oasis-tcs/sarif-spec/"
            "master/Schemata/sarif-schema-2.1.0.json"
        ),
        "version": "2.1.0",
        "runs": [],
    }
    rcs: Dict[str, int] = {}
    for name, tool_main, baseline in TOOLS:
        if only and name not in only:
            continue
        argv = ["--root", root, "--format", "sarif"]
        bpath = os.path.join(root, baseline)
        if os.path.isfile(bpath):
            argv += ["--baseline", bpath]
        buf = io.StringIO()
        try:
            with contextlib.redirect_stdout(buf):
                rc = int(tool_main(argv) or 0)
        except SystemExit as e:  # a tool CLI may sys.exit
            rc = int(e.code or 0)
        except Exception as e:
            # one crashed analyzer must fail the gate loudly, not kill
            # the other planes' reports
            print(f"lint: {name} crashed: {e!r}", file=sys.stderr)
            rc = 2
        rcs[name] = rc
        try:
            doc = json.loads(buf.getvalue())
        except ValueError:
            # tool crashed before emitting SARIF: synthesize an empty
            # run so the artifact still carries all planes, and make
            # the failure loud through the exit code
            doc = {"runs": [{"tool": {"driver": {"name": name}},
                             "results": []}]}
            rcs[name] = rc or 2
        merged["runs"].extend(doc.get("runs", []))
    return merged, rcs


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="lint",
        description=(
            "run the port's guard-plane analyzers (distlint, proglint, "
            "storelint, numlint) "
            "against their baselines; one merged SARIF artifact, one exit "
            "code"
        ),
    )
    ap.add_argument("--root", default=".", help="project root")
    ap.add_argument(
        "--sarif-out",
        default=None,
        metavar="PATH",
        help="write the merged SARIF artifact here ('-' for stdout)",
    )
    ap.add_argument(
        "--only",
        action="append",
        choices=[name for name, _, _ in TOOLS],
        help="run a subset of analyzers (repeatable)",
    )
    args = ap.parse_args(argv)

    merged, rcs = run_all(args.root, only=args.only)

    counts: List[str] = []
    for run in merged["runs"]:
        name = run["tool"]["driver"]["name"]
        active = [r for r in run.get("results", []) if not r.get("suppressions")]
        counts.append(f"{name}: rc={rcs.get(name, '?')} "
                      f"{len(active)} active finding(s)")
    print("; ".join(counts), file=sys.stderr)

    if args.sarif_out == "-":
        print(json.dumps(merged, indent=2))
    elif args.sarif_out:
        with open(args.sarif_out, "w", encoding="utf-8") as fh:
            json.dump(merged, fh, indent=2)
            fh.write("\n")
        print(f"lint: merged SARIF -> {args.sarif_out}", file=sys.stderr)

    return 1 if any(rcs.values()) else 0


if __name__ == "__main__":
    sys.exit(main())
