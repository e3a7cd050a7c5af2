"""The comparison that decides `correct` for a training cell.

Both sides train from the same weights on the same first batches. Three
numbers are compared, each against its limit in the cell's
`perfbench/workloads/<cell>.json`:

- `loss_gap`: the largest |loss - reference loss| over the first steps;
- `grad_gap`: the first step's gradient, by the worst leaf: the gap between
  the two sides' norms of a leaf, over the reference's norm of that leaf or
  of the median leaf, whichever is larger;
- `change_gap`: the same of each leaf's change over the first steps. Leaves
  whose reference gradient is under a thousandth of the median leaf's move
  by round-off alone and are left out, by that rule and not by name.

A number that is not finite fails. A number the cell's file gives no limit
is not compared; the file says why (`not_compared`).
"""

from __future__ import annotations

import math
import statistics

NUMBERS = ("loss_gap", "grad_gap", "change_gap")
STILL = 1e-3  # a leaf whose gradient is under this share of the median's


def worst_leaf(got: dict, want: dict) -> float:
    floor = statistics.median(want.values())
    return max(abs(got[n] - want[n]) / max(want[n], floor) for n in want)


def numbers(got: dict, want: dict) -> dict:
    """The compared numbers. `got` and `want` each hold `losses` (a list),
    `grad_norms` and `change_norms` ({leaf: norm})."""
    g = want["grad_norms"]
    floor = STILL * statistics.median(g.values())
    moved = [n for n in g if g[n] >= floor]
    return {
        "loss_gap": max(abs(a - b) for a, b in zip(got["losses"], want["losses"], strict=True)),
        "grad_gap": worst_leaf(got["grad_norms"], g),
        "change_gap": worst_leaf({n: got["change_norms"][n] for n in moved},
                                 {n: want["change_norms"][n] for n in moved}),
    }


def judge(values: dict, limits: dict) -> tuple:
    """(correct, {name: {"value", "limit"}}) over the numbers that have a
    limit: each finite and at or under it. A cell's file says why a number
    it gives no limit is not compared."""
    checks = {n: {"value": values[n], "limit": limits[n]} for n in NUMBERS if n in limits}
    ok = bool(checks) and all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
                              for c in checks.values())
    return ok, checks
