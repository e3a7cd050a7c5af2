"""Numerics-contract registry, a copy of the reference's `numerics.py`.

Every load-bearing parity claim is a *contract* with a tier:

* ``"bitwise"``     — outputs are bit-identical to the reference path
                      (the ZeRO sharded update against the unsharded
                      one). Any reduction-order change or dtype skew on
                      such a path is a bug even when a tolerance test
                      still passes.
* ``"token_exact"`` — emitted TOKEN streams are identical: float
                      internals may differ in the last ulp, but the
                      random streams must not fork.
* ``"tolerance"``   — outputs match within a declared rtol/atol
                      envelope. Tests verifying the claim must not use
                      looser tolerances than declared.

`@numerics_contract(tier)` records the claim ON the function (a
`__numerics_contract__` attribute plus a module-level registry) with
ZERO runtime overhead — no wrapper is introduced.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional

__all__ = [
    "TIERS",
    "numerics_contract",
    "contract_of",
    "registered_contracts",
]

TIERS = ("bitwise", "tolerance", "token_exact")

# qualname ("module:Class.meth") -> contract dict. Populated at import
# time of the decorated modules; numlint's static half never reads this
# (it harvests the AST), the sweep half and tests do.
_REGISTRY: Dict[str, Dict[str, Any]] = {}


def numerics_contract(
    tier: str,
    *,
    rtol: Optional[float] = None,
    atol: Optional[float] = None,
    note: str = "",
) -> Callable:
    """Declare a parity contract on a function (see module docstring).

    ``rtol``/``atol`` are only meaningful for the "tolerance" tier:
    they are the envelope the claim is made AT — numlint rule N007
    fails any test that verifies this function with a looser envelope,
    and fails bitwise/token_exact claims verified with ANY nonzero
    tolerance."""
    if tier not in TIERS:
        raise ValueError(f"unknown contract tier {tier!r}; one of {TIERS}")
    if tier != "tolerance" and (rtol is not None or atol is not None):
        raise ValueError(
            f"rtol/atol only apply to the 'tolerance' tier, not {tier!r}"
        )

    def deco(fn: Callable) -> Callable:
        contract = {
            "tier": tier,
            "rtol": rtol,
            "atol": atol,
            "note": note,
        }
        fn.__numerics_contract__ = contract
        _REGISTRY[f"{fn.__module__}:{fn.__qualname__}"] = contract
        return fn

    return deco


def contract_of(fn: Callable) -> Optional[Dict[str, Any]]:
    """The contract dict declared on ``fn`` (or None)."""
    return getattr(fn, "__numerics_contract__", None)


def registered_contracts() -> Dict[str, Dict[str, Any]]:
    """Snapshot of every contract registered by imported modules."""
    return dict(_REGISTRY)
