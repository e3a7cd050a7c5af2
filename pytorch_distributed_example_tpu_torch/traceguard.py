"""`TDX_TRACE_GUARD=1` — fail-fast guard for host effects under compilation.

distlint R011 statically flags host-side effects (blocking store ops,
`faults.fire`, device readbacks) reachable from traced/compiled code. This
module is the runtime half of that contract, the same way `schedule.py`'s
`TDX_SCHEDULE_CHECK` fingerprint verifier is the runtime half of R001:
with the guard armed, a guarded primitive invoked while `torch.compile`
is tracing raises a named `TraceGuardError` AT THE OP — instead of a
trace-time side effect that silently runs once instead of per step, or a
graph break hidden inside a compiled region.

Wired into:

  * `faults.fire` — every injection point fires through one choke point,
    so every store client op, rendezvous handler, collective dispatch
    and serve-plane point is covered with its own name;
  * the blocking store primitives that do NOT route through `fire`
    (`HashStore.get`, `FileStore.get`) — named `store.get`.

Off (the default) this is one env read per op. The guard lives in its
own leaf module with no package imports so `faults`, `store` and anything
else on the dispatch path can use it without cycles.
"""

from __future__ import annotations

import os

_ENV = "TDX_TRACE_GUARD"

__all__ = ["TraceGuardError", "enabled", "under_tracing", "check"]


class TraceGuardError(RuntimeError):
    """A guarded host-side op ran while torch.compile traced (TDX_TRACE_GUARD=1)."""


def enabled() -> bool:
    return os.environ.get(_ENV, "").strip().lower() not in (
        "", "0", "false", "off",
    )


def under_tracing() -> bool:
    """True while `torch.compile` (dynamo) is tracing the calling code."""
    import torch

    return bool(torch.compiler.is_compiling())


def check(op: str) -> None:
    """Raise `TraceGuardError` naming ``op`` when the guard is armed and
    torch.compile is tracing; no-op otherwise."""
    if not enabled():
        return
    if under_tracing():
        raise TraceGuardError(
            f"host-side op `{op}` invoked while torch.compile is tracing "
            "(TDX_TRACE_GUARD=1): a compiled body must stay device-pure — "
            "this op would execute once at trace time instead of every "
            "step. Hoist it out of the compiled body (probe outside, agree "
            "through the store, pass the result in) or run without the "
            "guard."
        )
