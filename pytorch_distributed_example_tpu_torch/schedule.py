"""Cross-rank collective-schedule verification (`TDX_SCHEDULE_CHECK=1`).

The runtime complement of the static pass in `tools/distlint.py`: distlint
proves call *sites* cannot diverge; this module proves the executed
*schedule* did not. Every collective dispatched through
`ProcessGroup._dispatch` contributes a fingerprint of
``(seq, op_name, shape, dtype, detail, group)`` to a per-group rolling
digest; every N ops (`TDX_SCHEDULE_CHECK_EVERY`, default 16) the digest
plus the fingerprint window since the last checkpoint are published
through the store and compared across ranks. On disagreement the
verifier raises a `ScheduleMismatchError` NAMING the first divergent
call — instead of the job hanging inside the transport (the classic
symptom) or, worse, `psum`-ing mismatched buffers into silently wrong
numerics.

Relation to `TORCH_DISTRIBUTED_DEBUG=DETAIL` (`backends/wrapper.py`):
the wrapper barriers on EVERY collective pre-dispatch — airtight but a
full store round-trip per op. The schedule check amortizes that cost
over N ops: between checkpoints a divergent collective can still wedge
(the watchdog's business — it dumps and aborts), but the next
checkpoint converts the wedge into a diagnostic naming the divergence,
and a *numeric* divergence (same shapes, different op order) that would
never hang is caught too. Chaos coverage: the `schedule.mismatch` fault
point (action `"corrupt"`, advisory) perturbs one rank's fingerprint so
tests can prove the mismatch is reported, not hung on
(`tests/test_torch_c10d_multiproc.py`).

`agree_program` is the reference's compiled-program agreement: host-only
store rounds that compare each rank's ordered collective descriptors
before anything dispatches. The collective planner's `plan.traced.prepare`
rides it, so a gang whose ranks chose different schedules fails at
step-factory time, naming the first divergent eqn.

Env knobs:

    TDX_SCHEDULE_CHECK            1 enables (default 0)
    TDX_SCHEDULE_CHECK_EVERY      checkpoint every N collectives (default 16)
    TDX_SCHEDULE_CHECK_TIMEOUT_S  checkpoint agreement deadline (default 30)
"""

from __future__ import annotations

import hashlib
import json
import os
from typing import List, Optional

from . import faults
from .types import DistError

__all__ = [
    "ScheduleMismatchError",
    "ProgramScheduleMismatchError",
    "ScheduleVerifier",
    "agree_program",
    "enabled",
]

_ENV = "TDX_SCHEDULE_CHECK"
DEFAULT_EVERY = 16
DEFAULT_TIMEOUT_S = 30.0


class ScheduleMismatchError(DistError):
    """Ranks issued divergent collective schedules. The message names the
    first divergent call (or the ranks that never reached the checkpoint)
    so the offending call site is greppable — the diagnostic this check
    exists to produce instead of a hang."""


class ProgramScheduleMismatchError(ScheduleMismatchError):
    """Ranks prepared divergent collective programs (`agree_program`):
    the per-rank fingerprints published through the group store before
    first dispatch disagree. Where the runtime ScheduleVerifier catches a
    divergent schedule only after a collective has been issued (and maybe
    wedged the transport), this fires before any collective executes,
    naming the first divergent collective eqn."""


def enabled() -> bool:
    return os.environ.get(_ENV, "0") == "1"


def _check_every() -> int:
    return max(1, int(os.environ.get("TDX_SCHEDULE_CHECK_EVERY", str(DEFAULT_EVERY))))


def _check_timeout() -> float:
    return float(
        os.environ.get("TDX_SCHEDULE_CHECK_TIMEOUT_S", str(DEFAULT_TIMEOUT_S))
    )


class ScheduleVerifier:
    """Per-(group, rank) schedule fingerprint accumulator + store-based
    agreement protocol.

    ``store`` must be scoped to the group AND incarnation (the caller
    wraps the group store in a PrefixStore) so checkpoint keys from two
    groups or two init/destroy generations never collide. ``world`` is
    the number of *participating* processes — driver (single-controller)
    mode passes 1: one caller issues every rank's ops from a single
    schedule, so agreement is structural and only the fingerprint path
    (incl. the fault point) runs.
    """

    def __init__(
        self,
        store,
        rank: int,
        world: int,
        group_name: str,
        every: Optional[int] = None,
        timeout: Optional[float] = None,
    ):
        self.store = store
        self.rank = int(rank)
        self.world = int(world)
        self.group_name = group_name
        self.every = int(every) if every is not None else _check_every()
        self.timeout = float(timeout) if timeout is not None else _check_timeout()
        # digest chains across checkpoints: a divergence in ANY earlier
        # window keeps every later digest distinct, so the first
        # checkpoint after the divergence always trips
        self._digest = hashlib.sha256(group_name.encode()).hexdigest()
        self._window: List[str] = []  # fingerprints since last agreement
        self._count = 0
        self._round = 0

    # -- fingerprinting ----------------------------------------------------

    @staticmethod
    def fingerprint(seq: int, op_name: str, shape, dtype, detail: str = "") -> str:
        return f"{seq}|{op_name}|{tuple(shape)}|{dtype}|{detail}"

    def record(self, seq: int, op_name: str, shape, dtype, detail: str = "") -> None:
        """Fingerprint one dispatched collective; checkpoint every N."""
        fp = self.fingerprint(seq, op_name, shape, dtype, detail)
        # chaos seam: an advisory `corrupt` rule at schedule.mismatch
        # perturbs THIS rank's fingerprint, forcing a divergence the
        # next checkpoint must convert into a diagnostic
        rule = faults.fire("schedule.mismatch", op=op_name, seq=seq)
        if rule is not None and rule.action == "corrupt":
            fp += "|<injected-divergence>"
        self._window.append(fp)
        self._digest = hashlib.sha256(
            (self._digest + "\n" + fp).encode()
        ).hexdigest()
        self._count += 1
        if self._count % self.every == 0:
            self.verify()

    # -- the agreement protocol --------------------------------------------

    def verify(self) -> None:
        """Publish digest + window; block (bounded) for all ranks; compare.

        Raises ScheduleMismatchError on digest disagreement (naming the
        first divergent call in the window) or on checkpoint timeout
        (naming the ranks that never arrived — they issued fewer
        collectives, or are wedged inside a divergent one)."""
        if self.world <= 1 or self.store is None:
            self._window = []
            return
        self._round += 1
        rnd = self._round
        payload = json.dumps({"digest": self._digest, "window": self._window})
        self.store.set(f"{rnd}/{self.rank}", payload)
        keys = [f"{rnd}/{r}" for r in range(self.world)]
        try:
            self.store.wait(keys, self.timeout)
        except (DistError, OSError, TimeoutError) as e:
            missing = [
                r
                for r in range(self.world)
                if r != self.rank and not self._present(f"{rnd}/{r}")
            ]
            raise ScheduleMismatchError(
                f"schedule checkpoint {rnd} on group {self.group_name!r}: "
                f"rank(s) {missing or '<unknown>'} did not reach the "
                f"checkpoint within {self.timeout}s — they issued fewer "
                "collectives than this rank, or are wedged inside a "
                f"divergent one. This rank's last {min(len(self._window), 5)}"
                f" call(s) (seq|op|shape|dtype|detail): {self._window[-5:]}"
            ) from e
        divergent = {}
        for r in range(self.world):
            if r == self.rank:
                continue
            peer = json.loads(self.store.get(f"{rnd}/{r}").decode())
            if peer["digest"] != self._digest:
                divergent[r] = peer
        if divergent:
            r = sorted(divergent)[0]
            raise ScheduleMismatchError(
                f"collective schedule divergence on group "
                f"{self.group_name!r} at checkpoint {rnd} (ranks "
                f"{sorted(divergent)} disagree with rank {self.rank}): "
                + self._describe_divergence(r, divergent[r]["window"])
            )
        # agreement: the window is sealed into the digest; GC last round
        self._window = []
        if rnd > 1 and hasattr(self.store, "delete_key"):
            try:
                self.store.delete_key(f"{rnd - 1}/{self.rank}")
            except (DistError, OSError):
                pass  # best-effort GC of the agreed round's key

    def _present(self, key: str) -> bool:
        try:
            return bool(self.store.check([key]))
        except (DistError, OSError):
            return False

    def _describe_divergence(self, peer_rank: int, peer_window: List[str]) -> str:
        mine, theirs = self._window, list(peer_window)
        for i, (a, b) in enumerate(zip(mine, theirs)):
            if a != b:
                return (
                    f"first divergent call is #{i + 1} since the last "
                    f"checkpoint: rank {self.rank} issued {a!r}, rank "
                    f"{peer_rank} issued {b!r} (fingerprint is "
                    "seq|op|shape|dtype|detail)"
                )
        if len(mine) != len(theirs):
            longer, owner = (
                (mine, self.rank) if len(mine) > len(theirs) else (theirs, peer_rank)
            )
            extra = longer[min(len(mine), len(theirs))]
            return (
                f"rank {self.rank} issued {len(mine)} call(s) since the "
                f"last checkpoint but rank {peer_rank} issued "
                f"{len(theirs)}; first unmatched call on rank {owner}: "
                f"{extra!r}"
            )
        return (
            "the divergence predates this window (digests chain across "
            "checkpoints); rerun with TDX_SCHEDULE_CHECK_EVERY=1 to "
            "pinpoint the call"
        )


# ---------------------------------------------------------------------------
# J005: cross-rank compiled-PROGRAM agreement (TDX_PROGLINT=1)
# ---------------------------------------------------------------------------


def _first_divergent_eqn(
    mine: List[str], theirs: List[str], my_rank: int, peer_rank: int
) -> str:
    for i, (a, b) in enumerate(zip(mine, theirs)):
        if a != b:
            return (
                f"first divergent collective eqn is #{i + 1}: rank "
                f"{my_rank} compiled {a!r}, rank {peer_rank} compiled "
                f"{b!r} (eqn is primitive|axes|operands|params)"
            )
    if len(mine) != len(theirs):
        longer, owner = (
            (mine, my_rank)
            if len(mine) > len(theirs)
            else (theirs, peer_rank)
        )
        extra = longer[min(len(mine), len(theirs))]
        return (
            f"rank {my_rank} compiled {len(mine)} collective eqn(s) but "
            f"rank {peer_rank} compiled {len(theirs)}; first unmatched "
            f"eqn on rank {owner}: {extra!r}"
        )
    return (
        "collective eqn sequences match — the fingerprints diverge in "
        "the donation/aliasing set or program metadata"
    )


def agree_program(
    store,
    rank: int,
    world: int,
    key: str,
    payload: dict,
    timeout: Optional[float] = None,
) -> None:
    """Publish one compiled program's fingerprint and block (bounded)
    until every rank's copy agrees — the J005 half of `tools/proglint.py`,
    run at program REGISTRATION (compile) time, before first dispatch.

    ``store`` must be group- AND incarnation-scoped (the caller wraps the
    group store in a PrefixStore, mirroring the ScheduleVerifier
    contract); ``key`` identifies the agreement ROUND and must be
    position-based, not name-based — proglint keys by GLOBAL
    registration sequence (`reg{seq}`) so a rank that compiled a
    differently-named program at the same position is DIAGNOSED (the
    name rides in ``payload`` and is compared below); keying by name
    would make skewed ranks wait on keys that never appear and fail by
    timeout instead. ``payload`` is the fingerprint's canonical dict —
    ``digest`` (content hash) plus ``eqns`` (the ordered collective eqn
    descriptors, published so a mismatch can NAME the first divergent
    eqn rather than just two hashes).

    The `proglint.agree` fault point fires before publication; an
    advisory ``corrupt`` rule perturbs THIS rank's published digest, so
    chaos tests can prove a divergence is raised on EVERY rank (each
    rank compares peers against what it itself published) instead of
    hanging in the first dispatched collective."""
    timeout = (
        float(timeout)
        if timeout is not None
        else float(os.environ.get("TDX_PROGLINT_TIMEOUT_S", "60"))
    )
    name = str(payload.get("name", key))
    digest = str(payload["digest"])
    eqns = [str(e) for e in payload.get("eqns", [])]
    rule = faults.fire("proglint.agree", rank=rank, program=key)
    if rule is not None and rule.action == "corrupt":
        digest += "|<injected-divergence>"
    store.set(
        f"{key}/{rank}",
        json.dumps({"name": name, "digest": digest, "eqns": eqns}),
    )
    keys = [f"{key}/{r}" for r in range(world)]
    try:
        store.wait(keys, timeout)
    except (DistError, OSError, TimeoutError) as e:
        missing = []
        for r in range(world):
            if r == rank:
                continue
            try:
                if not store.check([f"{key}/{r}"]):
                    missing.append(r)
            except (DistError, OSError):
                missing.append(r)
        raise ProgramScheduleMismatchError(
            f"program agreement for {key!r}: rank(s) "
            f"{missing or '<unknown>'} never published a fingerprint "
            f"within {timeout}s — they did not compile this program "
            "(divergent compile paths), or compiled a differently-named "
            "one"
        ) from e
    for r in range(world):
        if r == rank:
            continue
        peer = json.loads(store.get(f"{key}/{r}").decode())
        peer_name = peer.get("name", key)
        if peer_name != name:
            raise ProgramScheduleMismatchError(
                f"compiled-program divergence at registration {key!r} "
                f"(caught at agreement time BEFORE any collective "
                f"executed): rank {rank} compiled {name!r} but rank {r} "
                f"compiled {peer_name!r} — the ranks took divergent "
                "compile paths; "
                + _first_divergent_eqn(eqns, list(peer["eqns"]), rank, r)
            )
        if peer["digest"] != digest:
            raise ProgramScheduleMismatchError(
                f"compiled-program divergence for {name!r} at "
                f"registration {key!r} (rank {r} disagrees with rank "
                f"{rank}, caught at agreement time BEFORE any collective "
                "executed): "
                + _first_divergent_eqn(eqns, list(peer["eqns"]), rank, r)
            )
