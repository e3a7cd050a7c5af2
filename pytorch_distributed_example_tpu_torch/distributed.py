"""c10d-shaped distributed API over rank-stacked tensors and torch.distributed.

Parity surface: `torch/distributed/distributed_c10d.py`, as the reference's
`distributed.py` answers it — backend registry, `init_process_group`
(`:1666`), `destroy_process_group` (`:2361`), rank/world queries
(`:2552,:2579`), p2p (`:2598-2990`), collectives (`:3086-5358`), object
collectives (`:3439,:3925,:4057`), `new_group` (`:5745`),
`monitored_barrier` (`:5360`), and the `_World` singleton (`:673`).

Two execution modes share this API, as in the reference:

* **driver mode** — one Python process acts for every rank of the group.
  Per-rank tensors are `DistTensor`s: one `(world, *shape)` tensor on one
  device (W ranks on `cuda:0`, or on the CPU), and collectives are torch
  computations over its rank dim (`backends/stacked.py`). `get_rank()`
  returns 0 — the driver acts for all ranks. The default when neither an
  `init_method` nor a launcher's `RANK`/`WORLD_SIZE` asks for a gang.
* **multiproc mode** — one process per rank, bootstrapped by the
  `init_method` rendezvous (`tcp://`, `env://`, `file://`) exactly like the
  reference. The rendezvous store carries the port's own control traffic
  and torch.distributed's rendezvous (`_TorchStore`); each process holds
  its row as a `(1, *shape)` DistTensor and collectives go through
  torch.distributed (`backends/process.py`): gloo for CPU tensors, nccl
  for CUDA tensors, or gloo for CUDA tensors too when the backend is
  given in torch's device form, `"cuda:gloo"` (processes that share one
  card: nccl refuses two ranks on one GPU). Point-to-point ops (`send`,
  `recv`, `isend`, `irecv`, `batch_isend_irecv`, and the row moves of
  `permute`) go through the direct p2p data plane (`p2p.P2PPlane`): every
  process publishes a listener endpoint at init, and tensor bytes move
  pair to pair over TCP (a CUDA tensor through pinned host memory). A
  rank that opted out (`TDX_P2P_PLANE=0`) publishes "none", and messages
  to it take the store path, as in the reference.

`plan_args` marks a collective plannable: with the collective planner on
(`TDX_COLLECTIVE_PLANNER=1` or `plan.enable_for_group`), `_dispatch` takes
the planner's schedule (`plan.maybe_lower`) in place of the stock one.
"""

from __future__ import annotations

import datetime
import enum
import logging
import os
import pickle
import sys
import threading as _threading
import time
from contextlib import contextmanager as _contextmanager
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.distributed as tdist

from . import backends as _backends
from . import faults as _faults
from . import schedule as _schedule
from .backends.base import Backend as _BackendBase
from .mesh import DeviceMesh, init_device_mesh, visible_devices
from .rendezvous import rendezvous as _rendezvous
from .store import HashStore, PrefixStore, Store
from .tensor import DistTensor
from .types import CompletedWork, DistError, OpType, ReduceOp, TensorWork, Work

logger = logging.getLogger(__name__)

# torch constants.py parity: default_pg_timeout == 30 minutes
default_pg_timeout = datetime.timedelta(minutes=30)

Backend = _backends  # registry module doubles as the Backend namespace
register_backend = _backends.register_backend


class GroupMember:
    """Sentinels — torch `distributed_c10d.py` GroupMember."""

    WORLD: Optional["ProcessGroup"] = None
    NON_GROUP_MEMBER = object()


def _poison_nan(out):
    """Injected payload corruption (fault action "corrupt"): a floating
    result becomes NaN, modeling a corrupted wire payload; integer and
    bool results pass through untouched. The multiply (not a fill) keeps
    dtype, device and shape. TDX_NAN_CHECK=1's debug audit then catches
    it exactly as it would a real corruption."""
    if isinstance(out, torch.Tensor) and out.dtype.is_floating_point:
        return out * float("nan")
    return out


class _DispatchMarker:
    """Watchdog entry that spans a collective from BEFORE dispatch: a
    synchronously-hung dispatch (fn() blocking on an absent peer) shows
    up as this marker never completing; once dispatch returns it
    delegates completion to the real Work."""

    def __init__(self):
        self._work = None
        self._abandoned = False

    def bind(self, work) -> None:
        self._work = work

    def abandon(self) -> None:  # dispatch raised: not a hang
        self._abandoned = True

    def is_completed(self) -> bool:
        if self._abandoned:
            return True
        return self._work is not None and self._work.is_completed()


def _dtype_name(dtype) -> str:
    """A dtype as the reference names it: `float32`, `bfloat16`, `int32`."""
    return str(dtype).removeprefix("torch.")


class ProcessGroup:
    """A set of ranks + their mesh + a concrete backend.

    Parity: torch c10d `ProcessGroup.hpp:73` frontend — here the "device" is
    always the group's 1-D mesh and there is exactly one backend instance
    per group.
    """

    def __init__(
        self,
        mesh: DeviceMesh,
        ranks: List[int],
        backend_name: str,
        backend: _BackendBase,
        store: Optional[Store],
        name: str,
        timeout: float,
        torch_group=None,
    ):
        self.mesh = mesh.flattened("_ranks")
        self.ranks = list(ranks)
        self.backend_name = backend_name
        self._backend = backend
        self.store = store
        self.group_name = name
        self.timeout = timeout
        self.bound_device_id = None
        self.torch_group = torch_group  # multiproc: the torch.distributed group
        from .utils.logger import ProcessGroupStatus

        self.status = ProcessGroupStatus()
        self.watchdog = None  # set by enable_watchdog()
        self._sched = None  # ScheduleVerifier, set under TDX_SCHEDULE_CHECK=1
        self._inflight: List = []  # (work, done_cb) pending completion sweep

    @property
    def device(self) -> torch.device:
        """The device this process's tensors of the group live on."""
        return self.mesh.device

    def enable_watchdog(self, timeout_s: Optional[float] = None, **kw):
        """Start a hang watchdog over this group's in-flight collectives
        (torch NCCL Watchdog parity)."""
        from .utils.watchdog import Watchdog

        if self.watchdog is not None:  # replacing: never leak a scanner
            self.watchdog.stop()
        self.watchdog = Watchdog(
            timeout_s=timeout_s if timeout_s is not None else self.timeout, **kw
        ).start()
        return self.watchdog

    def _sweep_inflight(self) -> None:
        """Mark completion for sync-path works whose events fired (the sync
        path never calls wait(), so completion is observed here and by any
        later wait())."""
        still = []
        for work, done in self._inflight:
            if work.is_completed():
                done()
            else:
                still.append((work, done))
        self._inflight = still

    def _dispatch(self, op_name: str, tensor, fn, detail: str = "",
                  plan_args: Optional[Dict[str, Any]] = None, async_op: bool = True):
        """Run one collective with full observability: sequence number,
        ProcessGroupStatus, FlightRecorder entry, watchdog registration,
        completion sweep. `detail` carries op parameters that must agree
        across ranks but are invisible in (op, shape, dtype) — the
        reduce op, broadcast source, permute pairs — so the schedule
        fingerprint (TDX_SCHEDULE_CHECK) catches e.g. rank 0 running
        SUM while rank 1 runs MAX.

        Shapes are recorded as the reference records them, with the rank
        dim at the group's size: (world, *per-rank shape) in both modes.
        `plan_args` marks the op plannable: when the collective planner
        is active for this group, the stock `fn` is swapped for the
        planner's schedule (`plan.maybe_lower`: the rank-stacked bodies of
        `plan/driver.py` in driver mode, the plan walked over the p2p
        plane in multiproc mode); the planner declining (None) keeps `fn`,
        and the op fingerprint is the same either way. A sync-path
        Work (`async_op=False`: the caller never sees it) drops its result:
        the host runs ahead of the card, and the completion sweep would
        otherwise pin the output of every collective still queued."""
        from .utils.flight_recorder import global_recorder

        if plan_args is not None:
            from . import plan as _plan_mod

            alt = _plan_mod.maybe_lower(self, op_name, tensor, plan_args, fallback=fn)
            if alt is not None:
                fn = alt
        self._sweep_inflight()
        seq = self._backend.next_sequence_number()
        shape = () if tensor is None else (self.size(),) + tuple(tensor.shape[1:])
        numel = 1
        for s in shape:
            numel *= int(s)
        dtype = "" if tensor is None else _dtype_name(tensor.dtype)
        # schedule fingerprint BEFORE any dispatch bookkeeping: a
        # divergence diagnostic must fire before the op could wedge the
        # transport, and a raise here must not leave a forever-enqueued
        # flight-recorder entry
        if self._sched is not None:
            self._sched.record(seq, op_name, shape, dtype, detail)
        tapped = bool(_schedule._taps)
        if tapped:  # the program plane (`tools/proglint.py`): one rank's shape
            _schedule.tap_record("c10d", op_name, self.mesh.axis_names, shape[1:], dtype,
                                 {"detail": detail})
        self.status.record_enqueue(seq, op_name, numel)
        rec = global_recorder()
        rec.record(seq, op_name, self.group_name, shape, dtype, numel)
        # Register with the watchdog BEFORE dispatch: a gloo collective
        # can BLOCK inside fn() when a peer never joins — a post-dispatch
        # registration would never happen and the hang would be
        # invisible. The marker counts from now and delegates to the real
        # Work once dispatch returns.
        marker = None
        if self.watchdog is not None:
            marker = _DispatchMarker()
            self.watchdog.register(marker, f"{self.group_name}:{op_name}:{seq}")
        try:
            # fault injection INSIDE watchdog coverage: an injected
            # "hang" shows up exactly like a real wedged dispatch (the
            # marker never completes, the watchdog dumps + aborts), and
            # an injected raise takes the failure bookkeeping below
            rule = _faults.fire("collective.dispatch", op=op_name, seq=seq)
            if tapped:  # the op is recorded; the schedule it lowers to is not
                with _schedule.taps_muted():
                    out, work = fn()
            else:
                out, work = fn()
        except Exception:
            # a raised collective is a failure, not a hang: mark it so the
            # flight recorder / status don't show it as forever-enqueued
            if marker is not None:
                marker.abandon()
            rec.complete(seq, self.group_name, failed=True)
            raise
        if rule is not None and rule.action == "corrupt":
            out = _poison_nan(out)
        if marker is not None:
            marker.bind(work)

        fired = []

        def _done(seq=seq, op=op_name, numel=numel, fired=fired):
            if fired:
                return
            fired.append(True)
            rec.complete(seq, self.group_name)
            self.status.record_complete(seq, op, numel)

        if hasattr(work, "_on_complete") and work._on_complete is None:
            work._on_complete = _done
            self._inflight.append((work, _done))
            if len(self._inflight) > 512:  # bound bookkeeping + buffer pins
                w0, d0 = self._inflight.pop(0)
                w0.wait()
        else:
            _done()
        if not async_op and isinstance(work, TensorWork):
            work.release()
        _register_with_active_cm(self, work)
        return out, work

    # -- identity ----------------------------------------------------------
    def size(self) -> int:
        return len(self.ranks)

    def rank(self) -> int:
        """The calling process's rank within this group (driver mode: 0)."""
        w = _world
        if w.mode == "driver":
            return 0
        try:
            return self.ranks.index(w.process_rank)
        except ValueError:
            return -1

    def get_group_rank(self, global_rank: int) -> int:
        return self.ranks.index(global_rank)

    def get_global_rank(self, group_rank: int) -> int:
        return self.ranks[group_rank]

    @property
    def backend_impl(self) -> _BackendBase:
        return self._backend

    def _check_member(self, rank: int) -> None:
        if rank < 0 or rank >= self.size():
            raise ValueError(f"rank {rank} out of range for group of size {self.size()}")

    def __repr__(self):
        return (
            f"ProcessGroup(name={self.group_name!r}, backend={self.backend_name!r}, "
            f"ranks={self.ranks}, device={self.device})"
        )


@dataclass
class _WorldState:
    """Global PG bookkeeping — torch `_World` (`distributed_c10d.py:673`)."""

    default_pg: Optional[ProcessGroup] = None
    pg_map: Dict[str, ProcessGroup] = field(default_factory=dict)
    pg_names: Dict[int, str] = field(default_factory=dict)
    group_count: int = 0
    mode: str = "driver"  # "driver" (single-controller) | "multiproc"
    process_rank: int = 0
    store: Optional[Store] = None
    generation: int = 0  # init_process_group incarnation (store-key scope)
    scope: str = "0"  # full store-key scope: incarnation + agent restart gen
    # multiproc: the adapter torch.distributed holds; kept referenced here,
    # since torch keeps only its C++ half alive
    torch_store: Optional["_TorchStore"] = None
    # multiproc: the transport of CUDA tensors ("nccl", or "gloo" when the
    # backend was given as "cuda:gloo")
    cuda_transport: str = "nccl"


_world = _WorldState()
_init_generation = 0  # survives destroy; see init_process_group


class _TorchStore(tdist.Store):
    """The port's store as a torch.distributed Store, so torch.distributed's
    own rendezvous (its groups' keys, gloo's and nccl's connection
    exchange) runs over the port's store and wire protocol."""

    def __init__(self, store: Store):
        super().__init__()
        self._store = store

    def set(self, key, value):
        self._store.set(key, value if isinstance(value, str) else bytes(value))

    def get(self, key):
        return self._store.get(key)

    def add(self, key, value):
        return self._store.add(key, value)

    def compare_set(self, key, expected, desired):
        return self._store.compare_set(key, expected, desired)

    def check(self, keys):
        return self._store.check(list(keys))

    def wait(self, keys, timeout=None):
        t = timeout.total_seconds() if isinstance(timeout, datetime.timedelta) else None
        self._store.wait(list(keys), t)

    def delete_key(self, key):
        return self._store.delete_key(key)

    def num_keys(self):
        return self._store.num_keys()


# ---------------------------------------------------------------------------
# lifecycle
# ---------------------------------------------------------------------------


def is_initialized() -> bool:
    return _world.default_pg is not None


def _get_default_group() -> ProcessGroup:
    if _world.default_pg is None:
        raise RuntimeError(
            "Default process group has not been initialized, "
            "please make sure to call init_process_group."
        )
    return _world.default_pg


def _resolve(group: Optional[ProcessGroup]) -> ProcessGroup:
    if group is None or group is GroupMember.WORLD:
        return _get_default_group()
    return group


def _timeout_seconds(timeout) -> float:
    if timeout is None:
        return default_pg_timeout.total_seconds()
    if isinstance(timeout, datetime.timedelta):
        return timeout.total_seconds()
    return float(timeout)


def _launched() -> bool:
    """A launcher (torchrun, the elastic agent) exported a gang of > 1."""
    return "RANK" in os.environ and int(os.environ.get("WORLD_SIZE", "1")) > 1


def _card(rank: int) -> torch.device:
    """This process's card in multiproc mode: LOCAL_RANK's, else one card
    per rank in turn (one process per card on a host)."""
    devs = visible_devices()
    if not devs:
        raise RuntimeError(
            "no CUDA device: pass device='cpu' to run the process group on the CPU"
        )
    local = int(os.environ.get("LOCAL_RANK", rank))
    return devs[local % len(devs)]


def _torch_backend(device: torch.device) -> str:
    """torch.distributed's backend for a group of this process's tensors.
    gloo carrying CUDA tensors keeps a CPU half for the rows it stages
    through host memory (`backends/process.py`)."""
    if device.type != "cuda":
        return "gloo"
    return "cpu:gloo,cuda:gloo" if _world.cuda_transport == "gloo" else "nccl"


def _split_backend(backend: str) -> Tuple[str, Optional[str]]:
    """(registered backend name, CUDA transport or None) of a backend
    string; torch's device form "cuda:gloo" (or "cpu:gloo,cuda:gloo")
    names the transport of CUDA tensors."""
    if ":" not in backend:
        return backend, None
    try:
        pairs = dict(part.split(":") for part in backend.split(","))
    except ValueError:
        raise ValueError(f"backend {backend!r}: expected device:backend pairs") from None
    cuda = pairs.get("cuda")
    if cuda not in ("gloo", "nccl") or set(pairs.values()) - {"gloo", "nccl"}:
        raise ValueError(f"backend {backend!r}: CUDA tensors travel by gloo or nccl")
    return cuda, cuda


def init_process_group(
    backend: Optional[str] = None,
    init_method: Optional[str] = None,
    timeout=None,
    world_size: int = -1,
    rank: int = -1,
    store: Optional[Store] = None,
    group_name: str = "",
    device_mesh: Optional[DeviceMesh] = None,
    device=None,
) -> ProcessGroup:
    """Bring up the default process group.

    Mirrors torch `init_process_group` (`distributed_c10d.py:1666`):
    mutually-exclusive `store` vs `init_method`, PrefixStore namespacing
    (`:1895`), rank-prefixed excepthook install (`:1924-1940`). Backend
    strings "xla", "gloo" and "nccl" name the same collective backend, so
    the reference's stock CLI (`--backend gloo`) runs unchanged.

    `backend="cuda:gloo"` (torch's device form) carries CUDA tensors by
    gloo in multiproc mode, for processes that share one card; nccl, the
    default for CUDA tensors, refuses two ranks on one GPU.

    Multiproc mode is asked for by an `init_method`, by a `store` with a
    `rank`, or by a launcher's RANK/WORLD_SIZE (then `env://`); otherwise
    this process drives every rank. `device` is where this process's
    tensors live: by default `cuda:0` in driver mode and this rank's card
    in multiproc mode; both raise without a card, so a CPU run passes
    `device="cpu"`. In driver mode `world_size=-1` means one rank per
    visible card, and every rank is stacked on `device`, so W may exceed
    the number of cards.
    """
    global _world
    if is_initialized():
        raise RuntimeError("trying to initialize the default process group twice!")
    if store is not None and init_method is not None:
        raise ValueError("Cannot specify both init_method and store.")
    if tdist.is_initialized():
        raise RuntimeError(
            "torch.distributed already has a default group: the port's "
            "multiproc mode builds its own from the port's store"
        )

    backend, cuda_transport = _split_backend((backend or "xla").lower())
    _backends.creator_of(backend)  # an unknown backend raises before any setup
    tsec = _timeout_seconds(timeout)
    multiproc = init_method is not None or (store is not None and rank >= 0) or (
        store is None and _launched()
    )

    if multiproc:
        if store is None:
            # torch defaults init_method to env:// when neither store nor
            # init_method is given (distributed_c10d.py:1666 docs)
            store, rank, world_size = next(
                iter(_rendezvous(init_method or "env://", rank, world_size, timeout=tsec))
            )
        if world_size < 1 or not 0 <= rank < world_size:
            raise ValueError(f"multiproc mode: rank {rank} of world_size {world_size}")
        dev = torch.device(device) if device is not None else _card(rank)
        _world.mode = "multiproc"
        _world.process_rank = rank
        _world.cuda_transport = cuda_transport or "nccl"
    else:
        if rank not in (-1, 0):
            raise ValueError(
                "driver mode: this process acts for all ranks; pass rank=0 or omit it"
            )
        if device is not None:
            dev = torch.device(device)
        elif device_mesh is not None:
            dev = device_mesh.device
        else:
            dev = _card(0)
        if world_size == -1:
            world_size = device_mesh.size if device_mesh is not None else (
                len(visible_devices()) or 1)
        if world_size < 1:
            raise ValueError(f"world_size must be -1 or at least 1, got {world_size}")
        _world.mode = "driver"
        _world.process_rank = 0
        if store is None:
            # driver mode: all ranks live in this process; in-process store
            store = HashStore(tsec)
    _world.store = store
    # Incarnation-scoped namespace: a store object reused across
    # init/destroy cycles must not leak one incarnation's barrier/teardown
    # keys into the next (torch scopes by group_count the same way). Every
    # process calls init/destroy collectively, so a local counter agrees
    # across ranks.
    global _init_generation
    _init_generation += 1
    _world.generation = _init_generation
    # Under an elastic agent with a PERSISTENT store, fresh worker processes
    # all restart at incarnation 1 — the agent's restart count
    # disambiguates them.
    rc = os.environ.get("TDX_RESTART_COUNT")
    _world.scope = f"{_init_generation}" + (f"_r{rc}" if rc else "")
    prefixed = PrefixStore(f"default_pg_gen{_world.scope}", store)

    torch_group = None
    if multiproc:
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        _world.torch_store = _TorchStore(PrefixStore("torch_c10d", prefixed))
        tdist.init_process_group(
            backend=_torch_backend(dev), store=_world.torch_store, rank=rank,
            world_size=world_size, timeout=datetime.timedelta(seconds=tsec),
        )
        torch_group = tdist.group.WORLD

    if device_mesh is not None:
        mesh = device_mesh
    else:
        mesh = init_device_mesh(("dp",), (world_size,), devices=[dev] * world_size)

    pg = _new_group_internal(
        list(range(world_size)), backend, prefixed, "default_pg", tsec, mesh, torch_group
    )
    _world.default_pg = pg
    GroupMember.WORLD = pg
    if multiproc:
        # Direct p2p data plane (gloo's full-mesh pair connections,
        # ProcessGroupGloo.hpp:48+): every rank publishes a listener
        # endpoint; tensor bytes then move pair-to-pair instead of
        # through the store daemon or gloo. Must run on EVERY rank — an
        # opted-out rank publishes "none" so peers take the store path
        # instead of blocking on the endpoint key.
        global _p2p_plane
        from . import p2p as _p2p_mod

        _p2p_plane = _p2p_mod.P2PPlane(
            _world.process_rank,
            PrefixStore(f"p2p_plane_gen{_world.scope}", store),
            enabled=os.environ.get("TDX_P2P_PLANE", "1") != "0",
        ).start()
    # both modes: default ON under the elastic agent, TDX_WATCHDOG=1
    # opts in anywhere (driver mode included — a wedged collective
    # should dump + abort there too, not sit on the 30-min PG timeout)
    _maybe_enable_default_watchdog(pg)
    _install_rank_excepthook()
    return pg


def _maybe_enable_default_watchdog(pg: ProcessGroup) -> None:
    """Hang-to-recovery composition: under an elastic agent, a worker
    wedged inside a collective (peer lost mid-op) must not stall the gang
    until the 30-min PG timeout — the watchdog dumps the flight recorder
    and ABORTS the process, the agent observes the death and re-forms the
    gang. This is torch's NCCL-watchdog → torchelastic composition
    (ProcessGroupNCCL.hpp:676 abort → elastic/agent/server/api.py:952
    restart).

    Default ON when launched by the elastic agent (TDX_AGENT_STORE in
    the env), opt-in/out anywhere via TDX_WATCHDOG=1/0; the trip
    timeout TDX_WATCHDOG_TIMEOUT_S (default 300 s) must stay well under
    the PG timeout and far above the slowest healthy collective."""
    default = "1" if "TDX_AGENT_STORE" in os.environ else "0"
    if os.environ.get("TDX_WATCHDOG", default) == "0":
        return
    _arm_abort_watchdog(pg)


def _arm_abort_watchdog(pg: ProcessGroup) -> None:
    """Arm the dump-and-abort watchdog on one group. Shared by the
    default group and every subgroup created while the default watchdog
    is active — torch's NCCL watchdog covers EVERY ProcessGroupNCCL, so a
    collective hung on a `new_group` subgroup must be just as visible as
    one hung on WORLD."""
    timeout_s = float(os.environ.get("TDX_WATCHDOG_TIMEOUT_S", "300"))

    def _abort(desc: str, work, dump_path: str) -> None:
        print(
            f"[rank {_world.process_rank}] watchdog: collective "
            f"{desc!r} exceeded {timeout_s}s; flight recorder dumped to "
            f"{dump_path or '<disabled>'}; aborting so the elastic agent "
            "can re-form the gang",
            file=sys.stderr,
            flush=True,
        )
        os._exit(int(os.environ.get("TDX_WATCHDOG_EXIT_CODE", "3")))

    pg.enable_watchdog(timeout_s=timeout_s, on_timeout=_abort)


def _new_group_internal(
    ranks: List[int],
    backend_name: str,
    store: Optional[Store],
    name: str,
    tsec: float,
    mesh: Optional[DeviceMesh] = None,
    torch_group=None,
) -> ProcessGroup:
    if mesh is None:
        world = _get_default_group()
        mesh = world.mesh.submesh([world.ranks.index(r) if r in world.ranks else r for r in ranks])
    flat = mesh.flattened("_ranks")
    multiproc = _world.mode == "multiproc"
    # the calling process's rank in the group (driver mode: it acts for 0);
    # a non-member process still constructs the group object collectively
    # but never dispatches on it
    my = (ranks.index(_world.process_rank) if _world.process_rank in ranks else -1) \
        if multiproc else 0
    backend = _backends.create_backend(backend_name, flat, my, len(ranks), tsec,
                                       torch_group if my >= 0 else None)
    if get_debug_level() == DebugLevel.DETAIL:
        # torch: TORCH_DISTRIBUTED_DEBUG=DETAIL wraps every group in
        # ProcessGroupWrapper (distributed_c10d.py:5440) — collective
        # fingerprints are compared across ranks before dispatch, keyed
        # by GROUP rank (pgw/<seq>/<rank>)
        from .backends.wrapper import ProcessGroupWrapper

        backend = ProcessGroupWrapper(
            backend,
            store,
            my,
            len(ranks),
            driver_mode=not multiproc,
        )
    pg = ProcessGroup(flat, ranks, backend_name, backend, store, name, tsec, torch_group)
    if _schedule.enabled() and store is not None:
        # multiproc: group-rank keyed agreement through the store. Driver
        # mode: one caller issues every rank's schedule, so agreement is
        # structural — world=1 keeps the fingerprint path (and the
        # schedule.mismatch fault seam) live without store traffic.
        w = len(ranks) if multiproc else 1
        if my >= 0:
            pg._sched = _schedule.ScheduleVerifier(
                PrefixStore("sched", store), my, w, name
            )
    # watchdog coverage follows the default group: torch's NCCL watchdog
    # scans every PG, not just WORLD
    default_pg = _world.default_pg
    if default_pg is not None and default_pg.watchdog is not None:
        _arm_abort_watchdog(pg)
    _world.pg_map[name] = pg
    _world.pg_names[id(pg)] = name
    _world.group_count += 1
    return pg


def new_group(
    ranks: Optional[Sequence[int]] = None,
    timeout=None,
    backend: Optional[str] = None,
    group_desc: Optional[str] = None,
) -> ProcessGroup:
    """Create a subgroup — torch `new_group` (`distributed_c10d.py:5745`).
    In multiproc mode every process calls it, members or not, as in torch."""
    world = _get_default_group()
    if ranks is None:
        ranks = list(world.ranks)
    ranks = sorted(int(r) for r in ranks)
    for r in ranks:
        if r not in world.ranks:
            raise ValueError(f"rank {r} not in world {world.ranks}")
    name = group_desc or f"group_{_world.group_count}"
    tsec = _timeout_seconds(timeout) if timeout is not None else world.timeout
    # Incarnation-scoped like the default pg's prefix: group names
    # ("group_N") reset with _world on every init/destroy cycle, so under
    # an elastic restart with a PERSISTENT store daemon a bare name would
    # leak the dead incarnation's keys (pgw fingerprints, monitored-
    # barrier rounds, sched checkpoints, objcnt rounds) into the new gang.
    store = (
        PrefixStore(f"{name}_gen{_world.scope}", _world.store)
        if _world.store is not None
        else None
    )
    submesh = world.mesh.submesh([world.ranks.index(r) for r in ranks])
    torch_group = None
    if _world.mode == "multiproc":
        torch_group = tdist.new_group(
            ranks=ranks, timeout=datetime.timedelta(seconds=tsec),
            backend=_torch_backend(world.device),
        )
    return _new_group_internal(
        ranks, backend or world.backend_name, store, name, tsec, submesh, torch_group
    )


def new_subgroups(
    group_size: Optional[int] = None, timeout=None, backend: Optional[str] = None
) -> Tuple[ProcessGroup, List[ProcessGroup]]:
    """Split the world into equal contiguous subgroups — torch
    `new_subgroups` (`distributed_c10d.py:6103`). Returns (the calling
    rank's subgroup, all subgroups); in driver mode the caller holds every
    rank, so "its" subgroup is defined as the first."""
    world = _get_default_group()
    W = world.size()
    if group_size is None:
        raise ValueError("group_size required")
    if W % group_size != 0:
        raise ValueError(f"world size {W} not divisible by group_size {group_size}")
    groups = []
    cur = None
    me = _world.process_rank
    for start in range(0, W, group_size):
        rs = range(start, start + group_size)
        g = new_group(rs, timeout=timeout, backend=backend)
        groups.append(g)
        if me in rs:
            cur = g
    return (cur if cur is not None else groups[0]), groups


def destroy_process_group(group: Optional[ProcessGroup] = None) -> None:
    """torch `destroy_process_group` (`distributed_c10d.py:2361`).

    Multiproc teardown handshake: the rank hosting the TCPStore daemon
    must not stop it (or exit) while peers are still mid-store-op — e.g.
    a slower rank finishing `monitored_barrier` would see connection
    errors and misreport missing ranks. Every rank marks its departure in
    the store; the daemon host waits (bounded) for all marks before the
    daemon goes down.
    """
    global _world, _p2p_plane
    if group is None or group is _world.default_pg or group is GroupMember.WORLD:
        for pg in _world.pg_map.values():
            if pg.watchdog is not None:
                # a scanner outliving its generation could os._exit a
                # healthy process minutes after teardown (its Works
                # never complete once the backend is gone)
                pg.watchdog.stop()
                pg.watchdog = None
            pg.backend_impl.shutdown()
        if _p2p_plane is not None:
            # before torch's groups are dropped and before the store
            # teardown handshake: the listener and reader threads end
            # here, and waiters wake with a clear "closed" error rather
            # than a store connection error
            _p2p_plane.close()
            _p2p_plane = None
        from .plan import traced as _traced

        _traced.reset()
        if tdist.is_initialized():
            tdist.destroy_process_group()  # every torch.distributed group
        # Drop the last references to torch's groups here, so their gloo
        # worker threads are joined now. A ProcessGroup the caller still
        # holds (init_process_group's and new_group's return values) used
        # to keep its torch group alive until interpreter finalization;
        # joining its threads there meant a worker that needed the GIL
        # (to free its last work's tensors) was ended by Python's
        # pthread_exit, whose forced unwind through a noexcept frame calls
        # std::terminate: "terminate called without an active exception".
        for pg in _world.pg_map.values():
            pg.torch_group = None
        _world.torch_store = None
        st = _world.store
        if st is not None:
            if _world.mode == "multiproc" and _world.default_pg is not None:
                try:
                    w = _world.default_pg.size()
                    scope = _world.scope
                    st.set(f"tdx_destroy/gen{scope}/{_world.process_rank}", b"1")  # storelint: disable=S005 -- teardown rendezvous rows; the store daemon exits with the job they end
                    if getattr(st, "is_master", False):
                        st.wait(
                            [f"tdx_destroy/gen{scope}/{r}" for r in range(w)],
                            min(30.0, _world.default_pg.timeout),
                        )
                except (DistError, OSError):
                    # peers may have crashed; never hang teardown — but
                    # leave a trace for post-mortems
                    logger.debug(
                        "teardown departure handshake failed", exc_info=True
                    )
            if hasattr(st, "close"):
                try:
                    st.close()
                except (DistError, OSError):
                    logger.debug(
                        "store close failed during teardown", exc_info=True
                    )
        _world = _WorldState()
        GroupMember.WORLD = None
    else:
        if group.watchdog is not None:
            group.watchdog.stop()
            group.watchdog = None
        group.backend_impl.shutdown()
        if group.torch_group is not None and group.torch_group is not tdist.GroupMember.NON_GROUP_MEMBER:
            tdist.destroy_process_group(group.torch_group)
        group.torch_group = None  # joins its threads now (see above)
        _world.pg_map.pop(group.group_name, None)


def get_rank(group: Optional[ProcessGroup] = None) -> int:
    if not is_initialized():
        return -1
    return _resolve(group).rank()


def get_world_size(group: Optional[ProcessGroup] = None) -> int:
    if not is_initialized():
        return -1
    return _resolve(group).size()


def get_backend(group: Optional[ProcessGroup] = None) -> str:
    return _resolve(group).backend_name


def get_process_group_ranks(group: Optional[ProcessGroup] = None) -> List[int]:
    return list(_resolve(group).ranks)


def _install_rank_excepthook() -> None:
    """Rank-prefixed excepthook — torch `distributed_c10d.py:1924-1940`."""
    if getattr(_install_rank_excepthook, "_installed", False):
        return
    old_hook = sys.excepthook

    def _hook(exc_type, exc_value, exc_tb):
        prefix = f"[rank{_world.process_rank}]"
        try:
            sys.stderr.write(f"{prefix}: ")
        except Exception:  # distlint: disable=R005 -- excepthook must never itself raise; stderr may be closed
            pass
        old_hook(exc_type, exc_value, exc_tb)

    sys.excepthook = _hook
    _install_rank_excepthook._installed = True


# ---------------------------------------------------------------------------
# tensor coercion helpers
# ---------------------------------------------------------------------------


def _as_dist(tensor, group: ProcessGroup) -> DistTensor:
    if isinstance(tensor, DistTensor):
        return tensor
    raise TypeError(
        "collectives take DistTensor (per-rank tensors packed rank-major); "
        "build one with DistTensor.from_rank_fn / from_stacked / from_process_local"
    )


def _finish(dt: DistTensor, out, work: Work, async_op: bool):
    dt._set(out)
    if async_op:
        return work
    # sync path: dispatch already enqueued; like torch we return None.
    # correctness does not require a host block (reads wait on the data).
    return None


# ---------------------------------------------------------------------------
# collectives
# ---------------------------------------------------------------------------


def all_reduce(tensor, op: ReduceOp = ReduceOp.SUM, group=None, async_op: bool = False):
    """torch `all_reduce` (`distributed_c10d.py:3156`) — in-place on the
    DistTensor; `types.fold(op)` over the group's ranks."""
    g = _resolve(group)
    dt = _as_dist(tensor, g)
    out, work = g._dispatch(
        "all_reduce",
        dt.tensor,
        lambda: g.backend_impl.allreduce(dt.tensor, op),
        detail=str(op),
        plan_args={"reduce_op": op},
        async_op=async_op,
    )
    return _finish(dt, out, work, async_op)


def broadcast(tensor, src: int, group=None, async_op: bool = False):
    """torch `broadcast` (`distributed_c10d.py:3086`)."""
    g = _resolve(group)
    g._check_member(src)
    dt = _as_dist(tensor, g)
    out, work = g._dispatch(
        "broadcast",
        dt.tensor,
        lambda: g.backend_impl.broadcast(dt.tensor, src),
        detail=f"src={src}",
        async_op=async_op,
    )
    return _finish(dt, out, work, async_op)


def reduce(tensor, dst: int, op: ReduceOp = ReduceOp.SUM, group=None, async_op: bool = False):
    """torch `reduce` (`distributed_c10d.py:3337`) — only dst's slot holds
    the reduction; other ranks keep their input."""
    g = _resolve(group)
    g._check_member(dst)
    dt = _as_dist(tensor, g)
    out, work = g._dispatch(
        "reduce",
        dt.tensor,
        lambda: g.backend_impl.reduce(dt.tensor, dst, op),
        detail=f"dst={dst},{op}",
        async_op=async_op,
    )
    return _finish(dt, out, work, async_op)


def all_gather(tensor, group=None, async_op: bool = False) -> Union[DistTensor, Tuple[DistTensor, Work]]:
    """torch `all_gather` (`distributed_c10d.py:4192`). Returns a new
    DistTensor whose per-rank value is the stacked (world, *shape) gather
    (the rank axis replaces torch's output tensor list)."""
    g = _resolve(group)
    dt = _as_dist(tensor, g)
    out, work = g._dispatch(
        "all_gather",
        dt.tensor,
        lambda: g.backend_impl.allgather(dt.tensor),
        plan_args={},
        async_op=async_op,
    )
    res = DistTensor(out, g)
    return (res, work) if async_op else res


def gather(tensor, dst: int = 0, group=None, async_op: bool = False):
    """torch `gather` (`distributed_c10d.py:4568`): dst's slot holds the
    stacked gather; other slots are zeros."""
    g = _resolve(group)
    g._check_member(dst)
    dt = _as_dist(tensor, g)
    out, work = g._dispatch(
        "gather",
        dt.tensor,
        lambda: g.backend_impl.gather(dt.tensor, dst),
        detail=f"dst={dst}",
        async_op=async_op,
    )
    res = DistTensor(out, g)
    return (res, work) if async_op else res


def scatter(tensor, src: int = 0, group=None, async_op: bool = False):
    """torch `scatter` (`distributed_c10d.py:4672`): input per-rank value is
    a (world, *shape) chunk list (only src's row matters); each rank
    receives its chunk."""
    g = _resolve(group)
    g._check_member(src)
    dt = _as_dist(tensor, g)
    if dt.shape[0] != g.size():
        raise ValueError(
            f"scatter input per-rank leading dim {dt.shape[0]} != world {g.size()}"
        )
    out, work = g._dispatch(
        "scatter",
        dt.tensor,
        lambda: g.backend_impl.scatter(dt.tensor, src),
        detail=f"src={src}",
        async_op=async_op,
    )
    res = DistTensor(out, g)
    return (res, work) if async_op else res


def reduce_scatter(tensor, op: ReduceOp = ReduceOp.SUM, group=None, async_op: bool = False):
    """torch `reduce_scatter` (`distributed_c10d.py:4790`): input per-rank
    value is a (world, *shape) chunk list; output is each rank's reduced
    chunk."""
    g = _resolve(group)
    dt = _as_dist(tensor, g)
    if dt.shape[0] != g.size():
        raise ValueError(
            f"reduce_scatter input per-rank leading dim {dt.shape[0]} != world {g.size()}"
        )
    out, work = g._dispatch(
        "reduce_scatter",
        dt.tensor,
        lambda: g.backend_impl.reduce_scatter(dt.tensor, op),
        detail=str(op),
        plan_args={"reduce_op": op},
        async_op=async_op,
    )
    res = DistTensor(out, g)
    return (res, work) if async_op else res


def all_to_all(tensor, group=None, async_op: bool = False):
    """torch `all_to_all` (`distributed_c10d.py:5145`): per-rank value is a
    (world, *shape) list; row j of rank i goes to rank j's row i."""
    g = _resolve(group)
    dt = _as_dist(tensor, g)
    if dt.shape[0] != g.size():
        raise ValueError(
            f"all_to_all input per-rank leading dim {dt.shape[0]} != world {g.size()}"
        )
    out, work = g._dispatch("all_to_all", dt.tensor, lambda: g.backend_impl.alltoall(dt.tensor),
                            async_op=async_op)
    res = DistTensor(out, g)
    return (res, work) if async_op else res


def permute(tensor, perm, group=None, async_op: bool = False):
    """Move rows between ranks: for each (src, dst) pair of `perm`, rank
    dst's row becomes rank src's (the reference's `ppermute`); a rank no
    pair sends to keeps its row. In place on the DistTensor. Multiproc
    mode moves the rows over the p2p plane, so every rank of the group
    calls it with the same pairs, a rank with nothing to send or receive
    too."""
    g = _resolve(group)
    dt = _as_dist(tensor, g)
    perm = [(int(s), int(d)) for s, d in perm]
    for s_, d_ in perm:
        g._check_member(s_)
        g._check_member(d_)
    if _world.mode == "multiproc":
        verify = getattr(g.backend_impl, "_verify", None)  # DETAIL's cross-rank check
        if verify is not None:
            verify(f"permute:{tuple(perm)}", dt.tensor)
        fn = lambda: _permute_p2p(dt.tensor, perm, g)  # noqa: E731
    else:
        fn = lambda: g.backend_impl.permute(dt.tensor, perm)  # noqa: E731
    out, work = g._dispatch("permute", dt.tensor, fn, detail=f"perm={perm}",
                            async_op=async_op)
    return _finish(dt, out, work, async_op)


# the row moves of a multiproc `permute` ride their own internal channel
_PERMUTE_TAG = (1 << 30) - 8


def _permute_p2p(x: torch.Tensor, perm, g: ProcessGroup):
    """Multiproc `permute` over the p2p plane: this process sends its row
    to every dst a pair names (sends first, so no pair waits on another),
    then lands the row of the pair that sends here."""
    from .backends.process import _count

    me, out, row = g.rank(), x.clone(), x[0]
    with _count("permute", row):
        for s_, d_ in perm:
            if s_ == me and d_ != me:
                _store_send(row, d_, g, _PERMUTE_TAG)
        for s_, d_ in perm:
            if d_ == me and s_ != me:
                _store_recv(out[0], s_, g, _PERMUTE_TAG, g.timeout)
    return out, CompletedWork(out, OpType.SEND)


def barrier(group=None, async_op: bool = False, device_ids=None):
    """torch `barrier` (`distributed_c10d.py:5284`)."""
    g = _resolve(group)
    _, work = g._dispatch("barrier", None, lambda: (None, g.backend_impl.barrier()),
                          async_op=async_op)
    return work if async_op else None


def monitored_barrier(group=None, timeout=None, wait_all_ranks: bool = False):
    """torch `monitored_barrier` (`distributed_c10d.py:5360`). In driver
    mode all ranks are this process, so arrival is trivially simultaneous;
    in multiproc mode this goes through the store with per-rank arrival keys
    so the failing rank is nameable."""
    g = _resolve(group)
    if _world.mode == "driver" or g.store is None:
        barrier(g)
        return
    tsec = _timeout_seconds(timeout) if timeout is not None else g.timeout
    me = g.rank()
    # Round key = per-group count of monitored_barrier calls, NOT the
    # backend sequence number: sequence counters advance independently per
    # process with interleaved other-collective traffic, so two ranks could
    # disagree on the key and deadlock spuriously. monitored_barrier is
    # itself collective — every rank calls it the same number of times in
    # the same order — so a dedicated counter is stable.
    g._mb_round = getattr(g, "_mb_round", 0) + 1
    rnd = g._mb_round
    g.store.set(f"mb/{rnd}/{me}", b"1")  # storelint: disable=S005 -- monitored-barrier arrival rows; rounds are bounded by barrier calls and die with the job store
    missing = []
    for r in range(g.size()):
        if r == me:
            continue  # own arrival is known; don't re-observe via the store
        key = f"mb/{rnd}/{r}"
        try:
            g.store.wait([key], tsec)
        except (DistError, OSError, TimeoutError):
            missing.append(r)
            if not wait_all_ranks:
                break
    if missing:
        raise RuntimeError(f"monitored_barrier: rank(s) {missing} failed to arrive")


def all_gather_into_tensor(tensor, group=None, async_op: bool = False):
    """torch `all_gather_into_tensor` (`distributed_c10d.py:4404`): like
    `all_gather` but the result is one concatenated tensor — per-rank value
    (W*n, *s) instead of the stacked (W, n, *s) list form."""
    g = _resolve(group)
    in_shape = _as_dist(tensor, g).shape  # per-rank INPUT shape, pre-gather
    res = all_gather(tensor, g, async_op=async_op)
    dt, work = res if async_op else (res, None)
    t = dt.tensor
    W = g.size()
    if in_shape == ():
        merged = t  # per-rank (W,): scalars concatenate to themselves
    else:
        merged = t.reshape((t.shape[0], W * in_shape[0]) + tuple(in_shape[1:]))
    out = DistTensor(merged, g)
    return (out, work) if async_op else out


def _normalize_splits(splits, W: int, name: str):
    """Accept one list (same for every rank) or a per-rank list of lists;
    return the (W, W) python matrix S with S[r][j] = elements rank r
    assigns to slot j."""
    if len(splits) == W and all(isinstance(s, (list, tuple)) for s in splits):
        mat = [list(map(int, row)) for row in splits]
    else:
        row = list(map(int, splits))
        if len(row) != W:
            raise ValueError(f"{name}: expected {W} split sizes, got {len(row)}")
        mat = [list(row) for _ in range(W)]
    for r, row in enumerate(mat):
        if len(row) != W or any(s < 0 for s in row):
            raise ValueError(f"{name}: rank {r} splits invalid: {row}")
    return mat


def _local_rows(g: ProcessGroup) -> List[int]:
    """The ranks whose rows this process holds: all in driver mode."""
    return list(range(g.size())) if _world.mode == "driver" else [g.rank()]


def _take_rows(t: torch.Tensor, idx: List[List[int]], mask: List[List[bool]]) -> torch.Tensor:
    """out[n, k] = t[n, idx[n][k]] where mask[n][k], else 0: gathers along
    dim 1 with index lists built on the host."""
    tail = tuple(t.shape[2:])
    i = torch.tensor(idx, dtype=torch.long, device=t.device)
    m = torch.tensor(mask, dtype=torch.bool, device=t.device)
    view = (i.shape[0], i.shape[1]) + (1,) * len(tail)
    if t.shape[1] == 0:  # nothing to take: every slot is masked
        return t.new_zeros((i.shape[0], i.shape[1]) + tail)
    out = torch.gather(t, 1, i.view(view).expand((i.shape[0], i.shape[1]) + tail))
    return torch.where(m.view(view), out, torch.zeros((), dtype=t.dtype, device=t.device))


def _ragged_all_to_all_single(dt: DistTensor, in_splits, out_splits, g):
    """Uneven all_to_all_single: pad chunks to the max size with index
    matrices computed on the host (splits are static), move them with the
    even all_to_all, compact with a gather — the reference's resolution of
    torch's input/output_split_sizes (`distributed_c10d.py:4996`)."""
    W = g.size()
    S = _normalize_splits(in_splits, W, "input_split_sizes")
    # implied output splits: O[r][i] = S[i][r]
    O = [[S[i][r] for i in range(W)] for r in range(W)]
    if out_splits is not None:
        O_given = _normalize_splits(out_splits, W, "output_split_sizes")
        if O_given != O:
            raise ValueError(
                f"output_split_sizes {O_given} inconsistent with "
                f"input_split_sizes (implied {O})"
            )
    for r in range(W):
        if sum(S[r]) != dt.shape[0]:
            raise ValueError(
                f"rank {r}: input_split_sizes sum {sum(S[r])} != "
                f"input length {dt.shape[0]}"
            )

    maxc = max(max(row) for row in S) or 1
    out_lens = [sum(O[r]) for r in range(W)]
    max_out = max(out_lens) or 1
    tail = tuple(dt.shape[1:])
    rows = _local_rows(g)

    # dispatch: chunk j of rank r starts at offset sum(S[r][:j]), padded to maxc
    disp_idx, disp_msk = [], []
    for r in rows:
        idx, msk, off = [0] * (W * maxc), [False] * (W * maxc), 0
        for j in range(W):
            for k in range(S[r][j]):
                idx[j * maxc + k], msk[j * maxc + k] = off + k, True
            off += S[r][j]
        disp_idx.append(idx)
        disp_msk.append(msk)
    padded = _take_rows(dt.tensor, disp_idx, disp_msk)
    padded = padded.reshape((len(rows), W, maxc) + tail)

    moved = all_to_all(DistTensor(padded, g), g)  # (n, W, maxc, *tail)
    flat = moved.tensor.reshape((len(rows), W * maxc) + tail)

    # compaction: rank r's received chunks, in source order, into max_out
    comp_idx, comp_msk = [], []
    for r in rows:
        idx, msk, t = [0] * max_out, [False] * max_out, 0
        for i in range(W):
            for k in range(O[r][i]):
                idx[t], msk[t] = i * maxc + k, True
                t += 1
        comp_idx.append(idx)
        comp_msk.append(msk)
    res = DistTensor(_take_rows(flat, comp_idx, comp_msk), g)
    res.split_sizes = out_lens  # rank r's valid prefix length
    return res


def all_to_all_single(
    tensor,
    output_split_sizes=None,
    input_split_sizes=None,
    group=None,
    async_op: bool = False,
):
    """torch `all_to_all_single` (`distributed_c10d.py:4996`): per-rank
    value is one (total, *s) tensor whose i-th chunk goes to rank i;
    output holds chunk i received from rank i.

    Equal splits (default): total must divide by world. Uneven splits:
    pass `input_split_sizes` (one list applied to every rank, or a
    per-rank list of lists) and optionally `output_split_sizes` to
    validate; the result is padded to the max output length per rank,
    with `result.split_sizes[r]` giving rank r's valid prefix."""
    g = _resolve(group)
    dt = _as_dist(tensor, g)
    W = g.size()
    if input_split_sizes is not None or output_split_sizes is not None:
        if input_split_sizes is None:
            raise ValueError("output_split_sizes requires input_split_sizes")
        res = _ragged_all_to_all_single(dt, input_split_sizes, output_split_sizes, g)
        if async_op:
            return res, CompletedWork(res, OpType.ALLTOALL)
        return res
    n_total = dt.shape[0]
    if n_total % W != 0:
        raise ValueError(f"all_to_all_single: leading dim {n_total} not divisible by world {W}")
    chunk = n_total // W
    t = dt.tensor  # (n, W*chunk, *s) rank-stacked
    split = t.reshape((t.shape[0], W, chunk) + tuple(t.shape[2:]))
    out = all_to_all(DistTensor(split, g), g)
    res = DistTensor(out.tensor.reshape(t.shape), g)
    if async_op:
        return res, CompletedWork(res, OpType.ALLTOALL)
    return res


def reduce_scatter_tensor(
    tensor,
    op: ReduceOp = ReduceOp.SUM,
    group=None,
    async_op: bool = False,
    split_sizes=None,
):
    """torch `reduce_scatter_tensor`: input per-rank value (W*n, *s) is
    treated as W chunks; each rank receives its reduced chunk (n, *s).

    `split_sizes` (list of W ints summing to the leading dim) enables the
    uneven form of torch's list-based `reduce_scatter`
    (`distributed_c10d.py:4790`): chunk r (length split_sizes[r]) is
    reduced to rank r. Chunks are padded to the max split;
    `result.split_sizes[r]` is rank r's valid prefix of the padded output."""
    g = _resolve(group)
    dt = _as_dist(tensor, g)
    W = g.size()
    if split_sizes is not None:
        splits = list(map(int, split_sizes))
        if len(splits) != W or any(s < 0 for s in splits):
            raise ValueError(f"split_sizes must be {W} non-negative ints")
        if sum(splits) != dt.shape[0]:
            raise ValueError(
                f"split_sizes sum {sum(splits)} != leading dim {dt.shape[0]}"
            )
        maxc = max(splits) or 1
        tail = tuple(dt.shape[1:])
        idx, msk, off = [0] * (W * maxc), [False] * (W * maxc), 0
        for r in range(W):
            for k in range(splits[r]):
                idx[r * maxc + k], msk[r * maxc + k] = off + k, True
            off += splits[r]
        n = dt.tensor.shape[0]
        padded = _take_rows(dt.tensor, [idx] * n, [msk] * n)
        padded = padded.reshape((n, W, maxc) + tail)
        res = reduce_scatter(DistTensor(padded, g), op, g, async_op=False)
        res.split_sizes = splits
        if async_op:
            return res, CompletedWork(res, OpType.REDUCE_SCATTER)
        return res
    if dt.shape[0] % W != 0:
        raise ValueError(f"reduce_scatter_tensor: leading dim {dt.shape[0]} not divisible by {W}")
    chunk = dt.shape[0] // W
    t = dt.tensor.reshape((dt.tensor.shape[0], W, chunk) + tuple(dt.tensor.shape[2:]))
    return reduce_scatter(DistTensor(t, g), op, g, async_op=async_op)


def split_group(
    parent_pg: Optional[ProcessGroup] = None,
    split_ranks: Optional[List[List[int]]] = None,
    timeout=None,
    group_desc: Optional[str] = None,
) -> Optional[ProcessGroup]:
    """torch `split_group` (`distributed_c10d.py:5517`): partition the
    parent group into disjoint subgroups. Returns the calling rank's
    subgroup."""
    parent = _resolve(parent_pg)
    if not split_ranks:
        raise ValueError("split_ranks must be a non-empty list of rank lists")
    seen: set = set()
    for rs in split_ranks:
        for r in rs:
            if r in seen:
                raise ValueError(f"rank {r} appears in more than one split")
            seen.add(r)
            if r not in parent.ranks:
                raise ValueError(f"rank {r} not in parent group {parent.ranks}")
    me = _world.process_rank  # global rank domain, same as split_ranks
    mine = first = None
    for idx, rs in enumerate(split_ranks):
        g = new_group(rs, timeout=timeout, group_desc=(
            f"{group_desc or 'split'}_{idx}"
        ))
        if first is None:
            first = g
        if me in rs:
            mine = g
    if mine is None and _world.mode == "driver":
        # the driver holds every rank; "its" subgroup defaults to the first
        mine = first
    return mine


def shrink_group(
    ranks_to_exclude: Sequence[int], group: Optional[ProcessGroup] = None, timeout=None
) -> ProcessGroup:
    """torch `shrink_group` (`distributed_c10d.py:6368`): rebuild the group
    without the excluded (e.g. failed) ranks. When the default group
    shrinks, the world is replaced in place."""
    g = _resolve(group)
    excl = set(int(r) for r in ranks_to_exclude)
    bad = excl - set(g.ranks)
    if bad:
        raise ValueError(f"ranks {sorted(bad)} not part of group {g.ranks}")
    keep = [r for r in g.ranks if r not in excl]
    if not keep:
        raise ValueError("cannot shrink a group to zero ranks")
    is_default = g is _world.default_pg
    ng = new_group(keep, timeout=timeout, group_desc=f"{g.group_name}_shrunk")
    if is_default:
        _world.default_pg = ng
        GroupMember.WORLD = ng
    return ng


def gather_object(obj: Any, object_gather_list: Optional[List[Any]] = None, dst: int = 0, group=None):
    """torch `gather_object` with dst semantics: only dst's
    `object_gather_list` is filled; other ranks get None back. Driver mode
    gathers every rank's object (the per-rank objects come from `obj` when
    it is a per-rank list) — the driver acts for dst. Multiproc mode rides
    all_gather (each rank briefly holds all objects; object payloads are
    control-plane sized)."""
    g = _resolve(group)
    W = g.size()
    g._check_member(dst)
    if _world.mode == "multiproc":
        if g.rank() == dst and object_gather_list is None:
            raise ValueError(
                "gather_object: dst rank must pass object_gather_list"
            )
        gathered = all_gather_object(obj, g)
        if g.rank() != dst:
            return None
        del object_gather_list[:]
        object_gather_list.extend(gathered)
        return gathered
    if not (isinstance(obj, list) and len(obj) == W):
        raise ValueError(
            f"driver mode: gather_object takes the per-rank object list "
            f"(length {W}), like all_gather_object"
        )
    gathered = all_gather_object(obj, g)
    if object_gather_list is not None:
        del object_gather_list[:]
        object_gather_list.extend(gathered)
    return gathered


def get_group_rank(group: ProcessGroup, global_rank: int) -> int:
    """torch module-level `get_group_rank`."""
    return _resolve(group).get_group_rank(global_rank)


def get_global_rank(group: ProcessGroup, group_rank: int) -> int:
    """torch module-level `get_global_rank`."""
    return _resolve(group).get_global_rank(group_rank)


class _CoalescingManager:
    """torch `_coalescing_manager` analog: batch async works; wait at exit.

    Each collective is already an asynchronous enqueue on the device's
    stream, so the manager's contract reduces to collecting the works and
    waiting once. Works are collected AUTOMATICALLY: any collective
    dispatched on the manager's group while the context is active
    registers its Work here, so `cm.wait()` is a real completion barrier
    even when the caller discards the per-op returns."""

    def __init__(self, group: ProcessGroup):
        self.group = group
        self.works: List[Work] = []

    def append(self, work: Work) -> None:
        self.works.append(work)

    def wait(self) -> None:
        for w in self.works:
            w.wait()
        self.works = []


_active_cms = _threading.local()


def _register_with_active_cm(group: ProcessGroup, work: Work) -> None:
    stack = getattr(_active_cms, "stack", None)
    if stack:
        cm = stack[-1]
        if cm.group is group and work is not None:
            cm.append(work)


@_contextmanager
def coalescing_manager(group=None, async_ops: bool = False):
    """Batch a series of collectives and wait for them together (torch
    `_coalescing_manager`, `distributed_c10d.py` coalescing context)."""
    g = _resolve(group)
    cm = _CoalescingManager(g)
    stack = getattr(_active_cms, "stack", None)
    if stack is None:
        stack = _active_cms.stack = []
    stack.append(cm)
    try:
        yield cm
    finally:
        stack.pop()
        # wait even on the error path so completion callbacks (flight
        # recorder / status) fire and nothing reads as forever-enqueued
        if not async_ops:
            cm.wait()


# ---------------------------------------------------------------------------
# point-to-point
# ---------------------------------------------------------------------------


@dataclass
class P2POp:
    """torch `P2POp` (`distributed_c10d.py:2875`): one half of a p2p pair.

    `op` is `isend` or `irecv`; `peer` is the other rank. In driver mode
    the acting rank must be given explicitly via `rank` (the driver holds
    all ranks, so "self" is ambiguous).
    """

    op: Any
    tensor: Any
    peer: int
    group: Optional[ProcessGroup] = None
    tag: int = 0
    rank: Optional[int] = None


def _is_send(op) -> bool:
    return getattr(op, "__name__", str(op)) in ("isend", "send")


def _p2p_key(gen, src: int, dst: int, tag: int, seq: int) -> str:
    # gen disambiguates init/destroy incarnations (and agent restart
    # generations): subgroup PrefixStore names ("group_N") reset with
    # _world, so without it an unconsumed send from a dead incarnation
    # would be delivered to the next one.
    return f"p2p/g{gen}/{src}->{dst}/t{tag}/{seq}"


def _p2p_counters(g: ProcessGroup, which: str) -> Dict:
    """Per-GROUP sequence counters: a global counter would desynchronize
    sender and receiver as soon as two groups carry p2p traffic."""
    attr = f"_p2p_{which}_seq"
    ctr = getattr(g, attr, None)
    if ctr is None:
        ctr = {}
        setattr(g, attr, ctr)
    return ctr


# Large store-path payloads are split into bounded chunks streamed through
# the daemon; the manifest key is written FIRST so the receiver drains
# chunk i while the sender is still writing chunk i+1.
_P2P_CHUNK_MAGIC = b"TDXCHUNKS:"


def _p2p_chunk_bytes() -> int:
    return int(os.environ.get("TDX_P2P_CHUNK_BYTES", str(4 << 20)))


# Direct data plane (p2p.py). Routing is deterministic per incarnation:
# a sender uses the plane iff the DESTINATION published a listener; a
# receiver drains its own inbox iff ITS listener is up — the same
# condition from both ends, so a message never has two possible paths.
_p2p_plane = None


def _route_key(g: ProcessGroup) -> str:
    # group+incarnation scope, mirroring the store path's PrefixStore
    # nesting: same (tag, seq) on two groups must not collide.
    return f"{_world.scope}/{g.group_name}"


def _plane_send_target(g: ProcessGroup, dst_group_rank: int, timeout: float):
    """(plane, dst_global) when the plane carries this send, else None.

    A message takes the store path ONLY when dst published a "none"
    endpoint (its listener is down), which is exactly when dst drains the
    store. A failed endpoint LOOKUP therefore propagates: silently
    diverting one message to the store would strand it."""
    if _p2p_plane is None:
        return None
    dst_global = g.get_global_rank(dst_group_rank)
    ep = _p2p_plane.endpoint_of(dst_global, timeout)
    return (_p2p_plane, dst_global) if ep is not None else None


def _plane_recv_active() -> bool:
    return _p2p_plane is not None and _p2p_plane.listening


def _p2p_payload(tensor) -> torch.Tensor:
    """This process's tensor for a multiproc send: a DistTensor's row, a
    tensor, or an array."""
    if isinstance(tensor, DistTensor):
        return tensor.tensor[0]
    if isinstance(tensor, torch.Tensor):
        return tensor
    return torch.as_tensor(np.asarray(tensor))


def _land(tensor, val: torch.Tensor) -> torch.Tensor:
    """The torch in-place receive contract: a tensor is filled, a
    DistTensor gets the value as its row (on its device)."""
    if isinstance(tensor, DistTensor):
        row = tensor.tensor[0]
        tensor._set(val.to(device=row.device, dtype=row.dtype).reshape(row.shape)[None])
    elif isinstance(tensor, torch.Tensor):
        tensor.copy_(val.reshape(tensor.shape))
    return val


def _store_send(tensor, dst: int, g: ProcessGroup, tag: int) -> None:
    """Multiproc send of this process's tensor to group rank dst, under a
    generation- and group-scoped per-(dst, tag) sequence number: through
    the p2p plane when dst listens, else through the store."""
    from . import p2p as _p2p_mod

    ctr = _p2p_counters(g, "send")
    seq = ctr.get((dst, tag), 0)
    ctr[(dst, tag)] = seq + 1
    val = _p2p_payload(tensor)
    target = _plane_send_target(g, dst, g.timeout)
    if target is not None:
        plane, dst_global = target
        plane.send(dst_global, _route_key(g), tag, seq, val, g.timeout)
        return
    kind, dtype, shape, buf = _p2p_mod.encode(val)
    payload = pickle.dumps((kind, dtype, tuple(shape), bytes(buf)))
    key = _p2p_key(_world.scope, g.rank(), dst, tag, seq)
    chunk = _p2p_chunk_bytes()
    if len(payload) <= chunk:
        g.store.set(key, payload)
        return
    n = (len(payload) + chunk - 1) // chunk
    # manifest first: the receiver starts draining immediately
    g.store.set(key, _P2P_CHUNK_MAGIC + pickle.dumps((n, len(payload))))
    for i in range(n):
        g.store.set(f"{key}/c{i}", payload[i * chunk : (i + 1) * chunk])


def _store_recv(tensor, src: int, g: ProcessGroup, tag: int, timeout: float):
    from . import p2p as _p2p_mod

    ctr = _p2p_counters(g, "recv")
    seq = ctr.get((src, tag), 0)
    ctr[(src, tag)] = seq + 1
    if _plane_recv_active():
        # my listener is up, so every peer routed this message through it
        val = _p2p_plane.recv(g.get_global_rank(src), _route_key(g), tag, seq, timeout)
        return _land(tensor, val)
    key = _p2p_key(_world.scope, src, g.rank(), tag, seq)
    g.store.wait([key], timeout)
    head = g.store.get(key)
    if head.startswith(_P2P_CHUNK_MAGIC):
        n, total = pickle.loads(head[len(_P2P_CHUNK_MAGIC):])
        parts = []
        for i in range(n):  # chunks stream in-order behind the manifest
            ck = f"{key}/c{i}"
            g.store.wait([ck], timeout)
            parts.append(g.store.get(ck))
            try:
                g.store.delete_key(ck)
            except (DistError, OSError):
                pass  # best-effort GC: a failed delete only leaks a consumed key
        head = b"".join(parts)
        assert len(head) == total, (len(head), total)
    kind, dtype, shape, buf = pickle.loads(head)
    try:
        g.store.delete_key(key)
    except (DistError, OSError):
        pass  # best-effort GC: a failed delete only leaks a consumed key
    return _land(tensor, _p2p_mod.decode(kind, dtype, shape, bytearray(buf)))


def _store_recv_any(tensor, g: ProcessGroup, tag: int, timeout: float):
    """Any-source receive (torch `recv(src=None)`): the first message
    from any peer at its next expected sequence number. Returns (src,
    value)."""
    me = g.rank()
    ctr = _p2p_counters(g, "recv")
    peers = [r for r in range(g.size()) if r != me]
    if _plane_recv_active():
        cands = [(g.get_global_rank(r), ctr.get((r, tag), 0)) for r in peers]
        src_global, val = _p2p_plane.recv_any(
            cands, _route_key(g), tag, timeout if timeout is not None else 3600.0)
        src = g.get_group_rank(src_global)
        ctr[(src, tag)] = ctr.get((src, tag), 0) + 1
        return src, _land(tensor, val)
    budget = timeout if timeout is not None else 3600.0
    deadline = time.monotonic() + budget
    poll = 0.002
    while True:
        for src in peers:
            key = _p2p_key(_world.scope, src, me, tag, ctr.get((src, tag), 0))
            if g.store.check([key]):
                return src, _store_recv(tensor, src, g, tag, timeout)
        if time.monotonic() >= deadline:
            raise TimeoutError(f"recv(src=None): no sender within {budget}s (tag={tag})")
        # exponential backoff to 50 ms: a long any-source wait must not
        # hammer the single-threaded daemon with W RPCs every 2 ms
        time.sleep(poll)
        poll = min(poll * 2, 0.05)


class _StoreRecvWork(Work):
    """Deferred multiproc receive: `wait()` performs the blocking read.
    `src=None` resolves any-source at wait time; `source_rank()` then
    reports who sent (torch `Work._source_rank`)."""

    def __init__(self, tensor, src: Optional[int], g: ProcessGroup, tag: int):
        super().__init__(OpType.RECV, "p2p:recv")
        self._args = (tensor, src, g, tag)
        self._done = False
        self._src = src
        self.value = None

    def is_completed(self) -> bool:
        return self._done

    def wait(self, timeout: Optional[float] = None) -> bool:
        if not self._done:
            t, src, g, tag = self._args
            if src is None:
                self._src, self.value = _store_recv_any(t, g, tag, timeout or g.timeout)
            else:
                self.value = _store_recv(t, src, g, tag, timeout or g.timeout)
            self._done = True
        return True

    def source_rank(self) -> Optional[int]:
        return self._src

    def result(self):
        self.wait()
        return self._args[0]


def batch_isend_irecv(p2p_op_list: List[P2POp]) -> List[Work]:
    """torch `batch_isend_irecv` (`distributed_c10d.py:2990`). Driver mode:
    pair up the sends/recvs and run them as ONE permute over the rank dim.
    Multiproc mode: each op goes through the p2p plane (sends at once,
    receives deferred to `wait()`), like isend/irecv."""
    if not p2p_op_list:
        return []
    g = _resolve(p2p_op_list[0].group)
    if _world.mode == "multiproc":
        works: List[Work] = []
        for p in p2p_op_list:
            pg = _resolve(p.group)
            _check_user_tag(p.tag)
            if _is_send(p.op):
                _store_send(p.tensor, p.peer, pg, p.tag)
                works.append(CompletedWork(p.tensor, OpType.SEND))
            else:
                works.append(_StoreRecvWork(p.tensor, p.peer, pg, p.tag))
        return works
    sends: Dict[Tuple[int, int, int], P2POp] = {}
    recvs: Dict[Tuple[int, int, int], P2POp] = {}
    for p in p2p_op_list:
        if p.rank is None:
            raise ValueError("driver mode: P2POp.rank (acting rank) is required")
        if _is_send(p.op):
            sends[(p.rank, p.peer, p.tag)] = p
        else:
            recvs[(p.peer, p.rank, p.tag)] = p

    for key in sends:
        if key not in recvs:
            raise RuntimeError(f"unmatched isend {key}; driver mode requires paired ops")
    if len(recvs) != len(sends):
        raise RuntimeError("unmatched irecv in batch")

    # all ops on one DistTensor are one permute; heterogeneous tensors:
    # one permute per tensor object
    works: List[Work] = []
    by_tensor: Dict[int, List[Tuple[Tuple[int, int], P2POp, P2POp]]] = {}
    for key, s in sends.items():
        r = recvs[key]
        by_tensor.setdefault(id(s.tensor), []).append(((key[0], key[1]), s, r))
    for _, entries in by_tensor.items():
        perm = [p for p, _, _ in entries]
        src_dt = entries[0][1].tensor
        out, work = g._dispatch(
            "batch_isend_irecv",
            src_dt.tensor,
            lambda src_dt=src_dt, perm=perm: g.backend_impl.permute(src_dt.tensor, perm),
            detail=f"perm={perm}",
        )
        for _, s, r in entries:
            r.tensor._set(out)
        works.append(work)
    return works


def _check_user_tag(tag: int) -> None:
    # torch/NCCL contract: user tags are non-negative; negatives are this
    # runtime's reserved internal channels (e.g. object-list p2p)
    if tag < 0:
        raise ValueError(f"p2p tag must be >= 0 (got {tag}); negative "
                         "tags are reserved for internal channels")


def send(tensor, dst: int, group=None, tag: int = 0, *, src: Optional[int] = None):
    """torch `send` (`distributed_c10d.py:2598`).

    Multiproc mode: the calling process's tensor goes to dst through the
    p2p plane (the store path toward an opted-out rank). Driver mode: all
    ranks live here, so a send is half of a permute pair and needs the
    acting rank via `src=`."""
    _check_user_tag(tag)
    g = _resolve(group)
    if _world.mode == "multiproc":
        _store_send(tensor, dst, g, tag)
        return None
    if src is None:
        raise ValueError("driver mode: send(...) needs src= (acting rank)")
    dt = _as_dist(tensor, g)
    out, work = g._dispatch(  # distlint: disable=R006 -- the permute Work drains through `out`'s data dependency in dt._set; the paired recv is the blocking side
        "send",
        dt.tensor,
        lambda: g.backend_impl.permute(dt.tensor, [(src, dst)]),
        detail=f"{src}->{dst}",
        async_op=False,
    )
    dt._set(out)
    return None


def recv(tensor, src: Optional[int] = None, group=None, tag: int = 0, *, dst: Optional[int] = None) -> int:
    """torch `recv` (`distributed_c10d.py:2682`).

    Multiproc mode: blocking receive from the p2p plane (or the store
    path); a tensor is filled IN PLACE (torch contract), a DistTensor gets
    the received row; returns the sender's rank (any sender when src is
    None).
    Driver mode: the matching send already routed data into the
    rank-stacked tensor (send+recv are one permute), so this is a no-op
    returning src."""
    _check_user_tag(tag)
    g = _resolve(group)
    if _world.mode == "multiproc":
        if src is None:
            return _store_recv_any(tensor, g, tag, g.timeout)[0]
        _store_recv(tensor, src, g, tag, g.timeout)
        return src
    return src if src is not None else -1


def isend(tensor, dst: int, group=None, tag: int = 0, *, src: Optional[int] = None) -> Work:
    _check_user_tag(tag)
    g = _resolve(group)
    if _world.mode == "multiproc":
        _store_send(tensor, dst, g, tag)  # the plane's send returns once written
        return CompletedWork(tensor, OpType.SEND)
    if src is None:
        raise ValueError("driver mode: isend(...) needs src= (acting rank)")
    dt = _as_dist(tensor, g)
    out, work = g._dispatch(
        "isend",
        dt.tensor,
        lambda: g.backend_impl.permute(dt.tensor, [(src, dst)]),
        detail=f"{src}->{dst}",
    )
    dt._set(out)
    return work


def irecv(tensor, src: Optional[int] = None, group=None, tag: int = 0, *, dst: Optional[int] = None) -> Work:
    _check_user_tag(tag)
    g = _resolve(group)
    if _world.mode == "multiproc":
        return _StoreRecvWork(tensor, src, g, tag)
    return CompletedWork(tensor, OpType.RECV)


# ---------------------------------------------------------------------------
# object collectives — torch `distributed_c10d.py:3439,3925,4057`
# ---------------------------------------------------------------------------


def _verify_object_count_across_ranks(op: str, count: int, g: ProcessGroup) -> None:
    """Agree on an object count before any count-shaped collective runs.

    Store-based arrival keys (the `monitored_barrier` idiom — safe for
    the same reason: object collectives are themselves collective, so a
    per-group round counter agrees across ranks): every rank publishes
    its count and reads everyone's, so on mismatch EVERY rank — src
    included — raises the same ValueError naming the per-rank counts,
    instead of one rank erroring while its peers wedge inside the next
    collective."""
    if g.store is None:
        return
    g._objcnt_round = getattr(g, "_objcnt_round", 0) + 1
    rnd = g._objcnt_round
    me = g.rank()
    g.store.set(f"objcnt/{rnd}/{me}", str(int(count)).encode())
    keys = [f"objcnt/{rnd}/{r}" for r in range(g.size())]
    g.store.wait(keys, g.timeout)
    counts = {
        r: int(g.store.get(f"objcnt/{rnd}/{r}").decode()) for r in range(g.size())
    }
    if rnd > 1:
        # every rank has passed round rnd-1 (it reached rnd), so its keys
        # are dead; best-effort GC bounds store growth
        try:
            g.store.delete_key(f"objcnt/{rnd - 1}/{me}")
        except (DistError, OSError):
            pass
    if len(set(counts.values())) > 1:
        raise ValueError(
            f"{op}: object counts differ across ranks: "
            f"{dict(sorted(counts.items()))}; this rank holds {count}. "
            "Every rank must pass the same number of objects."
        )


def _obj_to_array(obj) -> np.ndarray:
    return np.frombuffer(pickle.dumps(obj), dtype=np.uint8).copy()


def _array_to_obj(arr: np.ndarray, length: int):
    return pickle.loads(arr[:length].tobytes())


def all_gather_object(objects: Sequence[Any], group=None) -> List[Any]:
    """torch `all_gather_object` (`:3439`). Driver mode: `objects[r]` is
    rank r's object; returns the gathered list (what every rank would see).
    Multiproc mode (torch-true signature): `objects` is THIS process's
    single object. Both exercise the real tensor path: pickle → uint8
    DistTensor → length all_gather → padded all_gather → unpickle."""
    g = _resolve(group)
    W = g.size()
    if _world.mode == "multiproc":
        buf = _obj_to_array(objects)
        lt = DistTensor.from_process_local(np.array([len(buf)], np.int64), g)
        lens_dt = all_gather(lt, g)  # per-rank value (W, 1)
        lens = lens_dt.local_numpy()[0][:, 0].astype(int)
        max_len = max(int(n) for n in lens) or 1
        padded = np.zeros((max_len,), np.uint8)
        padded[: len(buf)] = buf
        dt = DistTensor.from_process_local(padded, g)
        gathered = all_gather(dt, g)  # per-rank value (W, max_len)
        flat = gathered.local_numpy()[0]
        return [_array_to_obj(flat[i], int(lens[i])) for i in range(W)]
    if len(objects) != W:
        raise ValueError(f"need one object per rank ({W}), got {len(objects)}")
    bufs = [_obj_to_array(o) for o in objects]
    lens = np.array([len(b) for b in bufs], dtype=np.int64)
    # max length via all_reduce(MAX) over a per-rank length tensor
    lt = DistTensor.from_stacked(lens[:, None], g)
    all_reduce(lt, ReduceOp.MAX, g)
    max_len = int(lt.numpy()[0, 0])
    padded = np.zeros((W, max_len), dtype=np.uint8)
    for i, b in enumerate(bufs):
        padded[i, : len(b)] = b
    dt = DistTensor.from_stacked(padded, g)
    gathered = all_gather(dt, g)  # per-rank (W, max_len)
    flat = gathered.numpy()[0]  # all ranks identical
    return [_array_to_obj(flat[i], int(lens[i])) for i in range(W)]


def broadcast_object_list(object_list: List[Any], src: int = 0, group=None) -> None:
    """torch `broadcast_object_list` (`:3925`). Driver mode: `object_list`
    is the per-rank slot list; after the call every slot holds src's
    object (routed through a real broadcast collective). Multiproc mode
    (torch-true): a list of k objects per process, replaced in place with
    src's contents."""
    g = _resolve(group)
    W = g.size()
    if _world.mode == "multiproc":
        k = len(object_list)
        # every rank — src included — raises the same diagnostic on
        # mismatched counts, so no rank proceeds into a collective its
        # peers abandoned
        _verify_object_count_across_ranks("broadcast_object_list", k, g)
        # torch ignores non-src contents pre-call; don't even pickle them
        if g.rank() == src:
            lens = np.array([len(_obj_to_array(o)) for o in object_list], np.int64)
        else:
            lens = np.zeros((k,), np.int64)
        lt = DistTensor.from_process_local(lens, g)
        broadcast(lt, src, g)
        # post-broadcast, src_lens is identical everywhere — it IS the
        # agreed padded size
        src_lens = lt.local_numpy()[0].astype(int)
        max_len = int(max([*src_lens.tolist(), 1]))
        padded = np.zeros((k, max_len), np.uint8)
        if g.rank() == src:
            for i, o in enumerate(object_list):
                b = _obj_to_array(o)
                padded[i, : len(b)] = b
        dt = DistTensor.from_process_local(padded, g)
        broadcast(dt, src, g)
        out = dt.local_numpy()[0]
        for i in range(k):
            object_list[i] = _array_to_obj(out[i], int(src_lens[i]))
        return
    if len(object_list) != W:
        raise ValueError(f"need one slot per rank ({W}), got {len(object_list)}")
    bufs = [_obj_to_array(o) for o in object_list]
    max_len = max(len(b) for b in bufs)
    lens = np.array([len(b) for b in bufs], dtype=np.int64)
    lt = DistTensor.from_stacked(lens[:, None], g)
    broadcast(lt, src, g)
    src_len = int(lt.numpy()[0, 0])
    padded = np.zeros((W, max(max_len, 1)), dtype=np.uint8)
    for i, b in enumerate(bufs):
        padded[i, : len(b)] = b
    dt = DistTensor.from_stacked(padded, g)
    broadcast(dt, src, g)
    out = dt.numpy()
    for i in range(W):
        object_list[i] = _array_to_obj(out[i], src_len)


def scatter_object_list(
    scatter_object_output_list: List[Any],
    scatter_object_input_list: Optional[List[Any]] = None,
    src: int = 0,
    group=None,
) -> None:
    """torch `scatter_object_list` (`:4057`). Driver mode:
    `scatter_object_input_list` is src's list of W objects; output list gets
    one object per rank. Multiproc mode (torch-true): only src needs the
    input list; each process's output list receives its one object."""
    g = _resolve(group)
    W = g.size()
    if _world.mode == "multiproc":
        me = g.rank()
        if me == src:
            if scatter_object_input_list is None or len(scatter_object_input_list) != W:
                raise ValueError(f"src must provide {W} objects")
            objs = list(scatter_object_input_list)
        else:
            objs = [None] * W
        # route over broadcast (src's payloads, one slot per rank), then
        # keep own slot — object payloads are control-plane sized
        broadcast_object_list(objs, src, g)
        del scatter_object_output_list[:]
        scatter_object_output_list.append(objs[me])
        return
    if scatter_object_input_list is None or len(scatter_object_input_list) != W:
        raise ValueError(f"src must provide {W} objects")
    bufs = [_obj_to_array(o) for o in scatter_object_input_list]
    max_len = max(len(b) for b in bufs)
    chunk = np.zeros((W, W, max_len + 8), dtype=np.uint8)
    for i, b in enumerate(bufs):
        chunk[src, i, :8] = np.frombuffer(
            np.int64(len(b)).tobytes(), dtype=np.uint8
        )
        chunk[src, i, 8 : 8 + len(b)] = b
    dt = DistTensor.from_stacked(chunk, g)
    res = scatter(dt, src, g)
    out = res.numpy().reshape(W, -1)
    del scatter_object_output_list[:]
    for i in range(W):
        ln = int(np.frombuffer(out[i, :8].tobytes(), dtype=np.int64)[0])
        scatter_object_output_list.append(_array_to_obj(out[i, 8:], ln))


# ---------------------------------------------------------------------------
# object p2p — torch `distributed_c10d.py:3250,3339`
# ---------------------------------------------------------------------------

# The internal object-list channel's tag on the wire. Public p2p enforces
# tag >= 0 (the torch/NCCL contract); this one is far above any user tag.
_OBJ_P2P_TAG = (1 << 30) - 7


def send_object_list(object_list: List[Any], dst: int, group=None, device=None):
    """torch `send_object_list` (`:3250`): pickle each object and send the
    count, the lengths, then the payload to dst through the p2p plane.
    Driver mode raises — all ranks live in one process there; use the
    object collectives (`broadcast_object_list` / `gather_object`)
    instead."""
    g = _resolve(group)
    if _world.mode != "multiproc":
        raise RuntimeError(
            "send_object_list is per-process (multiproc mode); driver "
            "mode holds every rank — use broadcast_object_list/"
            "gather_object"
        )
    bufs = [_obj_to_array(o) for o in object_list]
    payload = np.concatenate(bufs) if bufs else np.zeros((0,), np.uint8)
    for part in (np.array([len(bufs)], np.int64),
                 np.array([len(b) for b in bufs], np.int64), payload):
        if part.size:
            _store_send(part, dst, g, _OBJ_P2P_TAG)


def recv_object_list(
    object_list: List[Any], src: Optional[int] = None, group=None, device=None
) -> int:
    """torch `recv_object_list` (`:3339`): receive into object_list IN
    PLACE (its length bounds how many objects are taken); returns the
    source rank. src=None accepts from any sender."""
    g = _resolve(group)
    if _world.mode != "multiproc":
        raise RuntimeError(
            "recv_object_list is per-process (multiproc mode); driver "
            "mode holds every rank — use broadcast_object_list/"
            "gather_object"
        )
    count = torch.empty(1, dtype=torch.int64)
    if src is None:
        src = _store_recv_any(count, g, _OBJ_P2P_TAG, g.timeout)[0]
    else:
        _store_recv(count, src, g, _OBJ_P2P_TAG, g.timeout)
    n = int(count[0])
    lens = torch.empty(n, dtype=torch.int64)
    if n:
        _store_recv(lens, src, g, _OBJ_P2P_TAG, g.timeout)
    payload = torch.empty(int(lens.sum()), dtype=torch.uint8)
    if payload.numel():
        _store_recv(payload, src, g, _OBJ_P2P_TAG, g.timeout)
    data = payload.numpy()
    objs, off = [], 0
    for ln in lens.tolist():
        objs.append(_array_to_obj(data[off : off + ln], ln))
        off += ln
    for i in range(min(len(object_list), len(objs))):
        object_list[i] = objs[i]
    return src


# ---------------------------------------------------------------------------
# coalesced convenience collectives — torch `all_reduce_coalesced` /
# `all_gather_coalesced` (legacy API kept for ported scripts — the
# coalescing_manager is the modern spelling)
# ---------------------------------------------------------------------------


def all_reduce_coalesced(tensors, op: ReduceOp = ReduceOp.SUM, group=None,
                         async_op: bool = False):
    """One wait covers every tensor (torch semantic); dispatches ride the
    coalescing manager so the ops queue back-to-back."""
    g = _resolve(group)
    with coalescing_manager(g, async_ops=True) as cm:
        for t in tensors:
            all_reduce(t, op, g, async_op=True)
    if async_op:
        return cm
    cm.wait()
    return None


def all_gather_coalesced(output_tensor_lists, input_tensor_list, group=None,
                         async_op: bool = False):
    """Legacy torch API: gather each input; output_tensor_lists[i] is
    filled with the W per-rank pieces of input i (numpy arrays or
    tensors, in place)."""
    g = _resolve(group)
    for i, t in enumerate(input_tensor_list):
        res = all_gather(t, g)
        gathered = res.tensor[0]
        out = output_tensor_lists[i]
        for r in range(g.size()):
            if isinstance(out[r], torch.Tensor):
                out[r].copy_(gathered[r])
            else:
                out[r][...] = DistTensor(gathered[r][None], g).local_numpy()[0]
    if async_op:
        return CompletedWork(None, OpType.ALLGATHER)
    return None


def new_subgroups_by_enumeration(
    ranks_per_subgroup_list, timeout=None, backend: Optional[str] = None
):
    """torch `new_subgroups_by_enumeration` (`distributed_c10d.py:6210`):
    explicit rank lists -> (this rank's subgroup, all subgroups)."""
    seen: set = set()
    for rs in ranks_per_subgroup_list:
        for r in rs:
            if r in seen:
                raise ValueError(f"rank {r} appears in more than one subgroup")
            seen.add(r)
    me = _world.process_rank
    cur = None
    groups = []
    for rs in ranks_per_subgroup_list:
        gp = new_group(rs, timeout=timeout, backend=backend)
        groups.append(gp)
        if me in rs:
            cur = gp
    if cur is None and _world.mode != "multiproc":
        # driver process acts for every rank; mirror new_subgroups'
        # convention of "its" subgroup being the first
        cur = groups[0]
    # multiproc rank covered by no subgroup: cur stays None (torch
    # returns None so ported code can gate collectives on membership)
    return cur, groups


# ---------------------------------------------------------------------------
# environment probes + debug level — torch `torch.distributed` module surface
# ---------------------------------------------------------------------------


def is_available() -> bool:
    """torch `is_available` — this build always ships the c10d surface."""
    return True


def is_backend_available(backend: str) -> bool:
    return _backends.backend_registered(backend or "")


def is_nccl_available() -> bool:
    return tdist.is_nccl_available()


def is_gloo_available() -> bool:
    return tdist.is_gloo_available()


def is_mpi_available() -> bool:
    return False


def is_ucc_available() -> bool:
    return False


def is_torchelastic_launched() -> bool:
    """torch checks TORCHELASTIC_RUN_ID (`distributed_c10d.py`); the
    reference's agent exports it (plus the TDX_* contract) for this probe."""
    return bool(
        os.environ.get("TORCHELASTIC_RUN_ID")
        or os.environ.get("TDX_AGENT_STORE")
    )


def get_node_local_rank(fallback_rank: Optional[int] = None) -> int:
    """torch `get_node_local_rank`: LOCAL_RANK env, else the fallback."""
    v = os.environ.get("LOCAL_RANK")
    if v is not None:
        return int(v)
    if fallback_rank is not None:
        return int(fallback_rank)
    raise RuntimeError(
        "LOCAL_RANK is not set and no fallback_rank was provided"
    )


def get_pg_count() -> int:
    return len(_world.pg_map)


class DebugLevel(enum.IntEnum):
    """torch `DebugLevel` (`distributed_c10d.py` / TORCH_DISTRIBUTED_DEBUG)."""

    OFF = 0
    INFO = 1
    DETAIL = 2


_debug_level: Optional[DebugLevel] = None


def set_debug_level(level: DebugLevel) -> None:
    global _debug_level
    _debug_level = DebugLevel(level)


def set_debug_level_from_env() -> None:
    global _debug_level
    name = os.environ.get("TORCH_DISTRIBUTED_DEBUG", "OFF").upper()
    _debug_level = DebugLevel[name] if name in DebugLevel.__members__ else DebugLevel.OFF


def get_debug_level() -> DebugLevel:
    if _debug_level is None:
        set_debug_level_from_env()
    return _debug_level


# deprecated alias torch still exposes
reduce_op = ReduceOp
