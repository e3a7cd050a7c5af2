"""Rendezvous: URL → (store, rank, world_size).

Parity surface: torch `torch/distributed/rendezvous.py` (SURVEY.md §1-L2) —
`rendezvous(url, rank, world_size)` generator returning
`(store, rank, world_size)`, with handlers for `tcp://` (`:212`), `env://`
(`:244`) and `file://` (`:127`), query-string overrides
(`tcp://host:port?rank=0&world_size=2`, parsing `:57-101`), env vars RANK /
WORLD_SIZE / MASTER_ADDR / MASTER_PORT (`:258-274`), and rank 0 hosting the
TCP store daemon (`start_daemon = rank == 0`, `:196-205`).
"""

from __future__ import annotations

import os
from typing import Callable, Dict, Iterator, Optional, Tuple
from urllib.parse import urlparse, parse_qs

from . import faults
from .store import DEFAULT_PORT, FileStore, Store, TCPStore
from .utils.retry import call_with_retry

_handlers: Dict[str, Callable] = {}


def _join_store(make, rank: int, url_desc: str, timeout: float) -> Store:
    """Construct the rendezvous store behind the shared retry policy.

    The `rendezvous.join` fault point fires per attempt (rank-aware), so
    a plan like {"point": "rendezvous.join", "rank": 1, "action":
    "reset", "times": 2} exercises two transient join failures that the
    backoff absorbs, while action "drop"/"error" models a join that
    fails this worker outright (the elastic agent's restart business)."""

    def attempt():
        faults.fire("rendezvous.join", rank=rank, url=url_desc)
        return make()

    return call_with_retry(
        attempt, desc=f"rendezvous {url_desc}", timeout=timeout
    )


class RendezvousError(RuntimeError):
    pass


def register_rendezvous_handler(scheme: str, handler: Callable) -> None:
    if scheme in _handlers:
        raise RendezvousError(f"rendezvous handler {scheme}:// already registered")
    _handlers[scheme] = handler


def rendezvous(url: str, rank: int = -1, world_size: int = -1, **kwargs) -> Iterator[Tuple[Store, int, int]]:
    parsed = urlparse(url)
    handler = _handlers.get(parsed.scheme)
    if handler is None:
        raise RendezvousError(f"no rendezvous handler for {parsed.scheme}://")
    return handler(url, rank, world_size, **kwargs)


def _query_overrides(url: str, rank: int, world_size: int) -> Tuple[int, int]:
    q = parse_qs(urlparse(url).query)
    if "rank" in q:
        rank = int(q["rank"][0])
    if "world_size" in q:
        world_size = int(q["world_size"][0])
    return rank, world_size


def _tcp_handler(url: str, rank: int, world_size: int, timeout: float = 300.0, **kw):
    parsed = urlparse(url)
    rank, world_size = _query_overrides(url, rank, world_size)
    if rank < 0 or world_size < 1:
        raise RendezvousError("tcp:// rendezvous needs valid rank and world_size")
    host = parsed.hostname or "127.0.0.1"
    port = parsed.port or DEFAULT_PORT
    store = _join_store(
        lambda: TCPStore(
            host, port, world_size, is_master=(rank == 0), timeout=timeout
        ),
        rank, f"tcp://{host}:{port}", timeout,
    )
    yield (store, rank, world_size)


def _env_handler(url: str, rank: int, world_size: int, timeout: float = 300.0, **kw):
    rank_, world_ = _query_overrides(url, rank, world_size)

    def env(name: str, fallback) -> str:
        v = os.environ.get(name)
        if v is None:
            if fallback is not None:
                return str(fallback)
            raise RendezvousError(f"env:// rendezvous requires env var {name}")
        return v

    rank = int(env("RANK", rank_ if rank_ >= 0 else None))
    world_size = int(env("WORLD_SIZE", world_ if world_ >= 1 else None))
    host = env("MASTER_ADDR", "127.0.0.1")
    port = int(env("MASTER_PORT", DEFAULT_PORT))
    # under an elastic agent the store already exists at MASTER_PORT —
    # everyone (rank 0 included) connects as a client
    # (torchelastic TORCHELASTIC_USE_AGENT_STORE contract)
    use_agent_store = os.environ.get("TDX_USE_AGENT_STORE") == "1" or (
        os.environ.get("TORCHELASTIC_USE_AGENT_STORE", "").lower() == "true"
    )
    is_master = rank == 0 and not use_agent_store
    store = _join_store(
        lambda: TCPStore(
            host, port, world_size, is_master=is_master, timeout=timeout
        ),
        rank, f"env://{host}:{port}", timeout,
    )
    yield (store, rank, world_size)


def _file_handler(url: str, rank: int, world_size: int, timeout: float = 300.0, **kw):
    parsed = urlparse(url)
    rank, world_size = _query_overrides(url, rank, world_size)
    if rank < 0 or world_size < 1:
        raise RendezvousError("file:// rendezvous needs valid rank and world_size")
    path = parsed.path or parsed.netloc
    store = _join_store(
        lambda: FileStore(path, world_size, timeout=timeout),
        rank, f"file://{path}", timeout,
    )
    yield (store, rank, world_size)


register_rendezvous_handler("tcp", _tcp_handler)
register_rendezvous_handler("env", _env_handler)
register_rendezvous_handler("file", _file_handler)
