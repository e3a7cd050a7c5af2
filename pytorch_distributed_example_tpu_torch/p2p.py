"""Direct peer-to-peer TCP data plane for multiproc p2p.

The port of the reference's `p2p.py`, with its wire format byte for byte
(`_HELLO`, `_FHDR`, `_DIM`, the caps, the `"none"` endpoint), so the two
packages' planes exchange frames. Torch tensors travel as `kind="nd"`
frames: a CUDA tensor is copied to pinned host memory first (the plane
never hands a socket, or gloo, a device pointer), and bf16, which numpy
lacks, travels as its raw 16-bit words with "bfloat16" in the dtype
field (the reference's ml_dtypes arrays carry the same bytes and name).
A received frame comes back as a CPU torch tensor; the caller moves it
to the card.

Without this plane every p2p byte would funnel through the rank-0 store
daemon (one epoll loop shared by all pairs). gloo gives
each rank pair its own TCP connection (`ProcessGroupGloo.hpp:48+`
full-mesh contexts, rendezvoused through the store); this module is that
design for the multiproc runtime:

* each process runs one listener; its `(host, port)` endpoint is
  published in the store ONCE per world incarnation (the only store
  traffic this plane ever generates);
* a sender lazily opens a per-peer connection on first send and streams
  frames over it — tensor bytes move process-to-process, never through
  the daemon;
* receives land in an in-memory inbox keyed `(src, route, tag, seq)`,
  matching the store path's sequencing exactly, so `send`/`recv`/
  `recv(src=None)`/`batch_isend_irecv` keep their semantics unchanged;
* a rank whose listener cannot come up (or that sets `TDX_P2P_PLANE=0`)
  publishes a "none" endpoint and peers fall back to the store path for
  messages TO it — the store remains the control plane and the fallback
  data plane.

Wire format, per connection: one hello (`<I` sender global rank), then
frames of `[fixed struct header][route bytes][dtype bytes][shape dims]
[payload bytes]` — the framing layer is pure struct codes (a pickled
header would mean arbitrary deserialization and unbounded
`np.empty(plen)` from ANY process that can reach the port; the trust
model matches TCPStore, but framing should not widen it). Field lengths
are validated against hard caps before any allocation. Tensors and numpy
arrays ship as raw buffers (`kind="nd"`, zero pickling of the bulk bytes);
everything else falls back to pickle (`kind="pkl"` — object payloads
are pickled by API contract, exactly like torch's object collectives).

Backpressure: each reader counts the bytes parked
in the inbox for its connection and STOPS READING the socket while over
the high-water mark (`TDX_P2P_INBOX_HWM`, default 256 MB). The kernel
receive buffer then fills, TCP flow control closes the window, and the
sender's `sendall` blocks — gloo's bounded-queue behavior, enforced by
the transport instead of an application ack.
"""

from __future__ import annotations

import logging
import os
import pickle
import socket
import struct
import threading
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from . import faults
from .utils.retry import RetryPolicy, call_with_retry

logger = logging.getLogger(__name__)

_HELLO = struct.Struct("<I")
# frame header: route_len, tag, seq, kind(0=nd 1=pkl), ndim, dtype_len,
# payload_len; then route/dtype bytes and `<q` dims follow
_FHDR = struct.Struct("<HiqBBHQ")
_DIM = struct.Struct("<q")
_KIND_ND, _KIND_PKL = 0, 1
# validation caps, enforced BEFORE any allocation sized by the wire
_MAX_ROUTE = 1024
_MAX_DTYPE = 64
_MAX_NDIM = 32
_MAX_MSG = int(os.environ.get("TDX_P2P_MAX_MSG", str(4 << 30)))
_NONE_EP = b"none"
# Reader-side buffered-bytes high-water mark per connection: over this,
# the reader parks until the inbox drains (TCP flow control then
# throttles the sender).
_INBOX_HWM = int(os.environ.get("TDX_P2P_INBOX_HWM", str(256 << 20)))
# Socket buffer sizes are left to kernel autotuning: explicit
# SO_SNDBUF/SO_RCVBUF pins the window and measured ~2x slower on
# loopback than autotuned buffers. Override via TDX_P2P_SOCK_BUF if a
# DCN path needs a fixed window.
_SOCK_BUF = int(os.environ.get("TDX_P2P_SOCK_BUF", "0"))
_RECV_CHUNK = 8 << 20
# In a process that uses the card, a payload this large lands in pinned
# host memory (torch's caching host allocator): its pages are already
# faulted in, and the copy to the card that follows is a DMA.
_PIN_MIN = 1 << 20


def _advertise_host() -> str:
    """The address peers should dial. Explicit override, else the
    rendezvous host heuristic: if the master address is loopback the
    whole gang is on this machine; otherwise use this host's name."""
    adv = os.environ.get("TDX_P2P_ADVERTISE")
    if adv:
        return adv
    master = os.environ.get("MASTER_ADDR", "127.0.0.1")
    if master in ("127.0.0.1", "localhost", "::1", ""):
        return "127.0.0.1"
    try:
        return socket.gethostbyname(socket.gethostname())
    except OSError:
        return "127.0.0.1"


def _pack_frame_header(
    route: str, tag: int, seq: int, kind: str, dtype: str, shape: tuple,
    plen: int,
) -> bytes:
    rb = route.encode()
    db = dtype.encode()
    if len(rb) > _MAX_ROUTE or len(db) > _MAX_DTYPE or len(shape) > _MAX_NDIM:
        raise ValueError(
            f"p2p frame metadata too large (route={len(rb)}B "
            f"dtype={len(db)}B ndim={len(shape)})"
        )
    if not (-(2**31) <= tag < 2**31) or not (-(2**63) <= seq < 2**63):
        # curated error instead of a raw struct.error mid-send (the old
        # pickled framing accepted any int; the wire now pins i32/i64)
        raise ValueError(
            f"p2p tag must fit int32 and seq int64 (got tag={tag}, "
            f"seq={seq})"
        )
    if plen > _MAX_MSG:
        raise ValueError(
            f"p2p message of {plen} bytes exceeds TDX_P2P_MAX_MSG "
            f"({_MAX_MSG}); raise the cap on BOTH ends to send it"
        )
    k = _KIND_ND if kind == "nd" else _KIND_PKL
    return (
        _FHDR.pack(len(rb), tag, seq, k, len(shape), len(db), plen)
        + rb + db + b"".join(_DIM.pack(int(d)) for d in shape)
    )


# this process's device -> pinned host copies of the tensors it sent:
# bytes and host seconds (`reset_stats()` zeroes them)
STAGING = {"bytes": 0, "seconds": 0.0}


def reset_stats() -> None:
    STAGING.update(bytes=0, seconds=0.0)


def _host(t: torch.Tensor) -> torch.Tensor:
    """A contiguous CPU copy or view of t: a CUDA tensor lands in pinned
    host memory first (device -> pinned host -> socket), complete before
    the return (counted in `STAGING`)."""
    t = t.detach()
    if t.device.type == "cpu":
        return t.contiguous()
    t0 = time.perf_counter()
    h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    h.copy_(t)
    STAGING["seconds"] += time.perf_counter() - t0
    STAGING["bytes"] += h.numel() * h.element_size()
    return h


def encode(val) -> Tuple[str, str, tuple, object]:
    """(kind, dtype, shape, buffer) — numpy and torch bulk bytes raw
    (bf16 as its 16-bit words named "bfloat16"), the rest pickled."""
    if isinstance(val, torch.Tensor):
        h = _host(val)
        if h.dtype == torch.bfloat16:
            arr = h.view(torch.int16).numpy()
            return "nd", "bfloat16", tuple(h.shape), memoryview(arr).cast("B")
        arr = h.numpy()
        return "nd", str(arr.dtype), arr.shape, memoryview(arr).cast("B")
    if isinstance(val, np.ndarray) and val.dtype != object:
        arr = np.ascontiguousarray(val)
        # byte-cast view: len() must be NBYTES (the wire length), not
        # the element count arr.data would report
        return "nd", str(arr.dtype), arr.shape, memoryview(arr).cast("B")
    payload = pickle.dumps(val)
    return "pkl", "", (), payload


def decode(kind: str, dtype: str, shape: tuple, buf) -> object:
    """An `nd` frame as a CPU torch tensor over the received bytes
    (bfloat16 from its words); a `pkl` frame unpickled."""
    if kind == "nd":
        # buf is the buffer the reader filled -> writable tensor view
        if dtype == "bfloat16":
            words = np.frombuffer(buf, dtype=np.int16)
            return torch.from_numpy(words).view(torch.bfloat16).reshape(shape)
        return torch.from_numpy(np.frombuffer(buf, dtype=np.dtype(dtype)).reshape(shape))
    return pickle.loads(bytes(buf))


class PlaneClosed(RuntimeError):
    pass


class P2PPlane:
    """One per process per world incarnation.

    `store` must be scoped to the incarnation (the caller wraps the world
    store in a PrefixStore) so endpoints from a dead generation are never
    dialed. All ranks MUST construct a plane (enabled or not): the
    endpoint key doubles as the routing decision peers wait on.
    """

    def __init__(
        self,
        my_rank: int,
        store,
        enabled: bool = True,
        bind_host: str = "",
        advertise: Optional[str] = None,
    ):
        self.rank = int(my_rank)
        self.store = store
        self.enabled = enabled
        self.bind_host = bind_host
        self.advertise = advertise or _advertise_host()
        self.listening = False
        self._listener: Optional[socket.socket] = None
        self._accept_thread: Optional[threading.Thread] = None
        self._readers: List[threading.Thread] = []
        self._in_conns: List[socket.socket] = []
        self._out: Dict[int, socket.socket] = {}
        self._out_locks: Dict[int, threading.Lock] = {}
        self._out_guard = threading.Lock()
        self._ep_cache: Dict[int, Optional[Tuple[str, int]]] = {}
        self._inbox: Dict[tuple, tuple] = {}
        self._cond = threading.Condition()
        self._waiting = 0  # recv threads currently blocked empty-handed
        self._closed = False
        self._published: Optional[bytes] = None  # our ep/<rank> payload
        # frames and payload bytes this plane carried, each way
        self.frames_sent = 0
        self.bytes_sent = 0
        self.frames_received = 0
        self.bytes_received = 0

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> "P2PPlane":
        """Bind the listener (if enabled) and publish the endpoint."""
        ep = _NONE_EP
        if self.enabled:
            try:
                s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
                if _SOCK_BUF:
                    s.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF, _SOCK_BUF)
                s.bind((self.bind_host, 0))
                s.listen(64)
                self._listener = s
                self.listening = True
                port = s.getsockname()[1]
                ep = pickle.dumps((self.advertise, port))
                t = threading.Thread(
                    target=self._accept_loop,
                    name=f"tdx-p2p-accept-r{self.rank}",
                    daemon=True,
                )
                t.start()
                self._accept_thread = t
            except OSError:
                self.listening = False  # publish "none"; peers fall back
        self.store.set(f"ep/{self.rank}", ep)  # distlint: disable=R007 -- close() atomically tombstones to _NONE_EP via compare_set; deletion would make late peers BLOCK instead of reading "opted out"
        self._published = ep  # close() tombstones only our own payload
        return self

    def close(self) -> None:
        with self._cond:
            if self._closed:
                return
            self._closed = True
            self._cond.notify_all()
        # unpublish the endpoint: even on a store whose
        # caller forgot the incarnation PrefixStore, a cleanly-closed
        # plane must not leave a dialable-looking endpoint behind. ONE
        # atomic compare_set tombstones the key only while it still holds
        # OUR payload — a successor generation that already re-published
        # this rank's key mismatches `expected` and is left alone, and a
        # dead store costs at most the single op's deadline (no
        # check/get/delete chain to stall through). Peers that read the
        # tombstone see "rank opted out" (_NONE_EP) instead of blocking.
        try:
            if self._published is not None and self._published != _NONE_EP:
                self.store.compare_set(
                    f"ep/{self.rank}", self._published, _NONE_EP
                )
        except Exception:
            # best-effort: the store host is often already gone at teardown
            logger.debug("p2p endpoint unpublish failed", exc_info=True)
        for s in [self._listener] + list(self._out.values()) + self._in_conns:
            if s is not None:
                try:
                    s.shutdown(socket.SHUT_RDWR)
                except OSError:
                    pass
                try:
                    s.close()
                except OSError:
                    pass
        self.listening = False

    # -- endpoints ---------------------------------------------------------

    def endpoint_of(self, dst: int, timeout: float) -> Optional[Tuple[str, int]]:
        """(host, port) of dst's listener, or None if dst opted out.
        Blocks until dst has PUBLISHED (every rank publishes in
        init_process_group, so this resolves as soon as dst initializes)."""
        if dst in self._ep_cache:
            return self._ep_cache[dst]
        key = f"ep/{dst}"
        self.store.wait([key], timeout)
        raw = self.store.get(key)
        ep = None if raw == _NONE_EP else tuple(pickle.loads(raw))
        self._ep_cache[dst] = ep
        return ep

    # -- send --------------------------------------------------------------

    def _peer_lock(self, dst: int) -> threading.Lock:
        with self._out_guard:
            return self._out_locks.setdefault(dst, threading.Lock())

    def _connect_locked(self, dst: int, ep: Tuple[str, int], timeout: float) -> socket.socket:
        """Cached-or-new connection to dst. Caller holds dst's peer lock.

        The INITIAL dial retries with backoff (a peer that just published
        its endpoint may not be accepting yet — previously a single
        refused connect failed the whole send); once a connection exists,
        a mid-stream failure stays fatal for the pair (see `send`)."""
        s = self._out.get(dst)
        if s is not None:
            return s

        def dial() -> socket.socket:
            faults.fire("p2p.connect", dst=dst)
            c = socket.create_connection(ep, timeout=timeout)
            c.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            if _SOCK_BUF:
                c.setsockopt(socket.SOL_SOCKET, socket.SO_SNDBUF, _SOCK_BUF)
            c.settimeout(None)
            return c

        s = call_with_retry(
            dial,
            desc=f"p2p connect r{self.rank}->r{dst} {ep[0]}:{ep[1]}",
            timeout=timeout,
            policy=RetryPolicy(base_s=0.02, max_s=0.5),
        )
        s.sendall(_HELLO.pack(self.rank))
        self._out[dst] = s
        return s

    def send(self, dst: int, route: str, tag: int, seq: int, val, timeout: float) -> None:
        """Stream one message to dst's inbox. Caller has already checked
        `endpoint_of(dst)` is not None (else it takes the store path).

        A connection failure mid-stream is FATAL for the pair (gloo
        semantics: a broken pair connection fails the op) — TCP gives no
        delivery acknowledgement, so a silent reconnect-and-resend could
        skip a frame the kernel buffered but never delivered, leaving
        the receiver's (src, tag) sequence permanently off-by-one. The
        elastic layer owns recovery: a re-formed gang builds a fresh
        plane in a new incarnation."""
        if self._closed:
            raise PlaneClosed("p2p plane closed")
        # slow-peer straggler simulation lands here (action "delay");
        # "reset"/"error" model a sender-side plane failure
        faults.fire("p2p.send", dst=dst, route=route, tag=tag, seq=seq)
        ep = self.endpoint_of(dst, timeout)
        if ep is None:
            raise RuntimeError(f"rank {dst} has no p2p listener (store path only)")
        kind, dtype, shape, buf = encode(val)
        header = _pack_frame_header(route, tag, seq, kind, dtype, shape, len(buf))
        with self._peer_lock(dst):  # frame atomicity per connection
            s = self._connect_locked(dst, ep, timeout)
            try:
                s.sendall(header)
                s.sendall(buf)
                self.frames_sent += 1
                self.bytes_sent += len(buf)
            except OSError as e:
                self._out.pop(dst, None)
                try:
                    s.close()
                except OSError:
                    pass
                raise RuntimeError(
                    f"p2p connection to rank {dst} failed mid-send "
                    f"(route={route} tag={tag} seq={seq}): {e}"
                ) from e

    # -- receive -----------------------------------------------------------

    def _accept_loop(self) -> None:
        while True:
            try:
                conn, _ = self._listener.accept()
            except OSError:
                return  # listener closed
            try:
                hello = self._read_exact(conn, _HELLO.size)
            except (OSError, EOFError):
                conn.close()
                continue
            (src,) = _HELLO.unpack(hello)
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            t = threading.Thread(
                target=self._reader,
                args=(conn, src),
                name=f"tdx-p2p-read-r{self.rank}-from{src}",
                daemon=True,
            )
            with self._cond:  # same guard the reader's pruning uses
                self._in_conns.append(conn)
                self._readers.append(t)
            t.start()

    @staticmethod
    def _read_exact(conn: socket.socket, n: int, pinned: bool = False):
        # np.empty, not bytearray: bytearray(64MB) zero-fills — a whole
        # extra pass over memory per message on the hot path
        if pinned:
            buf = torch.empty(n, dtype=torch.uint8, pin_memory=True).numpy()
        else:
            buf = np.empty(n, np.uint8)
        view = memoryview(buf)
        got = 0
        while got < n:
            r = conn.recv_into(view[got:], min(n - got, _RECV_CHUNK))
            if r == 0:
                raise EOFError
            got += r
        return buf

    def _read_frame_header(self, conn: socket.socket):
        """Parse one struct-framed header, validating every length against
        its cap BEFORE allocating anything sized by the wire."""
        (rlen, tag, seq, k, ndim, dlen, plen) = _FHDR.unpack(
            self._read_exact(conn, _FHDR.size)
        )
        if rlen > _MAX_ROUTE or dlen > _MAX_DTYPE or ndim > _MAX_NDIM:
            raise ValueError(
                f"p2p frame header out of bounds (route={rlen} dtype={dlen} "
                f"ndim={ndim}) — protocol mismatch or hostile peer"
            )
        if plen > _MAX_MSG:
            raise ValueError(
                f"p2p frame of {plen} bytes exceeds TDX_P2P_MAX_MSG ({_MAX_MSG})"
            )
        rest = self._read_exact(conn, rlen + dlen + ndim * _DIM.size)
        route = bytes(rest[:rlen]).decode()
        dtype = bytes(rest[rlen:rlen + dlen]).decode()
        base = rlen + dlen
        shape = tuple(
            _DIM.unpack_from(rest, base + i * _DIM.size)[0]
            for i in range(ndim)
        )
        kind = "nd" if k == _KIND_ND else "pkl"
        return route, tag, seq, kind, dtype, shape, plen

    def _reader(self, conn: socket.socket, src: int) -> None:
        buffered = [0]  # bytes this connection has parked in the inbox
        try:
            while True:
                route, tag, seq, kind, dtype, shape, plen = \
                    self._read_frame_header(conn)
                pinned = (kind == "nd" and plen >= _PIN_MIN
                          and torch.cuda.is_available() and torch.cuda.is_initialized())
                payload = self._read_exact(conn, plen, pinned)
                with self._cond:
                    buffered[0] += plen
                    self.frames_received += 1
                    self.bytes_received += plen
                    self._inbox[(src, route, tag, seq)] = (
                        kind, dtype, shape, payload, buffered,
                    )
                    self._cond.notify_all()
                    # backpressure: park until consumers drain below the
                    # mark — the unread socket fills the kernel buffer and
                    # TCP flow control blocks the sender (gloo's bounded
                    # queue, enforced by the transport). NEVER park while
                    # a recv is blocked empty-handed (_waiting > 0): the
                    # frame it wants may still be ON this socket behind
                    # the backlog, and parking would deadlock it against
                    # the HWM (head-of-line blocking). While a waiter is
                    # starved the inbox may exceed the mark — bounded by
                    # the traffic actually ahead of the wanted frame,
                    # which is torch/gloo's unmatched-message buffering.
                    while (
                        buffered[0] > _INBOX_HWM
                        and not self._closed
                        and self._waiting == 0
                    ):
                        self._cond.wait(0.5)
        except (OSError, EOFError):
            pass  # peer closed; delivered messages stay
        except ValueError:
            # a frame failed validation: protocol mismatch or hostile
            # peer — not a normal close, so leave a trace (R005-spirit
            # triage: dispatch-path failures must not vanish silently)
            logger.warning(
                "p2p reader from rank %s dropped the connection on a "
                "malformed frame", src, exc_info=True,
            )
        finally:
            try:
                conn.close()
            except OSError:
                pass
            with self._cond:
                # prune so reconnect churn can't grow these unboundedly
                try:
                    self._in_conns.remove(conn)
                except ValueError:
                    pass
                self._readers[:] = [
                    t for t in self._readers if t is not threading.current_thread()
                ]

    def recv(self, src: int, route: str, tag: int, seq: int, timeout: float):
        got = self._wait([(src, route, tag, seq)], timeout)
        return decode(*got[1])

    def recv_any(
        self, candidates: List[Tuple[int, int]], route: str, tag: int, timeout: float
    ) -> Tuple[int, object]:
        """candidates = [(src, next_expected_seq)] — first message to
        arrive from any of them wins (torch recv(src=None))."""
        keys = [(src, route, tag, seq) for src, seq in candidates]
        key, body = self._wait(keys, timeout)
        return key[0], decode(*body)

    def _wait(self, keys: List[tuple], timeout: float) -> Tuple[tuple, tuple]:
        deadline = time.monotonic() + (timeout if timeout is not None else 3600.0)
        with self._cond:
            while True:
                for k in keys:
                    body = self._inbox.pop(k, None)
                    if body is not None:
                        kind, dtype, shape, payload, buffered = body
                        buffered[0] -= getattr(payload, "nbytes", len(payload))
                        self._cond.notify_all()  # wake a parked reader
                        return k, (kind, dtype, shape, payload)
                if self._closed:
                    raise PlaneClosed("p2p plane closed while receiving")
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    raise TimeoutError(
                        f"p2p recv: nothing from {sorted({k[0] for k in keys})} "
                        f"within {timeout}s"
                    )
                # mark this thread starved and wake parked readers: the
                # frame it needs may sit behind an over-HWM backlog
                self._waiting += 1
                self._cond.notify_all()
                try:
                    self._cond.wait(min(remaining, 0.5))
                finally:
                    self._waiting -= 1
