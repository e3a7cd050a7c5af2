"""Rendezvous key-value stores.

Parity surface (SURVEY.md §2.2 N5): torch c10d's Store family —
abstract `Store` (`Store.hpp:19-127`: set/get/add/wait/check/compare_set,
delete_key, num_keys), `TCPStore` (client/server TCP KV store, rank 0 hosts
the daemon, default port 29500 — `TCPStore.hpp:51-105`), `FileStore`,
`HashStore`, and the `PrefixStore` namespacing wrapper that
`init_process_group` applies (`distributed_c10d.py:1895`).

The TCPStore here is a small threaded socket daemon + client in Python;
the C++ epoll implementation (`csrc/store.cpp`, built by `_native.py`)
takes its place when a host compiler is there. Its wire protocol is the
reference's byte for byte, so a port client talks to a reference daemon
and back. In multiproc mode the same store also carries torch.distributed's
own rendezvous (`distributed._TorchStore`): the port's store is the one
control plane of a gang.
"""

from __future__ import annotations

import logging
import os
import re
import socket
import struct
import sys
import threading
import time
from typing import Dict, List, Mapping, Optional, Tuple

from . import faults, traceguard
from .types import DistStoreError, DistTimeoutError
from .utils.retry import RetryPolicy, call_with_retry

logger = logging.getLogger(__name__)

DEFAULT_PORT = 29500  # torch TCPStore.hpp:87
_DEFAULT_TIMEOUT = 300.0


class StoreTimeoutError(DistStoreError, DistTimeoutError):
    """Store deadline expiry. Subclasses DistTimeoutError (fatal in the
    retry taxonomy — utils/retry.py never retries one) and, through it,
    TimeoutError, preserving existing `except TimeoutError` sites."""


class Store:
    """Abstract KV store — torch c10d Store.hpp:19-127."""

    def __init__(self, timeout: float = _DEFAULT_TIMEOUT):
        self.timeout = timeout
        self._barrier_rounds: Dict[str, int] = {}

    def set(self, key: str, value) -> None:
        raise NotImplementedError

    def get(self, key: str) -> bytes:
        raise NotImplementedError

    def add(self, key: str, amount: int) -> int:
        raise NotImplementedError

    def compare_set(self, key: str, expected, desired) -> bytes:
        raise NotImplementedError

    def check(self, keys: List[str]) -> bool:
        raise NotImplementedError

    def wait(self, keys: List[str], timeout: Optional[float] = None) -> None:
        faults.fire("store.wait", keys=keys)
        deadline = time.monotonic() + (timeout if timeout is not None else self.timeout)
        while not self.check(keys):
            if time.monotonic() > deadline:
                raise StoreTimeoutError(f"timed out waiting for keys {keys}")
            time.sleep(0.005)

    def delete_key(self, key: str) -> bool:
        raise NotImplementedError

    def num_keys(self) -> int:
        raise NotImplementedError

    def set_timeout(self, timeout: float) -> None:
        self.timeout = timeout

    # barrier built on add/wait (used by elastic + debug wrapper).
    # Reusable: each client tracks a per-tag round counter so repeated
    # barriers with the same tag use fresh keys (all ranks necessarily call
    # a barrier the same number of times, so the rounds line up).
    def barrier(self, world_size: int, tag: str = "barrier", timeout: Optional[float] = None) -> None:
        rnd = self._barrier_rounds.get(tag, 0)
        self._barrier_rounds[tag] = rnd + 1
        key = f"__barrier/{tag}/{rnd}"
        arrived = self.add(key, 1)  # storelint: disable=S005 -- round-keyed barrier rows: a late waiter may still poll round N after N+1 forms, deletion would hang it
        sense = f"{key}/done"
        if arrived == world_size:
            self.set(sense, b"1")  # storelint: disable=S005 -- sense key of the round above; same late-waiter hazard
        self.wait([sense], timeout)


_DUMP_ENV = "TDX_STORE_DUMP"
_NUM_RUN_RE = re.compile(r"\d+")


def key_families(data: Mapping[str, bytes]) -> Dict[str, Tuple[int, int]]:
    """Collapse a live key map into normalized families (digit runs →
    `{n}`): family → (key count, total value bytes). The runtime
    counterpart of storelint's static key registry — a family that
    only ever grows here is a coordination leak."""
    fams: Dict[str, List[int]] = {}
    for k, v in data.items():
        row = fams.setdefault(_NUM_RUN_RE.sub("{n}", k), [0, 0])
        row[0] += 1
        row[1] += len(v)
    return {f: (c, b) for f, (c, b) in fams.items()}


def dump_key_families(data: Mapping[str, bytes], label: str = "store") -> None:
    """`TDX_STORE_DUMP=1` teardown observability: print the live key
    families (largest first) when a store daemon closes, so a leaked
    family is visible in any test or deployment log without a
    debugger. No-op unless the env knob is set."""
    if os.environ.get(_DUMP_ENV, "") != "1":
        return
    fams = key_families(data)
    lines = [
        f"[{_DUMP_ENV}] {label}: {sum(c for c, _ in fams.values())} live "
        f"key(s) in {len(fams)} famil{'y' if len(fams) == 1 else 'ies'} "
        "at teardown"
    ]
    for fam, (count, nbytes) in sorted(
        fams.items(), key=lambda kv: (-kv[1][0], kv[0])
    ):
        lines.append(f"  {count:>5} key(s) {nbytes:>9}B  {fam}")
    sys.stderr.write("\n".join(lines) + "\n")


def _to_bytes(v) -> bytes:
    if isinstance(v, bytes):
        return v
    if isinstance(v, str):
        return v.encode()
    raise TypeError(f"store values must be bytes/str, got {type(v)}")


class HashStore(Store):
    """In-process store — torch HashStore.hpp (SURVEY.md N5)."""

    def __init__(self, timeout: float = _DEFAULT_TIMEOUT):
        super().__init__(timeout)
        self._data: Dict[str, bytes] = {}
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)

    def set(self, key, value):
        with self._cv:
            self._data[key] = _to_bytes(value)
            self._cv.notify_all()

    def get(self, key):
        # the one blocking client op with no faults.fire choke point —
        # the trace guard must name it here (TDX_TRACE_GUARD)
        traceguard.check("store.get")
        deadline = time.monotonic() + self.timeout
        with self._cv:
            while key not in self._data:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    raise StoreTimeoutError(f"get({key!r}) timed out")
                self._cv.wait(min(remaining, 0.1))
            return self._data[key]

    def add(self, key, amount):
        with self._cv:
            cur = int(self._data.get(key, b"0"))
            cur += int(amount)
            self._data[key] = str(cur).encode()
            self._cv.notify_all()
            return cur

    def compare_set(self, key, expected, desired):
        expected = _to_bytes(expected)
        desired = _to_bytes(desired)
        with self._cv:
            cur = self._data.get(key)
            if (cur is None and expected == b"") or cur == expected:
                self._data[key] = desired
                self._cv.notify_all()
                return desired
            return cur if cur is not None else expected

    def check(self, keys):
        with self._lock:
            return all(k in self._data for k in keys)

    def wait(self, keys, timeout=None):
        faults.fire("store.wait", keys=keys)
        deadline = time.monotonic() + (timeout if timeout is not None else self.timeout)
        with self._cv:
            while not all(k in self._data for k in keys):
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    raise StoreTimeoutError(f"timed out waiting for keys {keys}")
                self._cv.wait(min(remaining, 0.1))

    def delete_key(self, key):
        with self._cv:
            return self._data.pop(key, None) is not None

    def num_keys(self):
        with self._lock:
            return len(self._data)

    def close(self):
        with self._lock:
            snapshot = dict(self._data)
        dump_key_families(snapshot, label="HashStore")


class FileStore(Store):
    """File-backed store — torch FileStore.hpp. Append-only log + replay,
    safe across processes via fcntl locking."""

    def __init__(self, path: str, world_size: int = -1, timeout: float = _DEFAULT_TIMEOUT):
        super().__init__(timeout)
        self.path = path
        self.world_size = world_size
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        # ensure file exists
        open(path, "ab").close()

    def _replay(self) -> Dict[str, bytes]:
        import fcntl

        with open(self.path, "rb") as f:
            fcntl.flock(f, fcntl.LOCK_SH)
            try:
                return self._replay_unlocked(f)
            finally:
                fcntl.flock(f, fcntl.LOCK_UN)

    def _append(self, key: str, value: bytes):
        import fcntl

        rec = struct.pack("<II", len(key.encode()), len(value)) + key.encode() + value
        with open(self.path, "ab") as f:
            fcntl.flock(f, fcntl.LOCK_EX)
            try:
                f.write(rec)
                f.flush()
                os.fsync(f.fileno())
            finally:
                fcntl.flock(f, fcntl.LOCK_UN)

    def set(self, key, value):
        self._append(key, _to_bytes(value))

    def get(self, key):
        traceguard.check("store.get")
        deadline = time.monotonic() + self.timeout
        while True:
            data = self._replay()
            if key in data:
                return data[key]
            if time.monotonic() > deadline:
                raise StoreTimeoutError(f"get({key!r}) timed out")
            time.sleep(0.01)

    def add(self, key, amount):
        import fcntl

        with open(self.path, "a+b") as f:
            fcntl.flock(f, fcntl.LOCK_EX)
            try:
                data = self._replay_unlocked(f)
                cur = int(data.get(key, b"0")) + int(amount)
                val = str(cur).encode()
                rec = (
                    struct.pack("<II", len(key.encode()), len(val))
                    + key.encode()
                    + val
                )
                f.seek(0, os.SEEK_END)
                f.write(rec)
                f.flush()
                os.fsync(f.fileno())
                return cur
            finally:
                fcntl.flock(f, fcntl.LOCK_UN)

    def _replay_unlocked(self, f) -> Dict[str, bytes]:
        f.seek(0)
        raw = f.read()
        data: Dict[str, bytes] = {}
        off = 0
        while off + 8 <= len(raw):
            klen, vlen = struct.unpack_from("<II", raw, off)
            off += 8
            if off + klen + vlen > len(raw):
                break
            key = raw[off : off + klen].decode()
            off += klen
            val = raw[off : off + vlen]
            off += vlen
            if key.startswith("\x00DEL\x00"):
                data.pop(key[5:], None)
            else:
                data[key] = val
        return data

    def compare_set(self, key, expected, desired):
        import fcntl

        expected = _to_bytes(expected)
        desired = _to_bytes(desired)
        with open(self.path, "a+b") as f:
            fcntl.flock(f, fcntl.LOCK_EX)
            try:
                data = self._replay_unlocked(f)
                cur = data.get(key)
                if (cur is None and expected == b"") or cur == expected:
                    rec = (
                        struct.pack("<II", len(key.encode()), len(desired))
                        + key.encode()
                        + desired
                    )
                    f.seek(0, os.SEEK_END)
                    f.write(rec)
                    f.flush()
                    os.fsync(f.fileno())
                    return desired
                return cur if cur is not None else expected
            finally:
                fcntl.flock(f, fcntl.LOCK_UN)

    def check(self, keys):
        data = self._replay()
        return all(k in data for k in keys)

    def delete_key(self, key):
        self._append("\x00DEL\x00" + key, b"")
        return True

    def num_keys(self):
        return len(self._replay())


class PrefixStore(Store):
    """Namespacing wrapper — torch PrefixStore.hpp; applied by
    init_process_group (`distributed_c10d.py:1895`)."""

    def __init__(self, prefix: str, store: Store):
        super().__init__(store.timeout)
        self.prefix = prefix
        self.underlying = store

    def _k(self, key: str) -> str:
        return f"{self.prefix}/{key}"

    def set(self, key, value):
        self.underlying.set(self._k(key), value)

    def get(self, key):
        return self.underlying.get(self._k(key))

    def add(self, key, amount):
        return self.underlying.add(self._k(key), amount)

    def compare_set(self, key, expected, desired):
        return self.underlying.compare_set(self._k(key), expected, desired)

    def check(self, keys):
        return self.underlying.check([self._k(k) for k in keys])

    def wait(self, keys, timeout=None):
        self.underlying.wait([self._k(k) for k in keys], timeout)

    def delete_key(self, key):
        return self.underlying.delete_key(self._k(key))

    def num_keys(self):
        return self.underlying.num_keys()


# ---------------------------------------------------------------------------
# TCPStore: threaded socket daemon + client.
# Wire format: [u8 cmd][u32 klen][key][u32 vlen][value] -> [u32 len][payload]
# Commands mirror Store.hpp's op set.
# ---------------------------------------------------------------------------

_CMD_SET = 1
_CMD_GET = 2
_CMD_ADD = 3
_CMD_CHECK = 4
_CMD_COMPARE_SET = 5
_CMD_DELETE = 6
_CMD_NUMKEYS = 7
_CMD_PING = 8

# tdx_store_client_call's return for a request that did not fully leave
_NATIVE_NOT_SENT = -1

# fault-injection point names + retry descriptions per wire command
_CMD_NAMES = {
    _CMD_SET: "set",
    _CMD_GET: "get",
    _CMD_ADD: "add",
    _CMD_CHECK: "check",
    _CMD_COMPARE_SET: "compare_set",
    _CMD_DELETE: "delete",
    _CMD_NUMKEYS: "num_keys",
    _CMD_PING: "ping",
}

# Connect attempts ramp gently: a worker usually beats the master's bind
# by milliseconds, so the backoff ceiling stays low (the old loop polled
# at a flat 50 ms with no jitter — thundering-herd on daemon start).
_CONNECT_POLICY = RetryPolicy(base_s=0.05, max_s=0.5)


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    buf = b""
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise ConnectionError("store connection closed")
        buf += chunk
    return buf


class _TCPStoreDaemon(threading.Thread):
    """Rank-0's store server — torch's TCPStoreMasterDaemon/LibUVStoreDaemon
    (TCPStore.hpp:51 architecture comment). One thread per client; data
    guarded by a lock."""

    def __init__(self, host: str, port: int):
        super().__init__(daemon=True, name="tdx-tcpstore-daemon")
        self._data: Dict[str, bytes] = {}
        self._lock = threading.Lock()
        self._srv = socket.create_server((host, port), reuse_port=False)
        self._srv.settimeout(0.2)
        self.port = self._srv.getsockname()[1]
        self._stop = threading.Event()

    def run(self):
        clients = []
        while not self._stop.is_set():
            try:
                conn, _ = self._srv.accept()
            except socket.timeout:
                continue
            except OSError:
                break
            t = threading.Thread(target=self._serve, args=(conn,), daemon=True)
            t.start()
            clients.append(t)
        self._srv.close()

    def stop(self):
        self._stop.set()

    def _serve(self, conn: socket.socket):
        try:
            while True:
                hdr = _recv_exact(conn, 1)
                cmd = hdr[0]
                klen = struct.unpack("<I", _recv_exact(conn, 4))[0]
                key = _recv_exact(conn, klen).decode()
                vlen = struct.unpack("<I", _recv_exact(conn, 4))[0]
                val = _recv_exact(conn, vlen)
                resp = self._dispatch(cmd, key, val)
                conn.sendall(struct.pack("<I", len(resp)) + resp)
        except (ConnectionError, OSError):
            pass
        finally:
            conn.close()

    def _dispatch(self, cmd: int, key: str, val: bytes) -> bytes:
        with self._lock:
            if cmd == _CMD_SET:
                self._data[key] = val
                return b"ok"
            if cmd == _CMD_GET:
                v = self._data.get(key)
                return b"\x01" + v if v is not None else b"\x00"
            if cmd == _CMD_ADD:
                cur = int(self._data.get(key, b"0")) + int(val.decode())
                self._data[key] = str(cur).encode()
                return str(cur).encode()
            if cmd == _CMD_CHECK:
                keys = val.decode().split("\x00") if val else []
                ok = all(k in self._data for k in keys)
                return b"\x01" if ok else b"\x00"
            if cmd == _CMD_COMPARE_SET:
                elen = struct.unpack("<I", val[:4])[0]
                expected = val[4 : 4 + elen]
                desired = val[4 + elen :]
                cur = self._data.get(key)
                if (cur is None and expected == b"") or cur == expected:
                    self._data[key] = desired
                    return desired
                return cur if cur is not None else expected
            if cmd == _CMD_DELETE:
                return b"\x01" if self._data.pop(key, None) is not None else b"\x00"
            if cmd == _CMD_NUMKEYS:
                return str(len(self._data)).encode()
            if cmd == _CMD_PING:
                return b"pong"
        return b"err"


class TCPStore(Store):
    """Client/server TCP KV store — torch TCPStore.hpp. `is_master=True`
    (rank 0) hosts the daemon in-process; everyone connects as a client.

    Uses the native C++ epoll daemon/client (csrc/store.cpp via ctypes)
    when available — same wire protocol, so native and Python peers mix
    freely; falls back to the threaded Python implementation otherwise
    (TDX_NATIVE=0 forces the fallback)."""

    def __init__(
        self,
        host: str = "127.0.0.1",
        port: int = DEFAULT_PORT,
        world_size: int = -1,
        is_master: bool = False,
        timeout: float = _DEFAULT_TIMEOUT,
        wait_for_workers: bool = False,
        use_native: Optional[bool] = None,
    ):
        super().__init__(timeout)
        from . import _native

        self.host = host
        self.world_size = world_size
        self._daemon: Optional[_TCPStoreDaemon] = None
        self._native_daemon = None
        self._native_client = None
        self._lib = _native.load() if use_native in (None, True) else None
        self.native = self._lib is not None
        if is_master:
            if self.native:
                self._native_daemon = self._lib.tdx_store_server_start(
                    host.encode(), port
                )
                if not self._native_daemon:
                    raise OSError(f"native store daemon failed to bind {host}:{port}")
                port = self._lib.tdx_store_server_port(self._native_daemon)
            else:
                self._daemon = _TCPStoreDaemon(host, port)
                self._daemon.start()
                port = self._daemon.port
        self.port = port
        # last successful GET response per key, serving injected
        # stale-read faults (a replica that lags the primary)
        self._stale: Dict[str, bytes] = {}
        self._sock = None
        self._sock_lock = threading.Lock()
        if self.native:
            self._connect_native()
        else:
            self._sock = self._connect()
        # worker-join handshake (torch TCPStore wait_for_workers semantics):
        # every worker registers on connect; the master's constructor blocks
        # until world_size-1 workers have joined. The counter key is scoped
        # by the elastic restart generation (TDX_RESTART_COUNT, inherited by
        # respawned workers) so a persistent agent-hosted daemon never
        # counts generation N-1's joins against generation N (R007).
        gen = os.environ.get("TDX_RESTART_COUNT", "0") or "0"
        join_key = f"__init/worker_count/gen{gen}"
        if world_size > 0 and not is_master:
            self.add(join_key, 1)  # storelint: disable=S005 -- generation-scoped join counter read by the daemon host; dies with the store it gates
        if is_master and wait_for_workers and world_size > 1:
            deadline = time.monotonic() + self.timeout
            while int(self._call(_CMD_ADD, join_key, b"0").decode()) < world_size - 1:
                if time.monotonic() > deadline:
                    raise StoreTimeoutError(
                        f"timed out waiting for {world_size - 1} workers to join"
                    )
                time.sleep(0.01)

    def _connect_once(self, deadline: Optional[float] = None) -> socket.socket:
        faults.fire("store.connect", host=self.host, port=self.port)
        budget = self.timeout
        if deadline is not None:
            # a single dial must not outlive the enclosing op deadline
            # (a SYN-blackholed master blocks inside create_connection
            # for the whole socket timeout, invisible to the retry
            # loop's between-attempts deadline checks)
            budget = max(min(budget, deadline - time.monotonic()), 0.05)
        s = socket.create_connection((self.host, self.port), timeout=budget)
        s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        return s

    def _connect(self, deadline: Optional[float] = None) -> socket.socket:
        eff_deadline = (
            deadline if deadline is not None
            else time.monotonic() + self.timeout
        )
        try:
            return call_with_retry(
                lambda: self._connect_once(eff_deadline),
                desc=f"store connect {self.host}:{self.port}",
                deadline=eff_deadline,
                policy=_CONNECT_POLICY,
            )
        except DistTimeoutError as e:
            raise StoreTimeoutError(
                f"could not connect to store at {self.host}:{self.port}: "
                f"{e.__cause__ or e}"
            ) from e

    def _connect_native(self, deadline: Optional[float] = None) -> None:
        faults.fire("store.connect", host=self.host, port=self.port)
        budget = float(self.timeout)
        if deadline is not None:
            # honor the enclosing op's deadline: a reconnect mid-op must
            # not block for a fresh full timeout against a dead master
            budget = max(min(budget, deadline - time.monotonic()), 0.05)
        self._native_client = self._lib.tdx_store_client_connect(
            self.host.encode(), self.port, budget
        )
        if not self._native_client:
            raise StoreTimeoutError(
                f"could not connect to store at {self.host}:{self.port}"
            )

    def _drop_connection_locked(self) -> None:
        """Discard a connection that failed mid-RPC so the next attempt
        redials. Caller holds `_sock_lock`."""
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
            self._sock = None
        if self._native_client is not None:
            try:
                self._lib.tdx_store_client_close(self._native_client)
            except Exception:
                # the connection is being discarded either way; a close
                # failure is unreportable to the caller but worth a trace
                # (R005 triage)
                logger.debug("native store client close failed", exc_info=True)
            self._native_client = None

    def _transport_locked(self, cmd: int, key: str, val: bytes,
                          deadline: float) -> bytes:
        """One RPC over the current connection, redialing a dropped one.
        Caller holds `_sock_lock`; connection-level failures propagate
        for the retry wrapper in `_call`.

        ADD is the one non-idempotent wire op (the daemon applies the
        increment before replying): once its request bytes are fully on
        the wire, a lost RESPONSE is ambiguous — the increment may have
        been applied — so a blind resend could double-count a barrier or
        worker-join counter. That ambiguity is surfaced as a fatal
        DistStoreError instead of being retried; failures before the
        request is sent (dial, send) stay retryable for every op."""
        kb = key.encode()
        if self.native:
            if self._native_client is None:
                self._connect_native(deadline=deadline)
            # the native client sends and receives in one call, each wait
            # bounded by what is left of this op's deadline; it tells a
            # request that never fully left (not applied: retryable for
            # every op) from one whose response was lost
            n = self._lib.tdx_store_client_call(
                self._native_client, cmd, kb, len(kb), val, len(val),
                max(deadline - time.monotonic(), 0.001),
            )
            if n == _NATIVE_NOT_SENT:
                raise ConnectionError("native store request not sent")
            if n < 0:
                if cmd == _CMD_ADD:
                    self._drop_connection_locked()
                    raise DistStoreError(
                        f"store add({key!r}) failed after the request may "
                        "have been applied; not retrying a non-idempotent op"
                    )
                raise ConnectionError("native store response lost")
            import ctypes

            return ctypes.string_at(
                self._lib.tdx_store_client_response(self._native_client), n
            )
        if self._sock is None:
            self._sock = self._connect(deadline=deadline)
        msg = bytes([cmd]) + struct.pack("<I", len(kb)) + kb + struct.pack("<I", len(val)) + val
        self._sock.sendall(msg)
        try:
            n = struct.unpack("<I", _recv_exact(self._sock, 4))[0]
            return _recv_exact(self._sock, n)
        except (ConnectionError, OSError) as e:
            if cmd == _CMD_ADD:
                self._drop_connection_locked()
                raise DistStoreError(
                    f"store add({key!r}): connection lost awaiting the "
                    f"response ({e}); the increment may have been applied — "
                    "not retrying a non-idempotent op"
                ) from e
            raise

    def _call(self, cmd: int, key: str, val: bytes) -> bytes:
        """One logical store op: fault-injectable, retried with
        exponential backoff + jitter on transient connection failures,
        failing fast with a StoreTimeoutError/DistTimeoutError once the
        op deadline (self.timeout) is spent. The deadline is shared by
        every attempt AND any nested reconnect, so retries never
        compound the budget."""
        op = _CMD_NAMES.get(cmd, f"cmd{cmd}")
        point = f"store.{op}"
        deadline = time.monotonic() + self.timeout

        def attempt() -> bytes:
            rule = faults.fire(point, key=key)
            if rule is not None and rule.action == "stale" and cmd == _CMD_GET:
                # stale replica read: the last response THIS client saw
                # for the key, or a miss if it never saw one
                return self._stale.get(key, b"\x00")
            with self._sock_lock:
                try:
                    resp = self._transport_locked(cmd, key, val, deadline)
                except (ConnectionError, OSError):
                    self._drop_connection_locked()
                    raise
            # cache last GET responses ONLY while a fault plan is active
            # (stale-read faults need them) — an always-on cache would
            # grow by one entry per distinct key for the client lifetime
            if cmd == _CMD_GET and resp[:1] == b"\x01" and faults.enabled():
                self._stale[key] = resp
            return resp

        return call_with_retry(
            attempt, desc=f"store {op}({key!r})", deadline=deadline
        )

    def set(self, key, value):
        self._call(_CMD_SET, key, _to_bytes(value))

    def get(self, key):
        deadline = time.monotonic() + self.timeout
        while True:
            resp = self._call(_CMD_GET, key, b"")
            if resp[:1] == b"\x01":
                return resp[1:]
            if time.monotonic() > deadline:
                raise StoreTimeoutError(f"get({key!r}) timed out")
            time.sleep(0.01)

    def add(self, key, amount):
        return int(self._call(_CMD_ADD, key, str(int(amount)).encode()).decode())

    def compare_set(self, key, expected, desired):
        expected = _to_bytes(expected)
        desired = _to_bytes(desired)
        payload = struct.pack("<I", len(expected)) + expected + desired
        return self._call(_CMD_COMPARE_SET, key, payload)

    def check(self, keys):
        return self._call(_CMD_CHECK, "", "\x00".join(keys).encode()) == b"\x01"

    def delete_key(self, key):
        return self._call(_CMD_DELETE, key, b"") == b"\x01"

    def num_keys(self):
        return int(self._call(_CMD_NUMKEYS, "", b"").decode())

    def close(self):
        try:
            if self._sock is not None:
                self._sock.close()
            if self._native_client is not None:
                self._lib.tdx_store_client_close(self._native_client)
                self._native_client = None
        finally:
            if self._daemon is not None:
                with self._daemon._lock:
                    snapshot = dict(self._daemon._data)
                dump_key_families(
                    snapshot, label=f"TCPStore(:{self.port})"
                )
                self._daemon.stop()
            if self._native_daemon is not None:
                self._lib.tdx_store_server_stop(self._native_daemon)
                self._native_daemon = None

    @property
    def is_master(self) -> bool:
        return self._daemon is not None or self._native_daemon is not None
