"""The port's store family and rendezvous against the JAX package's.

* `HashStore`, `FileStore`, `PrefixStore` and `TCPStore` (native C++ daemon
  and the Python one) keep the Store contract: set/get/add/check/wait/
  compare_set/delete_key/num_keys and the reusable barrier.
* The same op sequence on a store of each package gives the same values.
* The wire protocol is the reference's byte for byte: a port client works
  against a reference daemon and a reference client against a port daemon,
  for every pairing of the native and the Python implementations.
* `tcp://`, `env://` and `file://` rendezvous hand back a working store.
"""

import threading

import pytest

from pytorch_distributed_example_tpu import store as jstore
from pytorch_distributed_example_tpu_torch import _native
from pytorch_distributed_example_tpu_torch import store as tstore
from pytorch_distributed_example_tpu_torch.rendezvous import (
    RendezvousError,
    register_rendezvous_handler,
    rendezvous,
)
from tests._mp_util import free_port


def _script(store):
    """One op sequence; returns every value it read."""
    out = []
    store.set("k1", b"v1")
    out.append(store.get("k1"))
    store.set("k1", "v2")
    out.append(store.get("k1"))
    out.append(store.add("ctr", 1))
    out.append(store.add("ctr", 5))
    out.append(store.check(["k1", "ctr"]))
    out.append(store.check(["nope"]))
    store.wait(["k1"], timeout=1.0)
    out.append(store.compare_set("cas", "", "a"))
    out.append(store.compare_set("cas", "wrong", "b"))
    out.append(store.compare_set("cas", "a", "b"))
    out.append(store.delete_key("k1"))
    out.append(store.check(["k1"]))
    out.append(store.delete_key("k1"))
    out.append(store.num_keys())
    return out


WANT = [b"v1", b"v2", 1, 6, True, False, b"a", b"a", b"b", True, False, False, 2]


def _make(mod, kind, tmp_path):
    """A fresh store of `kind` from package `mod`, and how to close it."""
    if kind == "hash":
        return mod.HashStore(timeout=2.0)
    if kind == "file":
        return mod.FileStore(str(tmp_path / f"{mod.__name__}.fs"), timeout=2.0)
    if kind == "prefix":
        return mod.PrefixStore("ns", mod.HashStore(timeout=2.0))
    return mod.TCPStore("127.0.0.1", 0, is_master=True, timeout=3.0,
                        use_native=(kind == "tcp-native"))


KINDS = ["hash", "file", "prefix", "tcp-native", "tcp-python"]


@pytest.mark.parametrize("kind", KINDS)
def test_same_values_as_reference(tmp_path, kind):
    got, want = _make(tstore, kind, tmp_path), _make(jstore, kind, tmp_path)
    try:
        ref = _script(want)
        assert _script(got) == ref
        # FileStore appends a tombstone and always reports a delete
        assert ref == WANT if kind != "file" else ref[:11] == WANT[:11]
    finally:
        for s in (got, want):
            if hasattr(s, "close"):
                s.close()


@pytest.mark.parametrize("kind", KINDS)
def test_wait_times_out(tmp_path, kind):
    s = _make(tstore, kind, tmp_path)
    try:
        with pytest.raises(tstore.StoreTimeoutError):
            s.wait(["missing"], timeout=0.2)
    finally:
        if hasattr(s, "close"):
            s.close()


def test_native_store_builds_into_the_port():
    assert _native.available(), "g++ should build the native core here"
    path = _native.library_path()
    assert path.is_file() and path.parent.name == "build"
    assert path.parent.parent.name == "pytorch_distributed_example_tpu_torch"
    m = tstore.TCPStore("127.0.0.1", 0, is_master=True, timeout=3.0)
    try:
        assert m.native and m.is_master
    finally:
        m.close()


def test_hash_store_blocking_get():
    s = tstore.HashStore(timeout=5.0)
    got = []
    t = threading.Thread(target=lambda: got.append(s.get("later")))
    t.start()
    s.set("later", b"now")
    t.join(2.0)
    assert not t.is_alive() and got == [b"now"]


def test_file_store_handles_share_state(tmp_path):
    a = tstore.FileStore(str(tmp_path / "fs"), timeout=2.0)
    b = tstore.FileStore(str(tmp_path / "fs"), timeout=2.0)
    a.set("x", b"1")
    assert b.get("x") == b"1"
    assert b.add("n", 2) == 2 and a.add("n", 3) == 5


def test_prefix_store_namespaces():
    base = tstore.HashStore(timeout=2.0)
    p1, p2 = tstore.PrefixStore("a", base), tstore.PrefixStore("b", base)
    p1.set("k", b"1")
    p2.set("k", b"2")
    assert (p1.get("k"), p2.get("k"), base.get("a/k")) == (b"1", b"2", b"1")


@pytest.mark.parametrize("native", [True, False])
def test_tcp_barrier_and_clients(native):
    master = tstore.TCPStore("127.0.0.1", 0, is_master=True, timeout=3.0, use_native=native)
    clients = [tstore.TCPStore("127.0.0.1", master.port, timeout=3.0) for _ in range(3)]
    try:
        done = []
        threads = [threading.Thread(target=lambda s=s, i=i: (s.barrier(4, tag="t"), done.append(i)))
                   for i, s in enumerate(clients)]
        for t in threads:
            t.start()
        master.barrier(4, tag="t")
        for t in threads:
            t.join(3.0)
        assert sorted(done) == [0, 1, 2]
        assert clients[0].add("ctr", 7) == 7 and master.add("ctr", 1) == 8
    finally:
        for c in clients:
            c.close()
        master.close()


@pytest.mark.parametrize("server_native", [True, False])
@pytest.mark.parametrize("client_native", [True, False])
@pytest.mark.parametrize("server_pkg", ["port", "reference"])
def test_wire_protocol_interoperates(server_pkg, server_native, client_native):
    """A client of one package against the other package's daemon."""
    smod, cmod = (tstore, jstore) if server_pkg == "port" else (jstore, tstore)
    master = smod.TCPStore("127.0.0.1", 0, is_master=True, timeout=3.0,
                           use_native=server_native)
    client = cmod.TCPStore("127.0.0.1", master.port, timeout=3.0, use_native=client_native)
    try:
        assert (master.native, client.native) == (server_native, client_native)
        master.set("from-master", b"m")
        assert client.get("from-master") == b"m"
        client.set("from-client", b"\x00binary\xff")
        assert master.get("from-client") == b"\x00binary\xff"
        assert client.add("ctr", 3) == 3 and master.add("ctr", 4) == 7
        assert client.compare_set("cas", "", "v") == b"v" == master.get("cas")
        assert client.check(["from-master", "cas"]) and not client.check(["nope"])
        assert client.delete_key("cas") and not master.check(["cas"])
        assert client.num_keys() == master.num_keys()
    finally:
        client.close()
        master.close()


# ---------------------------------------------------------------------------
# rendezvous
# ---------------------------------------------------------------------------


def test_tcp_rendezvous():
    store, rank, world = next(iter(rendezvous(f"tcp://127.0.0.1:{free_port()}?rank=0&world_size=1",
                                              timeout=5.0)))
    try:
        assert (rank, world) == (0, 1) and store.is_master
        store.set("z", b"3")
        assert store.get("z") == b"3"
    finally:
        store.close()


def test_env_rendezvous(monkeypatch):
    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("WORLD_SIZE", "1")
    monkeypatch.setenv("MASTER_ADDR", "127.0.0.1")
    monkeypatch.setenv("MASTER_PORT", "0")
    store, rank, world = next(iter(rendezvous("env://", timeout=5.0)))
    try:
        assert (rank, world) == (0, 1)
        store.set("y", b"2")
        assert store.get("y") == b"2"
    finally:
        store.close()


def test_file_rendezvous(tmp_path):
    store, rank, world = next(iter(rendezvous(f"file://{tmp_path}/rdzv?rank=1&world_size=2")))
    assert (rank, world) == (1, 2)
    store.set("x", b"1")
    assert store.get("x") == b"1"


def test_rendezvous_errors():
    with pytest.raises(RendezvousError):
        next(iter(rendezvous("bogus://x")))
    with pytest.raises(RendezvousError):
        next(iter(rendezvous("tcp://127.0.0.1:1")))  # no rank, no world size
    with pytest.raises(RendezvousError):
        register_rendezvous_handler("tcp", lambda *a, **k: None)
