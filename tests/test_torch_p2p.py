"""The port's direct p2p data plane (`p2p.py`) against the JAX package's.

* Wire format across packages: the reference's `P2PPlane` and the port's
  exchange frames in both directions over one store (float32 and integer
  arrays, pickled objects; any-source receives), as the two packages'
  store daemons serve each other's clients. The port's bf16 travels as
  raw 16-bit words named "bfloat16", which the reference reads as its
  ml_dtypes bf16; the reference's own plane cannot send a bf16 array
  (the test pins that quirk).
* The caps, checked before any allocation: a route, dtype or rank over
  its cap, a tag or seq that does not fit, and a payload over
  `TDX_P2P_MAX_MSG` are refused on send; a malformed header from a raw
  socket makes the reader drop the connection without allocating.
* The `"none"` endpoint: an opted-out plane publishes it, and `close()`
  tombstones a listening plane's endpoint.
* A gloo gang of two processes (`tests/_torch_mp_planner.py`): send/recv,
  recv(src=None), isend/irecv, batch_isend_irecv, the object lists and
  `permute` through the plane, and the same through the store path with
  `TDX_P2P_PLANE=0`.
"""

import socket
import threading

import ml_dtypes
import numpy as np
import pytest
import torch

from pytorch_distributed_example_tpu import p2p as jp2p
from pytorch_distributed_example_tpu_torch import p2p
from pytorch_distributed_example_tpu_torch.store import HashStore
from tests._torch_gang import run_gang


@pytest.fixture
def pair():
    st = HashStore(30.0)
    port = p2p.P2PPlane(0, st, advertise="127.0.0.1").start()
    ref = jp2p.P2PPlane(1, st, advertise="127.0.0.1").start()
    yield port, ref
    port.close()
    ref.close()


def test_wire_constants_are_the_references():
    assert p2p._HELLO.format == jp2p._HELLO.format
    assert p2p._FHDR.format == jp2p._FHDR.format
    assert p2p._DIM.format == jp2p._DIM.format
    assert (p2p._MAX_ROUTE, p2p._MAX_DTYPE, p2p._MAX_NDIM, p2p._NONE_EP) == (
        jp2p._MAX_ROUTE, jp2p._MAX_DTYPE, jp2p._MAX_NDIM, jp2p._NONE_EP)
    hdr = p2p._pack_frame_header("r/1", 3, 9, "nd", "float32", (2, 5), 40)
    assert hdr == jp2p._pack_frame_header("r/1", 3, 9, "nd", "float32", (2, 5), 40)


def test_port_to_reference(pair):
    port, ref = pair
    f32 = torch.randn(3, 4)
    bf = torch.randn(7).bfloat16()
    port.send(1, "x", 0, 0, f32, 10.0)
    port.send(1, "x", 0, 1, bf, 10.0)
    port.send(1, "x", 2, 0, torch.arange(5), 10.0)
    port.send(1, "x", 0, 2, {"k": [1, 2]}, 10.0)
    np.testing.assert_array_equal(ref.recv(0, "x", 0, 0, 10.0), f32.numpy())
    got = ref.recv(0, "x", 0, 1, 10.0)
    assert got.dtype == ml_dtypes.bfloat16
    assert got.view(np.int16).tobytes() == bf.view(torch.int16).numpy().tobytes()
    src, val = ref.recv_any([(0, 0)], "x", 2, 10.0)
    assert src == 0 and val.tolist() == [0, 1, 2, 3, 4]
    assert ref.recv(0, "x", 0, 2, 10.0) == {"k": [1, 2]}
    assert port.frames_sent == 4


def test_reference_to_port(pair):
    port, ref = pair
    a = np.random.default_rng(0).standard_normal((2, 3)).astype(np.float32)
    ref.send(0, "y", 1, 0, a, 10.0)
    ref.send(0, "y", 1, 1, np.arange(6, dtype=np.int16), 10.0)
    ref.send(0, "y", 1, 2, ("obj", 3), 10.0)
    got = port.recv(1, "y", 1, 0, 10.0)
    assert isinstance(got, torch.Tensor) and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), a)
    got = port.recv(1, "y", 1, 1, 10.0)
    assert got.dtype == torch.int16 and got.tolist() == list(range(6))
    assert port.recv(1, "y", 1, 2, 10.0) == ("obj", 3)
    assert port.frames_received == 3
    # the reference's own plane cannot send an ml_dtypes bf16 array (a
    # memoryview refuses its dtype), so bf16 crosses port -> reference only
    with pytest.raises(ValueError):
        ref.send(0, "y", 1, 3, np.zeros(2, ml_dtypes.bfloat16), 10.0)


@pytest.mark.parametrize("kw,match", [
    (dict(route="r" * 1025), "metadata too large"),
    (dict(dtype="d" * 65), "metadata too large"),
    (dict(shape=(1,) * 33), "metadata too large"),
    (dict(tag=2 ** 31), "int32"),
    (dict(seq=2 ** 63), "int64"),
    (dict(plen=(4 << 30) + 1), "TDX_P2P_MAX_MSG"),
])
def test_caps_refused_on_send(kw, match):
    args = dict(route="r", tag=0, seq=0, kind="nd", dtype="float32", shape=(2,), plen=8)
    args.update(kw)
    for mod in (p2p, jp2p):
        with pytest.raises(ValueError, match=match):
            mod._pack_frame_header(**args)


def test_malformed_header_drops_the_connection():
    st = HashStore(30.0)
    plane = p2p.P2PPlane(0, st, advertise="127.0.0.1").start()
    try:
        ep = plane.endpoint_of(0, 5.0)
        s = socket.create_connection(ep)
        s.sendall(p2p._HELLO.pack(1))
        # a route length over the cap: refused before any allocation
        s.sendall(p2p._FHDR.pack(60000, 0, 0, 0, 0, 0, 8))
        s.settimeout(5.0)
        assert s.recv(1) == b""  # the reader closed it
        s.close()
        with pytest.raises(TimeoutError):
            plane.recv(1, "r", 0, 0, 0.2)
    finally:
        plane.close()


def test_opted_out_plane_publishes_none_and_close_tombstones():
    st = HashStore(30.0)
    off = p2p.P2PPlane(0, st, enabled=False).start()
    on = p2p.P2PPlane(1, st, advertise="127.0.0.1").start()
    assert not off.listening and on.endpoint_of(0, 5.0) is None
    with pytest.raises(RuntimeError, match="store path only"):
        on.send(0, "r", 0, 0, torch.zeros(2), 5.0)
    assert off.endpoint_of(1, 5.0) is not None
    on.close()
    assert st.get("ep/1") == p2p._NONE_EP
    with pytest.raises(p2p.PlaneClosed):
        on.recv(0, "r", 0, 0, 1.0)
    off.close()


def test_backpressure_parks_the_reader_and_drains(monkeypatch):
    monkeypatch.setattr(p2p, "_INBOX_HWM", 1024)
    st = HashStore(30.0)
    a = p2p.P2PPlane(0, st, advertise="127.0.0.1").start()
    b = p2p.P2PPlane(1, st, advertise="127.0.0.1").start()
    try:
        frames = [torch.full((512,), float(i)) for i in range(6)]  # 2 KiB each
        t = threading.Thread(target=lambda: [a.send(1, "bp", 0, i, f, 10.0)
                                             for i, f in enumerate(frames)])
        t.start()
        got = [b.recv(0, "bp", 0, i, 10.0) for i in range(6)]
        t.join(10.0)
        assert not t.is_alive()
        assert all(torch.equal(g, f) for g, f in zip(got, frames))
    finally:
        a.close()
        b.close()


@pytest.mark.parametrize("plane_on", [True, False])
def test_gang_point_to_point(tmp_path, plane_on):
    env = {} if plane_on else {"TDX_P2P_PLANE": "0"}
    rcs, outs, res = run_gang("tests._torch_mp_planner", tmp_path, 2, extra_env=env,
                              args=("p2p",))
    assert rcs == [0, 0], "\n".join(outs)
    r0, r1 = res
    assert r0["listening"] == r1["listening"] == plane_on
    assert r1["src"] == 0 and r1["any_src"] == 0
    assert torch.equal(r1["f32"], torch.arange(12, dtype=torch.float32).reshape(3, 4))
    assert torch.equal(r1["bf16"], (torch.arange(6, dtype=torch.float32) / 3).bfloat16())
    assert r1["int"].tolist() == [7, 8, 9]
    assert r0["batch"].tolist() == [1.0] * 5 and r1["batch"].tolist() == [0.0] * 5
    assert r1["objects"] == [{"a": 1}, "two"]
    assert r0["permuted"].tolist() == [1.0] * 4 and r1["permuted"].tolist() == [0.0] * 4
    # every p2p byte rode the plane, or none did
    assert (sum(r0["frames"]) > 0) == plane_on and (sum(r1["frames"]) > 0) == plane_on
