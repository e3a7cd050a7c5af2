"""ctypes loader for the native C++ core (`csrc/{store,reducer,flight_recorder}.cpp`).

Plays the role of torch's pybind11 surface (`_C/_distributed_c10d.pyi`)
with ctypes. At first use the three sources are compiled by the host's
`g++` into `build/libtdx_<hash>.so`, where the hash covers the sources and
the flags, as `ops/_build.py` keys the CUDA build: an edited source builds
anew, an unchanged one is loaded from the build directory. Without a host
compiler callers fall back to the pure-Python implementations (store.py,
flight_recorder.py), as the reference does; `TDX_NATIVE=0` forces that
fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional

logger = logging.getLogger(__name__)

PACKAGE = Path(__file__).resolve().parent
CSRC = PACKAGE / "csrc"
BUILD_DIR = PACKAGE / "build"
SOURCES = ("store.cpp", "reducer.cpp", "flight_recorder.cpp")
CXX_FLAGS = ("-O2", "-fPIC", "-std=c++17", "-Wall", "-pthread", "-shared")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False


def library_path() -> Path:
    """Where the native sources build to, keyed by the sources and flags."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    for name in SOURCES:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return BUILD_DIR / f"libtdx_{h.hexdigest()[:16]}.so"


def build() -> Optional[Path]:
    """Compile the sources unless their library is built; None without a
    host compiler or when the compiler fails (the failure is logged)."""
    out = library_path()
    if out.is_file():
        return out
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if cxx is None:
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
    cmd = [cxx, *CXX_FLAGS, "-o", str(tmp), *(str(CSRC / n) for n in SOURCES)]
    try:
        res = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    except (OSError, subprocess.TimeoutExpired):
        logger.warning("native build failed to run: %s", " ".join(cmd), exc_info=True)
        tmp.unlink(missing_ok=True)
        return None
    if res.returncode != 0:
        logger.warning("native build failed (exit %d): %s\n%s", res.returncode,
                       " ".join(cmd), res.stderr)
        tmp.unlink(missing_ok=True)
        return None
    os.replace(tmp, out)  # atomic: a concurrent build sees all or nothing
    return out


def load() -> Optional[ctypes.CDLL]:
    """Load (building if needed) the native library, or None."""
    global _lib, _tried
    if os.environ.get("TDX_NATIVE", "1") == "0":
        return None
    with _lock:
        if _tried:
            return _lib
        _tried = True
        path = build()
        if path is not None:
            _lib = _bind(ctypes.CDLL(str(path)))
        return _lib


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare ctypes signatures (the reference's `_native._bind`)."""
    lib.tdx_store_server_start.restype = ctypes.c_void_p
    lib.tdx_store_server_start.argtypes = [ctypes.c_char_p, ctypes.c_int]
    lib.tdx_store_server_port.restype = ctypes.c_int
    lib.tdx_store_server_port.argtypes = [ctypes.c_void_p]
    lib.tdx_store_server_stop.argtypes = [ctypes.c_void_p]
    lib.tdx_store_client_connect.restype = ctypes.c_void_p
    lib.tdx_store_client_connect.argtypes = [
        ctypes.c_char_p,
        ctypes.c_int,
        ctypes.c_double,
    ]
    lib.tdx_store_client_close.argtypes = [ctypes.c_void_p]
    lib.tdx_store_client_call.restype = ctypes.c_long
    lib.tdx_store_client_call.argtypes = [
        ctypes.c_void_p,
        ctypes.c_int,
        ctypes.c_char_p,
        ctypes.c_long,
        ctypes.c_char_p,
        ctypes.c_long,
        ctypes.c_double,
    ]
    lib.tdx_store_client_response.restype = ctypes.POINTER(ctypes.c_char)
    lib.tdx_store_client_response.argtypes = [ctypes.c_void_p]
    lib.tdx_compute_buckets.restype = ctypes.c_long
    lib.tdx_compute_buckets.argtypes = [
        ctypes.POINTER(ctypes.c_long),
        ctypes.c_long,
        ctypes.c_double,
        ctypes.c_double,
        ctypes.POINTER(ctypes.c_long),
    ]
    # reducer core (csrc/reducer.cpp), for the port's DDP
    PF = ctypes.POINTER(ctypes.c_float)
    lib.tdx_pack_f32.argtypes = [
        ctypes.POINTER(PF),
        ctypes.POINTER(ctypes.c_int64),
        ctypes.c_int64,
        PF,
    ]
    lib.tdx_unpack_f32.argtypes = [
        PF,
        ctypes.POINTER(ctypes.c_int64),
        ctypes.c_int64,
        ctypes.POINTER(PF),
    ]
    lib.tdx_count_nonfinite_f32.restype = ctypes.c_int64
    lib.tdx_count_nonfinite_f32.argtypes = [PF, ctypes.c_int64]
    # flight recorder (csrc/flight_recorder.cpp)
    lib.tdx_fr_create.restype = ctypes.c_void_p
    lib.tdx_fr_create.argtypes = [ctypes.c_int64]
    lib.tdx_fr_destroy.argtypes = [ctypes.c_void_p]
    lib.tdx_fr_record.argtypes = [
        ctypes.c_void_p,
        ctypes.c_int64,
        ctypes.c_char_p,
        ctypes.c_char_p,
        ctypes.c_char_p,
        ctypes.c_char_p,
        ctypes.c_int64,
        ctypes.c_double,
    ]
    lib.tdx_fr_complete.argtypes = [
        ctypes.c_void_p,
        ctypes.c_int64,
        ctypes.c_char_p,
        ctypes.c_int,
        ctypes.c_double,
    ]
    lib.tdx_fr_size.restype = ctypes.c_int64
    lib.tdx_fr_size.argtypes = [ctypes.c_void_p]
    # POINTER(c_char), not c_char_p: the raw pointer is kept to free it
    # after copying (heap-allocated per dump; see the .cpp)
    lib.tdx_fr_dump_json.restype = ctypes.POINTER(ctypes.c_char)
    lib.tdx_fr_dump_json.argtypes = [ctypes.c_void_p]
    lib.tdx_fr_dump_free.argtypes = [ctypes.POINTER(ctypes.c_char)]
    return lib


def available() -> bool:
    return load() is not None


def count_nonfinite(t) -> Optional[int]:
    """Native NaN/Inf count over a floating tensor (host copy, float32);
    None without the native library."""
    import torch

    lib = load()
    if lib is None:
        return None
    a = t.detach().to("cpu", torch.float32).contiguous().reshape(-1)
    ptr = ctypes.cast(a.data_ptr(), ctypes.POINTER(ctypes.c_float))
    return int(lib.tdx_count_nonfinite_f32(ptr, a.numel()))


class NativeFlightRecorder:
    """ctypes handle over the C++ ring buffer (csrc/flight_recorder.cpp)."""

    def __init__(self, capacity: int):
        lib = load()
        if lib is None:
            raise RuntimeError("native library unavailable")
        self._lib = lib
        self._h = lib.tdx_fr_create(int(capacity))

    def record(self, seq, op, group, shape, dtype, numel, ts):
        self._lib.tdx_fr_record(
            self._h,
            int(seq),
            str(op).encode(),
            str(group).encode(),
            str(tuple(shape)).encode(),
            str(dtype).encode(),
            int(numel),
            float(ts),
        )

    def complete(self, seq, group, failed, ts):
        self._lib.tdx_fr_complete(
            self._h, int(seq), str(group).encode(), 1 if failed else 0, float(ts)
        )

    def size(self) -> int:
        return int(self._lib.tdx_fr_size(self._h))

    def dump_entries(self):
        import json

        ptr = self._lib.tdx_fr_dump_json(self._h)
        try:
            raw = ctypes.string_at(ptr)
        finally:
            self._lib.tdx_fr_dump_free(ptr)
        return json.loads(raw.decode())

    def close(self):
        if self._h:
            self._lib.tdx_fr_destroy(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:  # a finalizer must not raise; the interpreter may be tearing down
            pass
