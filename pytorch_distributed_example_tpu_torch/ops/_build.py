"""Build the package's CUDA sources into shared libraries and load them.

Each `csrc/<name>.cu` is compiled by `nvcc` for sm_90a into
`build/lib<name>_<hash>.so`, with a plain C interface, and loaded with
`ctypes`. The hash covers the sources and the flags, so an edited source
builds anew and an unchanged one is loaded from the build directory. The
build happens at first use, never at import. `ptxas -v` (registers, shared
memory, spills per kernel) is kept beside the library as `<same name>.log`.

There is no fallback: without `nvcc`, or on a card other than sm_90, this
raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

PACKAGE = Path(__file__).resolve().parent.parent
CSRC = PACKAGE / "csrc"
BUILD_DIR = PACKAGE / "build"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
    # the optimizer and ptxas spread the instances over every core: on the
    # 8-core host of an H100 80GB HBM3 the flash library built in 7.0 s
    # instead of 16.0 (chip_smoke.py's [build] line), with the same ptxas
    # report (registers, spills, barriers) for every instance
    "-split-compile=0", "-Xptxas", "--split-compile=0",
)

_loaded: dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    """Path of `nvcc`: on PATH, else under CUDA_HOME or /usr/local/cuda."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.is_file():
        return str(cand)
    raise RuntimeError(
        "nvcc not found (searched PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): "
        "the Hopper kernels are built from csrc/ at first use and need the "
        "CUDA toolkit"
    )


def check_device(device=None) -> None:
    """Raise unless `device` (default: the current one) is an sm_90 card."""
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the Hopper kernels need an H100")
    cap = torch.cuda.get_device_capability(device)
    if cap != (9, 0):
        raise RuntimeError(
            f"the kernels are built for sm_90a (Hopper); "
            f"{torch.cuda.get_device_name(device)} is sm_{cap[0]}{cap[1]}"
        )


def library_path(name: str) -> Path:
    """Where `csrc/<name>.cu` builds to, keyed by the sources and flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu*")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"lib{name}_{h.hexdigest()[:16]}.so"


def build(name: str) -> Path:
    """Compile `csrc/<name>.cu` unless its library is already built."""
    out = library_path(name)
    if out.is_file():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
    cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed building {name} (exit {res.returncode}):\n"
            f"{' '.join(cmd)}\n{res.stdout}{res.stderr}"
        )
    out.with_suffix(".log").write_text(res.stdout + res.stderr)
    os.replace(tmp, out)  # atomic: a concurrent build sees all or nothing
    return out


def build_log(name: str) -> str:
    """What ptxas reported for the current build of `name`."""
    return library_path(name).with_suffix(".log").read_text()


def load(name: str, signatures: dict) -> ctypes.CDLL:
    """The loaded library of `csrc/<name>.cu`, built first if needed.

    `signatures` maps each C function to `(argtypes, restype)`; they are
    declared on first load, so that ctypes passes every pointer whole."""
    lib = _loaded.get(name)
    if lib is None:
        check_device()
        lib = ctypes.CDLL(str(build(name)))
        for fn, (argtypes, restype) in signatures.items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = restype
        _loaded[name] = lib
    return lib
