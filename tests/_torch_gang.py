"""Launch helpers for the port's CPU gang tests (gloo, one process a rank).

* `gang_port()`: a free TCP port below the kernel's ephemeral range. A
  port from `free_port()` (bind port 0, close) comes from that range, and
  between the close and the gang's rank 0 binding it, any bind(0) on the
  host (another gang's gloo listener or store daemon) may take it; the
  other ranks then dial that stranger. No kernel-chosen port is ever
  below the range.
* `gang_env()`: the worker environment with one OpenMP thread a rank, as
  torchrun sets it for several processes on a host: each rank's eight
  spinning OpenMP threads otherwise oversubscribe the cores the gang
  shares with its neighbours (a DDP gang took 32 s, 8 s with one thread).
"""

import random
import socket

from tests._mp_util import free_port, worker_env

_RANGE = "/proc/sys/net/ipv4/ip_local_port_range"


def gang_port() -> int:
    try:
        with open(_RANGE) as f:
            low = int(f.read().split()[0])
    except (OSError, ValueError, IndexError):
        return free_port()
    rng = random.SystemRandom()
    for _ in range(200):
        port = rng.randrange(max(1024, low - 8192), low)
        if 29400 <= port < 29600:  # torch's and the stores' default, 29500
            continue
        s = socket.socket()
        try:
            s.bind(("127.0.0.1", port))
        except OSError:
            continue
        finally:
            s.close()
        return port
    return free_port()


def gang_env() -> dict:
    return {**worker_env(), "OMP_NUM_THREADS": "1"}


def run_gang(module: str, tmp_path, world: int, extra_env=None, timeout: float = 120.0,
             args=()):
    """Run `module`'s `gang(rank, world, *args)` as ranks 0..world-1 of one
    gloo gang on the CPU (`tests/_torch_mp_worker.py`). Returns (return
    codes, outputs, results by rank: each rank's pickled dict, or None)."""
    import os
    import pickle
    import subprocess
    import sys

    from tests._mp_util import REPO

    port = gang_port()
    env = {**gang_env(), **(extra_env or {})}
    outs = [os.path.join(str(tmp_path), f"{module.rsplit('.', 1)[-1]}_{world}_{r}.pkl")
            for r in range(world)]
    procs = [subprocess.Popen([sys.executable, "-m", "tests._torch_mp_worker", module, str(r),
                               str(world), str(port), outs[r], *map(str, args)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env, cwd=REPO)
             for r in range(world)]
    texts = []
    try:
        for p in procs:
            texts.append(p.communicate(timeout=timeout)[0].decode())
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    results = []
    for path in outs:
        if os.path.exists(path):
            with open(path, "rb") as f:
                results.append(pickle.load(f))
        else:
            results.append(None)
    return [p.returncode for p in procs], texts, results
