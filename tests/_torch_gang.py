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
