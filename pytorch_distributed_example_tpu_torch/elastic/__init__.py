"""The elastic agent and its launcher CLI (`run.py`), the port of the
reference's `elastic/`: `LocalElasticAgent` spawns, monitors, restarts and
resizes a gang of worker processes over the port's `TCPStore`."""

from .agent import (  # noqa: F401
    LocalElasticAgent,
    WorkerSpec,
    WorkerState,
    request_join,
    request_resize,
)
