"""The planner's schedule artifacts, as far as the port has them.

`topology.py` (the host grouping of a gang), `schedules.py` (the
deterministic `Plan` / `Round` / `Step` artifacts and their
fingerprints) and `transfer.py` (the KV-migration chunk schedule the
disaggregated serve plane publishes in): copies of the reference's
modules. The collective planner itself (`probe`, `planner`, `driver`,
`executor`, `traced`) is still to come (ROADMAP.md, Queue 1 item 4).
"""

from __future__ import annotations

from . import schedules, topology, transfer  # noqa: F401
from .schedules import Plan, Round, Step  # noqa: F401
from .topology import Topology  # noqa: F401
from .transfer import chunk_spans, schedule_migration  # noqa: F401

__all__ = ["Plan", "Round", "Step", "Topology", "chunk_spans", "schedule_migration"]
