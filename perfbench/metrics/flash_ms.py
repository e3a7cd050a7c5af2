"""Device milliseconds a step in the port's flash attention kernels
(`csrc/flash_wgmma.cuh`, `csrc/flash_tf32x3.cuh`: forward, dK/dV and dQ),
by name, over the profiled steps."""

import re

PATTERN = re.compile(r"\b(flash_fwd|flash_dkdv|flash_dq)_(wgmma|tf32x3)")


def claims(name: str) -> bool:
    return bool(PATTERN.search(name))


def read(run):
    p = run.profile
    ms = p.device_ms(claims) if p else 0.0
    return ms / p.steps if ms > 0 else None
