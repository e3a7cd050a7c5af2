"""Device milliseconds a step in the projections' GEMMs: cuBLAS's and
CUTLASS's matrix kernels (and cuBLAS's split-K reductions) by name, over the
profiled steps."""

import re

PATTERN = re.compile(r"gemm|nvjet|cutlass|xmma|splitKreduce|gemv", re.IGNORECASE)
FLASH = re.compile(r"flash_(fwd|dkdv|dq)_")


def claims(name: str) -> bool:
    return bool(PATTERN.search(name)) and not FLASH.search(name)


def read(run):
    p = run.profile
    ms = p.device_ms(claims) if p else 0.0
    return ms / p.steps if ms > 0 else None
