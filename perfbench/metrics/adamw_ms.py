"""Device milliseconds a step in `torch.optim.AdamW`'s update: its foreach
kernels (`multi_tensor_apply_kernel`), by name, over the profiled steps. No
other part of the step uses foreach kernels."""

import re

PATTERN = re.compile(r"multi_tensor_apply_kernel")


def claims(name: str) -> bool:
    return bool(PATTERN.search(name))


def read(run):
    p = run.profile
    ms = p.device_ms(claims) if p else 0.0
    return ms / p.steps if ms > 0 else None
