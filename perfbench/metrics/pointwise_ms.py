"""Device milliseconds a step in every device operation that `gemm_ms`,
`flash_ms` and `adamw_ms` do not claim: norms, RoPE, SiLU and product, the
GQA copies, casts, the loss and its softmax, the embedding's gather and
scatter, copies and sets, over the profiled steps."""

from perfbench import spec

OTHERS = ("gemm_ms", "flash_ms", "adamw_ms")


def read(run):
    p = run.profile
    if p is None:
        return None
    others = [spec.metric_reader(n).claims for n in OTHERS]
    ms = p.device_ms(lambda name: not any(c(name) for c in others))
    return ms / p.steps if ms > 0 else None
