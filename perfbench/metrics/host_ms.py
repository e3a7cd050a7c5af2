"""Host milliseconds a `train_step` call takes, the call returning before
the device finishes: the mean over the window's unprofiled steps. Near the
step time, the host paces the device; far under it, the host has headroom."""


def read(run):
    times = run.window.host_step_s
    return sum(times) / len(times) * 1e3 if times else None
