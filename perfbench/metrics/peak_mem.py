"""GiB the card's caching allocator held at its peak over the window
(`torch.cuda.max_memory_allocated()` after `reset_peak_memory_stats()` at
the window's opening), read by the benchmark itself."""


def read(run):
    return None if run.peak_bytes is None else run.peak_bytes / 2 ** 30
