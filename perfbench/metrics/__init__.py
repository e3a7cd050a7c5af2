"""Metrics: one reader a file, `read(run) -> float | None`, found by the
metric's name in `BENCHMARK.json` (`perfbench/metrics/<name>.py`), for the
end-to-end metrics of an untraced run and the per-layer metrics of a traced
one."""
