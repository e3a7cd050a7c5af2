"""The readers on a canned profiler trace and window, and the breakdown."""

import json

import pytest

from perfbench import spec, trace

STEPS = 2
KERNELS = [  # (cat, name, ts µs, dur µs)
    ("gpu_memcpy", "Memcpy HtoD (Pageable -> Device)", 1000, 50),
    ("kernel", "nvjet_tst_256x128_64x4_1x2_h_bz_coopA_NNT", 1100, 2000),
    ("kernel", "void flash_wgmma::flash_fwd_wgmma_kernel<__nv_bfloat16, 128>(CUtensorMap_st)",
     3200, 1000),
    ("kernel", "void flash_wgmma::flash_dkdv_wgmma_kernel<128>(CUtensorMap_st)", 4300, 1500),
    ("kernel", "void flash_wgmma::flash_dq_wgmma_kernel<128>(CUtensorMap_st)", 5900, 1200),
    ("kernel", "void at::native::(anonymous namespace)::multi_tensor_apply_kernel<at::native::"
               "(anonymous namespace)::TensorListMetadata<4>>", 7200, 800),
    ("kernel", "void at::native::vectorized_elementwise_kernel<4, at::native::MulFunctor>",
     8100, 500),
    ("kernel", "nvjet_tst_256x128_64x4_1x2_h_bz_coopA_NNT", 20000, 999),  # after the span
]
HOST = [
    ("cpu_op", "aten::mm", 1050, 100),
    ("cuda_runtime", "cudaLaunchKernel", 1060, 10),
    ("cuda_runtime", "cudaStreamSynchronize", 8550, 2400),
]
BOUNDS = {"flash_fwd": 0.5, "flash_dkdv": 0.6, "flash_dq": 0.3}


def events():
    ev = [{"ph": "X", "cat": "user_annotation", "name": trace.MARKER, "ts": 1000, "dur": 10000}]
    ev += [{"ph": "X", "cat": c, "name": n, "ts": t, "dur": d} for c, n, t, d in KERNELS + HOST]
    ev.append({"ph": "i", "cat": "cpu_instant_event", "name": "marker", "ts": 1500})
    return ev


@pytest.fixture
def traced_run():
    window = trace.Window(steps=10, wall_s=1.0, host_step_s=[0.01, 0.03], tokens_per_step=8)
    return trace.Run(window, trace.profile_from_events(events(), STEPS), step_flops=1e12,
                     peak_flops=1e14, kernel_bound_ms=BOUNDS)


def read(name, run):
    return spec.metric_reader(name).read(run)


def test_device_ms_readers(traced_run):
    assert read("gemm_ms", traced_run) == pytest.approx(2.0 / STEPS)
    assert read("flash_ms", traced_run) == pytest.approx((1.0 + 1.5 + 1.2) / STEPS)
    assert read("adamw_ms", traced_run) == pytest.approx(0.8 / STEPS)
    # what no other reader claims: the elementwise kernel and the copy
    assert read("pointwise_ms", traced_run) == pytest.approx((0.5 + 0.05) / STEPS)


def test_layers_add_up_to_the_busy_time(traced_run):
    parts = sum(read(n, traced_run) for n in ("gemm_ms", "flash_ms", "adamw_ms", "pointwise_ms"))
    assert parts * STEPS == pytest.approx(traced_run.profile.busy_s() * 1e3)


def test_flash_roofline(traced_run):
    assert read("flash_roofline", traced_run) == pytest.approx(100 * 1.4 / 3.7)


def test_device_idle(traced_run):
    busy = 50 + 2000 + 1000 + 1500 + 1200 + 800 + 500
    assert read("device_idle", traced_run) == pytest.approx(100 * (1 - busy / 10000))


def test_host_clock_readers(traced_run):
    assert read("host_ms", traced_run) == pytest.approx(20.0)
    assert read("step_mfu", traced_run) == pytest.approx(100 * 1e12 * 10 / 1.0 / 1e14)


def test_end_to_end_readers(traced_run):
    run = trace.Run(traced_run.window, None, 1e12, 1e14, None, setup_s=12.5,
                    peak_bytes=3 * 2 ** 30)
    assert read("train_tokens_per_s", run) == pytest.approx(10 * 8 / 1.0)
    assert read("peak_mem", run) == pytest.approx(3.0)
    assert read("setup_s", run) == 12.5
    empty = trace.Run(trace.Window(0, 0.0, [], 8), None, 1e12, 1e14, None)
    for name in ("train_tokens_per_s", "peak_mem", "setup_s"):
        assert read(name, empty) is None


def test_readers_find_nothing_without_a_trace(traced_run):
    untraced = trace.Run(traced_run.window, None, 1e12, 1e14, BOUNDS)
    for name in ("gemm_ms", "flash_ms", "adamw_ms", "pointwise_ms", "flash_roofline",
                 "device_idle"):
        assert read(name, untraced) is None
    no_peak = trace.Run(traced_run.window, traced_run.profile, 1e12, None, None)
    assert read("step_mfu", no_peak) is None
    assert read("flash_roofline", no_peak) is None


def test_no_flash_kernel_gives_no_roofline(traced_run):
    ev = [e for e in events() if "flash_" not in e["name"]]
    run = trace.Run(traced_run.window, trace.profile_from_events(ev, STEPS), 1e12, 1e14, BOUNDS)
    assert read("flash_ms", run) is None
    assert read("flash_roofline", run) is None


def test_breakdown(traced_run):
    b = trace.breakdown(traced_run.profile)
    assert set(b) == {"device_ops", "idle_gaps"}
    assert len(b["device_ops"]) <= 10 and len(b["idle_gaps"]) <= 10
    assert b["device_ops"][0] == [KERNELS[1][1], pytest.approx(2000e-6)]
    # the longest gap runs from the last kernel's end to the span's close,
    # while the host waits in a synchronise
    assert b["idle_gaps"][0] == ["cudaStreamSynchronize", pytest.approx(2400e-6)]
    json.dumps(b)


def test_load_profile_reads_a_chrome_trace(tmp_path):
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": events()}))
    p = trace.load_profile(str(path), STEPS)
    assert len(p.device_ops) == len(KERNELS) - 1
    assert p.span_s == pytest.approx(0.01)


def test_one_marker_span_is_required():
    with pytest.raises(ValueError):
        trace.profile_from_events([e for e in events() if e["name"] != trace.MARKER], STEPS)
