"""DDP's component times and the host bucket path, against the reference.

* The reference's `TestProfilingTier` on the port's ConvNet at world 2 in
  driver mode: step timing from the train step, `profile_breakdown`'s
  five times (which leave the instance's params bit for bit) filling the
  logger's component times, whose `get_ddp_logging_data()` keys are the
  reference's, and its raw clocks, of which the five are the clamped
  differences; a 2-process gloo gang clocks each process's row
  (`tests/_torch_mp_profile.py`).
* The reference's `tests/test_reducer.py` bucket cases and
  `tests/test_native.py` host-bucket and reducer-core cases: the port's
  Python planner gives the reference's buckets, and its numpy host buckets
  flatten and unflatten to the reference's arrays (fresh arrays, `()` and
  zero-size shapes), with the reference's native library and without it
  (`TDX_NATIVE=0`). `Reducer.reduce_dist_tensors` reduces in place as the
  reference's does, at world 8.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import pytorch_distributed_example_tpu as jtdx
import pytorch_distributed_example_tpu_torch as tdx
from pytorch_distributed_example_tpu import _native as jnative
from pytorch_distributed_example_tpu.models import ConvNet as JConvNet
from pytorch_distributed_example_tpu.parallel import reducer as jreducer
from pytorch_distributed_example_tpu_torch import optim
from pytorch_distributed_example_tpu_torch.models import ConvNet
from pytorch_distributed_example_tpu_torch.parallel import comm_hooks
from pytorch_distributed_example_tpu_torch.parallel import reducer
from tests import _ddp_cases as cases
from tests._torch_gang import run_gang

W = 2
MB = 1024 * 1024
TIMES = ("forward_s", "backward_s", "optimizer_s", "comm_exposed_s", "full_step_s")
COMPONENTS = ("avg_forward_compute_time_s", "avg_backward_compute_time_s",
              "avg_backward_comm_time_s", "avg_optimizer_time_s")


@pytest.fixture
def port2():
    pg = tdx.init_process_group(world_size=W, device="cpu")
    yield pg
    tdx.destroy_process_group()


def _setup():
    model = ConvNet(device="cpu", generator=torch.Generator().manual_seed(0))
    ddp = tdx.DistributedDataParallel(model)
    x, y = cases.global_batch(W)
    return (ddp, optim.sgd(0.05), torch.from_numpy(x.transpose(0, 3, 1, 2).copy()),
            torch.from_numpy(y).long())


def test_step_timing_recorded_by_train_step(port2):
    ddp, opt, x, y = _setup()
    step = ddp.make_train_step(opt, F.cross_entropy)
    ddp.logger.enable_step_timing()
    p, o = ddp.params, opt.init(ddp.params)
    for _ in range(3):
        p, o, _ = step(p, o, x, y)
    data = ddp.get_ddp_logging_data()
    assert data["num_steps"] == 3
    assert data["avg_step_time_s"] > 0


def test_profile_breakdown_fills_component_times(port2):
    ddp, opt, x, y = _setup()
    data = ddp.get_ddp_logging_data()
    assert all(data[k] == 0.0 for k in COMPONENTS)
    before = {n: p.clone() for n, p in ddp.params.items()}
    out = ddp.profile_breakdown(opt, F.cross_entropy, x, y, iters=3)
    assert tuple(out) == TIMES
    assert all(np.isfinite(v) and v >= 0 for v in out.values())
    data = ddp.get_ddp_logging_data()
    assert data["avg_forward_compute_time_s"] > 0
    assert data["avg_backward_compute_time_s"] > 0
    assert out["full_step_s"] > 0
    # components are a decomposition: each <= the full step
    assert out["forward_s"] <= out["full_step_s"] * 1.5
    assert [data[k] for k in COMPONENTS] == [out["forward_s"], out["backward_s"],
                                            out["comm_exposed_s"], out["optimizer_s"]]
    assert all(torch.equal(before[n], ddp.params[n]) for n in before)
    assert data["num_steps"] == 0  # the clocks' steps are not the instance's


def test_profile_breakdown_keeps_its_raw_clocks(port2):
    """The five times are the raw clocks' differences clamped at 0, and
    each clock is the median of `iters` calls made in turn with the other
    three: every round calls forward, forward+backward, the no-op step and
    the full step, in that order."""
    ddp, opt, x, y = _setup()
    assert ddp.breakdown_clocks_s == {}
    order = []
    make = ddp.make_train_step

    def spying(optimizer, loss_fn, **kw):
        step = make(optimizer, loss_fn, **kw)
        tag = "noop" if kw.get("comm_hook") is comm_hooks.noop_hook else "full"
        grads = step.local_grads

        def counted(*a, **k):
            out = step(*a, **k)
            order.append(tag)
            return out

        def local_grads(*a):
            order.append("fb")
            return grads(*a)

        counted.local_grads = local_grads
        return counted

    ddp.make_train_step = spying
    out = ddp.profile_breakdown(opt, F.cross_entropy, x, y, iters=3)
    assert order == ["fb", "noop", "full"] * 5
    c = ddp.breakdown_clocks_s
    assert out["forward_s"] == c["forward"] and out["full_step_s"] == c["full_step"]
    for key, raw in (("backward_s", "backward"), ("optimizer_s", "optimizer"),
                     ("comm_exposed_s", "comm_exposed")):
        assert out[key] == max(c[raw], 0.0)
    assert c["backward"] == c["forward_backward"] - c["forward"]
    assert c["optimizer"] == c["noop_step"] - c["forward_backward"]
    assert c["comm_exposed"] == c["full_step"] - c["noop_step"]


def test_profile_breakdown_with_a_stateful_hook(port2):
    ddp, opt, x, y = _setup()
    ddp.register_comm_hook(None, comm_hooks.PowerSGDHook(rank=1))
    out = ddp.profile_breakdown(optim.adam(1e-3), F.cross_entropy, x, y, iters=1)
    assert all(np.isfinite(v) and v >= 0 for v in out.values())


def test_logging_data_keys_are_the_references(world, port2):
    ddp, opt, x, y = _setup()
    ddp.profile_breakdown(opt, F.cross_entropy, x, y, iters=1)
    jparams = JConvNet().init(jax.random.PRNGKey(0), jnp.zeros((1, 28, 28, 1)))
    jddp = jtdx.DistributedDataParallel(JConvNet(), jparams)
    want = jddp.get_ddp_logging_data()
    got = ddp.get_ddp_logging_data()
    assert sorted(got) == sorted(want)
    assert all(want[k] == 0.0 for k in COMPONENTS)


def test_profiler_trace_context_writes_trace(port2, tmp_path):
    ddp, opt, x, y = _setup()
    step = ddp.make_train_step(opt, F.cross_entropy)
    with ddp.logger.profiler_trace(str(tmp_path / "trace")):
        step(ddp.params, opt.init(ddp.params), x, y)
    assert list((tmp_path / "trace").glob("*"))


def test_gang_profiles_each_process_and_falls_back(tmp_path):
    """Multiproc mode: each process of a 2-process gloo gang clocks its own
    row and leaves its params unchanged; adafactor's ZeRO fallback warns
    once in each and gives the "off" run's params bit for bit."""
    rcs, texts, results = run_gang("tests._torch_mp_profile", tmp_path, W)
    assert rcs == [0, 0], texts
    for res in results:
        assert tuple(res["times"]) == TIMES
        assert all(np.isfinite(v) and v >= 0 for v in res["times"].values())
        assert res["times"]["forward_s"] > 0 and res["times"]["full_step_s"] > 0
        assert res["logging"]["avg_forward_compute_time_s"] == res["times"]["forward_s"]
        assert res["unchanged"] and res["bitwise"]
        assert res["fallback_warned"] == 1 and not res["sharded"]
    assert [r["logging"]["rank"] for r in results] == [0, 1]


# -- bucket assignment (the reference's tests/test_reducer.py) --------------

@pytest.fixture(params=["native", "python"])
def ref_native(request, monkeypatch):
    """The reference with its native library and without it: the port's
    Python and numpy paths answer both."""
    if request.param == "python":
        monkeypatch.setenv("TDX_NATIVE", "0")
    elif not jnative.available():
        pytest.skip("the reference's libtdx is not built")
    return request.param


def test_first_bucket_smaller(ref_native):
    sizes = [MB // 2, MB // 2, MB // 2, 10 * MB, 10 * MB, 10 * MB, 10 * MB]
    buckets = reducer.compute_bucket_assignment_by_size(sizes)
    assert buckets[0] == [0, 1]
    assert [i for b in buckets for i in b] == list(range(len(sizes)))
    for b in buckets[1:]:
        assert sum(sizes[i] for i in b) <= 25 * MB
    assert buckets == jreducer.compute_bucket_assignment_by_size(sizes)


def test_oversize_leaf_gets_own_bucket():
    assert reducer.compute_bucket_assignment_by_size([30 * MB, 30 * MB]) == [[0], [1]]


def test_single_small():
    assert reducer.compute_bucket_assignment_by_size([100]) == [[0]]
    assert reducer.compute_bucket_assignment_by_size([]) == []


@pytest.mark.parametrize("seed", range(3))
def test_buckets_match_the_references(seed, ref_native):
    gen = np.random.default_rng(seed)
    sizes = [int(v) for v in gen.integers(0, 6 * MB, 200)]
    caps = (float(gen.integers(1, 30)) * MB, float(gen.integers(1, 4)) * MB)
    got = reducer.compute_bucket_assignment_by_size(sizes, *caps)
    assert got == jreducer.compute_bucket_assignment_by_size(sizes, *caps)
    assert [i for b in got for i in b] == list(range(len(sizes)))


# -- host buckets (the reference's tests/test_native.py) ---------------------

SHAPES = [(5, 5), (3,), (), (0,), (2, 0, 3), (2, 4)]


def _leaves(seed=2):
    gen = np.random.default_rng(seed)
    return [gen.standard_normal(s).astype(np.float32) for s in SHAPES]


def test_flatten_unflatten(ref_native):
    leaves = _leaves()
    flat = reducer.flatten_host_bucket(leaves)
    want = jreducer.flatten_host_bucket(leaves)
    assert flat.dtype == np.float32 and flat.shape == (37,)
    np.testing.assert_array_equal(flat, want)
    back = reducer.unflatten_host_bucket(flat, SHAPES)
    for a, b, r, s in zip(back, leaves, jreducer.unflatten_host_bucket(flat, SHAPES), SHAPES):
        assert a.shape == s == r.shape and a.dtype == np.float32
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, r)
    back[0][0, 0] = 123.0  # fresh arrays: the flat buffer is not a view's base
    assert flat[0] != 123.0
    ints = reducer.flatten_host_bucket([np.arange(4, dtype=np.int64)])
    assert ints.dtype == np.float32 and ints.tolist() == [0.0, 1.0, 2.0, 3.0]


def test_large_bucket_matches_the_references(ref_native):
    """A leaf above the reference's multithreaded-copy threshold."""
    big = np.random.default_rng(1).standard_normal((1 << 21,)).astype(np.float32)
    flat = reducer.flatten_host_bucket([big, big[:17]])
    np.testing.assert_array_equal(flat, jreducer.flatten_host_bucket([big, big[:17]]))
    head, tail = reducer.unflatten_host_bucket(flat, [big.shape, (17,)])
    np.testing.assert_array_equal(head, big)
    np.testing.assert_array_equal(tail, big[:17])


def test_reduce_dist_tensors_in_place(world):
    """At world 8: two rank-stacked leaves, reduced in place through the
    port's Reducer, as the reference's Reducer reduces its DistTensors."""
    gen = np.random.default_rng(4)
    leaves = [gen.standard_normal((8,) + s).astype(np.float32) for s in [(3, 2), (5,)]]
    jdts = [jtdx.DistTensor.from_rank_fn(lambda r, a=a: a[r]) for a in leaves]
    jreducer.Reducer(bucket_cap_mb=1e-5, first_bucket_bytes=16).reduce_dist_tensors(jdts)
    tdx.init_process_group(world_size=8, device="cpu")
    try:
        dts = [tdx.DistTensor.from_rank_fn(lambda r, a=a: torch.from_numpy(a[r])) for a in leaves]
        red = reducer.Reducer(bucket_cap_mb=1e-5, first_bucket_bytes=16)
        before = [dt.tensor for dt in dts]
        red.reduce_dist_tensors(dts, require_sync=False)  # no_sync: nothing moves
        assert all(dt.tensor is t for dt, t in zip(dts, before))
        red.reduce_dist_tensors(dts)
        assert red.stats["reduce_calls"] == 1 and red.stats["num_buckets"] == 2
    finally:
        tdx.destroy_process_group()
    for dt, jdt, a in zip(dts, jdts, leaves):
        np.testing.assert_allclose(dt.tensor.numpy(), np.asarray(jdt.array), rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(dt.tensor.numpy()[3], a.mean(0), rtol=1e-5, atol=1e-6)

