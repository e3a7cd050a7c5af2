"""The port's Hopper kernels on the card, against their plain versions.

Marked `cuda`: each test skips without a card. This file imports neither
JAX nor the JAX package, so it runs where only PyTorch is installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

(`--noconftest` because the repository's conftest pins JAX to the CPU.)
"""

import importlib

import numpy as np
import pytest
import torch

from pytorch_distributed_example_tpu_torch.dtensor import DTensor
from pytorch_distributed_example_tpu_torch.examples import lm
from pytorch_distributed_example_tpu_torch.ops import dense_attention
from pytorch_distributed_example_tpu_torch.parallel import context_parallel as tcp

tfa = importlib.import_module("pytorch_distributed_example_tpu_torch.ops.flash_attention")


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run with -m cuda on the H100)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


# On the SIMT route kernel and plain version both compute in float32 from the
# same operands, in another order; bf16 outputs then round once more on each
# side (2**-8 relative each), so bf16 is held to rtol 2**-7 and an atol of
# 1e-3 of the plain output's largest entry, as chip_smoke.py holds it. The
# wgmma route (bf16 at D 64 and 128) also rounds P and dS to bf16, and is held
# to the tolerance declared with it, `WGMMA_BF16_TOL`.
_F32_TOL = dict(rtol=1e-4, atol=1e-5)
# float32 against the CPU path: the same arithmetic in another order on both
# sides, the atol a share of the largest entry, as chip_smoke.py's F32_TOL
_F32_ATOL_FRAC = 1e-5


def _assert_close(got, want, dtype, msg=None, D=None):
    got, want = got.float(), want.float()
    top = float(want.abs().max())
    if D is not None and tfa.kernel_route(dtype, D) == "wgmma":
        tol = dict(rtol=tfa.WGMMA_BF16_TOL["rtol"], atol=tfa.WGMMA_BF16_TOL["atol_frac"] * top)
    elif dtype == torch.bfloat16:
        tol = dict(rtol=2 ** -7, atol=1e-3 * top)
    else:
        tol = _F32_TOL
    torch.testing.assert_close(got, want, **tol, msg=msg)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("D", [32, 64, 96, 128, 256])
@pytest.mark.parametrize("causal", [False, True])
def test_kernels_match_plain(dtype, D, causal):
    """Every instantiated head dim, and D = 96, which the wrappers zero-pad
    to the 128 instance and slice back."""
    _need_card()
    gen = torch.Generator(device="cuda").manual_seed(0)
    # L = 200 leaves a ragged last tile (64 rows, 32 at D = 256) for the
    # kernels to mask; the plain versions tile it by 40
    shape, blk = (3, 200, D), 40
    q, k, v, do = (torch.randn(shape, device="cuda", generator=gen).to(dtype)
                   for _ in range(4))
    scale = D ** -0.5
    o, lse = tfa._fwd_cuda(q, k, v, scale, causal)
    o32, _ = tfa._fwd_cuda(q, k, v, scale, causal, out_dtype=torch.float32)
    po, plse = tfa._fwd_plain(q, k, v, scale, causal, blk, blk)
    po32, _ = tfa._fwd_plain(q, k, v, scale, causal, blk, blk, out_dtype=torch.float32)
    torch.cuda.synchronize()
    assert o.dtype == dtype and o32.dtype == torch.float32
    _assert_close(o, po, dtype, D=D)
    if tfa.kernel_route(dtype, D) == "wgmma":
        _assert_close(o32, po32, dtype, D=D)
    else:
        torch.testing.assert_close(o32, po32, **_F32_TOL)
    torch.testing.assert_close(lse, plse, rtol=1e-5, atol=1e-5)
    delta = (do.float() * po.float()).sum(-1, keepdim=True)
    dk, dv = tfa._dkdv_cuda(q, k, v, do, plse, delta, scale, causal)
    pdk, pdv = tfa._dkdv_plain(q, k, v, do, plse, delta, scale, causal, blk, blk)
    dq = tfa._dq_cuda(q, k, v, do, plse, delta, scale, causal)
    pdq = tfa._dq_plain(q, k, v, do, plse, delta, scale, causal, blk, blk)
    torch.cuda.synchronize()
    for name, got, want in (("dq", dq, pdq), ("dk", dk, pdk), ("dv", dv, pdv)):
        _assert_close(got, want, dtype, msg=name, D=D)


@pytest.mark.cuda
@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("L, blk", [(5, 5), (17, 17), (200, 40), (1000, 40), (1024, 128)])
def test_wgmma_routes_match_plain(D, causal, L, blk):
    """The wgmma forward (bf16 and float32 output), dK/dV and dQ against
    their plain versions, with a ragged L and four heads of different
    scales: a tile that read past L into the next head's rows would show.
    L 5 and 17 are shorter than one TMA box. Every launch takes the wgmma
    route."""
    _need_card()
    assert tfa.kernel_route(torch.bfloat16, D) == "wgmma"
    gen = torch.Generator(device="cuda").manual_seed(L + D)
    head_scale = torch.arange(1, 5, device="cuda", dtype=torch.float32).view(4, 1, 1)
    q, k, v, do = ((torch.randn((4, L, D), device="cuda", generator=gen) * head_scale)
                   .to(torch.bfloat16) for _ in range(4))
    scale = D ** -0.5
    tfa.reset_launch_counts()
    o, lse = tfa._fwd_cuda(q, k, v, scale, causal)
    o32, lse32 = tfa._fwd_cuda(q, k, v, scale, causal, out_dtype=torch.float32)
    po, plse = tfa._fwd_plain(q, k, v, scale, causal, blk, blk)
    po32, _ = tfa._fwd_plain(q, k, v, scale, causal, blk, blk, out_dtype=torch.float32)
    delta = (do.float() * po.float()).sum(-1, keepdim=True)
    dk, dv = tfa._dkdv_cuda(q, k, v, do, plse, delta, scale, causal)
    pdk, pdv = tfa._dkdv_plain(q, k, v, do, plse, delta, scale, causal, blk, blk)
    dq = tfa._dq_cuda(q, k, v, do, plse, delta, scale, causal)
    pdq = tfa._dq_plain(q, k, v, do, plse, delta, scale, causal, blk, blk)
    torch.cuda.synchronize()
    assert o.dtype == torch.bfloat16 and o32.dtype == torch.float32
    for name, got, want in (("o", o, po), ("o32", o32, po32), ("dk", dk, pdk), ("dv", dv, pdv),
                            ("dq", dq, pdq)):
        _assert_close(got, want, torch.bfloat16, msg=name, D=D)
    for got in (lse, lse32):
        torch.testing.assert_close(got, plse, rtol=1e-5, atol=1e-5)
    want = {name: 0 for name in tfa.ROUTE_LAUNCHES}
    want.update({"flash_fwd:wgmma": 2, "flash_dkdv:wgmma": 1, "flash_dq:wgmma": 1})
    assert dict(tfa.ROUTE_LAUNCHES) == want


@pytest.mark.cuda
@pytest.mark.parametrize("dtype, D, route", [
    (torch.bfloat16, 128, "wgmma"), (torch.bfloat16, 48, "wgmma"),
    (torch.bfloat16, 32, "simt"), (torch.float32, 128, "simt"),
])
def test_route_counts_on_the_autograd_path(dtype, D, route):
    """`flash_attention` forward and backward on CUDA tensors: one launch of
    each role, on the route `kernel_route` names for (dtype, D)."""
    _need_card()
    assert tfa.kernel_route(dtype, D) == route
    gen = torch.Generator(device="cuda").manual_seed(D)
    q, k, v, do = (torch.randn((2, 256, 2, D), device="cuda", generator=gen).to(dtype)
                   for _ in range(4))
    ts = [t.clone().requires_grad_() for t in (q, k, v)]
    tfa.reset_launch_counts()
    o = tfa.flash_attention(*ts, causal=True)
    o.backward(do)
    torch.cuda.synchronize()
    assert dict(tfa.LAUNCHES) == {"flash_fwd": 1, "flash_dkdv": 1, "flash_dq": 1}
    want = {name: 0 for name in tfa.ROUTE_LAUNCHES}
    want.update({f"flash_fwd:{route}": 1, f"flash_dkdv:{route}": 1, f"flash_dq:{route}": 1})
    assert dict(tfa.ROUTE_LAUNCHES) == want
    assert all(bool(torch.isfinite(t.grad).all()) for t in ts)


@pytest.mark.cuda
def test_flash_attention_goes_through_the_kernels():
    """Autograd on CUDA tensors launches each kernel once per call and
    matches the CPU path, float32 on both sides, to rtol 1e-4 and an atol of
    1e-5 of the CPU output's largest entry; a head dim above 256 raises."""
    _need_card()
    gen = np.random.default_rng(9)
    q, k, v, do = (gen.standard_normal((2, 128, 2, 64)).astype(np.float32) for _ in range(4))
    results = []
    for device in ("cpu", "cuda"):
        ts = [torch.tensor(x, device=device, requires_grad=True) for x in (q, k, v)]
        tfa.reset_launch_counts()
        o = tfa.flash_attention(*ts, causal=True)
        o.backward(torch.tensor(do, device=device))
        counts = dict(tfa.LAUNCHES)
        results.append([o.detach().cpu()] + [t.grad.cpu() for t in ts])
    assert counts == {"flash_fwd": 1, "flash_dkdv": 1, "flash_dq": 1}
    off = []
    for name, got, want in zip(("o", "dq", "dk", "dv"), results[1], results[0]):
        top = float(want.abs().max())
        err = (got - want).abs()
        bad = err > _F32_ATOL_FRAC * top + _F32_TOL["rtol"] * want.abs()
        if bool(bad.any()):
            off.append(f"{name}: {int(bad.sum())} of {want.numel()} entries off, max |err| "
                       f"{float(err.max()):.3e} = {float(err.max()) / top:.3e} of max|cpu|")
    assert not off, "; ".join(off)
    x = torch.zeros(1, 128, 1, 272, device="cuda")
    with pytest.raises(ValueError, match="head dim 272 exceeds"):
        tfa.flash_attention(x, x, x)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype, D", [
    (torch.float32, 64), (torch.float32, 128), (torch.bfloat16, 64), (torch.bfloat16, 128),
])
def test_kernels_are_bitwise_steady(dtype, D):
    """F, KV and Q on the same inputs three times give the same bits: none
    of them uses atomics or reads another block's output. float32 runs the
    SIMT kernels, bf16 at D 64 and 128 the wgmma ones."""
    _need_card()
    gen = torch.Generator(device="cuda").manual_seed(D)
    q, k, v, do = (torch.randn((4, 1000, D), device="cuda", generator=gen).to(dtype)
                   for _ in range(4))
    scale = D ** -0.5
    o, lse = tfa._fwd_cuda(q, k, v, scale, True)
    delta = (do.float() * o.float()).sum(-1, keepdim=True)
    runs = []
    tfa.reset_launch_counts()
    for _ in range(3):
        o, lse = tfa._fwd_cuda(q, k, v, scale, True)
        dk, dv = tfa._dkdv_cuda(q, k, v, do, lse, delta, scale, True)
        dq = tfa._dq_cuda(q, k, v, do, lse, delta, scale, True)
        runs.append((o, lse, dk, dv, dq))
    torch.cuda.synchronize()
    route = tfa.kernel_route(dtype, D)
    assert all(tfa.ROUTE_LAUNCHES[f"{n}:{route}"] == 3 for n in tfa.LAUNCHES)
    for again in runs[1:]:
        for name, a, b in zip(("o", "lse", "dk", "dv", "dq"), runs[0], again):
            assert torch.equal(a, b), f"{name} ({route}) changed between runs"


@pytest.mark.cuda
def test_trainer_defaults_run_on_the_kernels():
    """The trainer with its own defaults (8 heads of dim 32) trains on the
    card through the kernels: one launch of each per layer and step."""
    _need_card()
    tfa.reset_launch_counts()
    losses = lm.main(["--steps", "2", "--log-every", "1"])
    assert len(losses) == 2 and all(np.isfinite(losses))
    n_layers = lm.parse_args([]).n_layers
    assert dict(tfa.LAUNCHES) == {n: 2 * n_layers for n in tfa.LAUNCHES}


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [False, True])
def test_ring_flash_matches_dense(causal):
    """The driver-mode ring on the kernels (4 shards of 128, f32) against
    dense attention over the whole sequence: output and grads, with one
    launch of each kernel per ring step."""
    _need_card()
    W, B, L, H, D = 4, 1, 512, 2, 64
    gen = np.random.default_rng(3)
    q, k, v, do = (gen.standard_normal((B, L, H, D)).astype(np.float32) for _ in range(4))

    def shard(x):  # (B, L, H, D) -> (W, B, L/W, H, D)
        return x.reshape(B, W, L // W, H, D).transpose(0, 1).contiguous()

    ts = [torch.tensor(x, device="cuda", requires_grad=True) for x in (q, k, v)]
    tfa.reset_launch_counts()
    o = tcp.ring_attention(*(shard(t) for t in ts), causal=causal, block_kernel="flash")
    o = o.transpose(0, 1).reshape(B, L, H, D)
    o.backward(torch.tensor(do, device="cuda"))
    assert dict(tfa.LAUNCHES) == {"flash_fwd": W, "flash_dkdv": W, "flash_dq": W}
    rs = [torch.tensor(x, device="cuda", requires_grad=True) for x in (q, k, v)]
    want = dense_attention(*rs, causal=causal)
    want.backward(torch.tensor(do, device="cuda"))
    torch.testing.assert_close(o, want, **_F32_TOL)
    for name, t, r in zip("qkv", ts, rs):
        torch.testing.assert_close(t.grad, r.grad, **_F32_TOL, msg=f"d{name}")


# ---------------------------------------------------------------------------
# the c10d core on the card
# ---------------------------------------------------------------------------


def _c10d_script(tdx, ReduceOp):
    """Every driver-mode collective once, on integer-valued inputs; returns
    each result's tensor."""
    W = tdx.get_world_size()
    gen = np.random.default_rng(5)

    def dist(*shape, dtype=torch.float32):
        x = gen.integers(-2, 3, (W,) + shape).astype(np.float32)
        return tdx.DistTensor.from_stacked(torch.from_numpy(x).to(dtype))

    out = {}
    for op in ("SUM", "AVG", "PRODUCT", "MIN", "MAX"):
        for dtype in (torch.float32, torch.bfloat16, torch.int32):
            t = dist(3, 5, dtype=dtype)
            tdx.all_reduce(t, getattr(ReduceOp, op))
            out[f"all_reduce {op} {dtype}"] = t.tensor
    for op in ("BAND", "BOR", "BXOR"):
        t = dist(4, dtype=torch.int32)
        tdx.all_reduce(t, getattr(ReduceOp, op))
        out[f"all_reduce {op}"] = t.tensor
    t = dist(4, dtype=torch.bool)
    tdx.all_reduce(t, ReduceOp.SUM)
    out["all_reduce SUM bool"] = t.tensor
    t = dist(4)
    tdx.all_reduce(t, ReduceOp.PREMUL_SUM(2.5))
    out["all_reduce PREMUL_SUM(2.5)"] = t.tensor
    t = dist(4)
    tdx.broadcast(t, 3)
    out["broadcast"] = t.tensor
    t = dist(4)
    tdx.reduce(t, 2, ReduceOp.MAX)
    out["reduce"] = t.tensor
    out["all_gather"] = tdx.all_gather(dist(3)).tensor
    out["gather"] = tdx.gather(dist(3), 1).tensor
    out["scatter"] = tdx.scatter(dist(W, 2), 4).tensor
    out["reduce_scatter"] = tdx.reduce_scatter(dist(W, 2), ReduceOp.SUM).tensor
    out["all_to_all"] = tdx.all_to_all(dist(W, 2)).tensor
    out["all_to_all_single ragged"] = tdx.all_to_all_single(
        dist(8, 2), input_split_sizes=[1, 0, 2, 1, 1, 0, 1, 2]).tensor
    t = dist(3)
    tdx.send(t, 5, src=2)
    out["send"] = t.tensor
    return out


@pytest.mark.cuda
def test_c10d_driver_collectives_stay_on_the_card():
    """World 8 on cuda:0 (the one-device driver mode) against the same
    script on the CPU: every output lies on the card and agrees exactly."""
    _need_card()
    import pytorch_distributed_example_tpu_torch as tdx
    from pytorch_distributed_example_tpu_torch.types import ReduceOp

    tdx.init_process_group(world_size=8, device="cpu")
    try:
        want = {k: v.clone() for k, v in _c10d_script(tdx, ReduceOp).items()}
    finally:
        tdx.destroy_process_group()
    pg = tdx.init_process_group(world_size=8)  # the card by default
    try:
        assert pg.device == torch.device("cuda", 0)
        got = _c10d_script(tdx, ReduceOp)
    finally:
        tdx.destroy_process_group()
    assert got.keys() == want.keys()
    for name, t in got.items():
        assert t.device.type == "cuda", name
        assert t.dtype == want[name].dtype, name
        torch.testing.assert_close(t.cpu(), want[name], rtol=0, atol=0, msg=name)


@pytest.mark.cuda
def test_c10d_work_follows_the_event():
    """An async all_reduce queued behind a long kernel is not complete until
    its event fires; wait() synchronizes on it."""
    _need_card()
    import pytorch_distributed_example_tpu_torch as tdx

    tdx.init_process_group(world_size=8)
    try:
        t = tdx.DistTensor.from_rank_fn(lambda r: torch.full((1024,), float(r)))
        torch.cuda._sleep(2_000_000_000)  # ~1 s of spinning ahead on the stream
        work = tdx.all_reduce(t, async_op=True)
        assert not work.is_completed()
        assert work.wait() and work.is_completed()
        assert torch.equal(t.tensor, torch.full((8, 1024), 28.0, device="cuda"))
    finally:
        tdx.destroy_process_group()


@pytest.mark.cuda
def test_c10d_toy_example_on_the_card(capsys):
    _need_card()
    from pytorch_distributed_example_tpu_torch.examples import toy

    toy.main(["--world-size", "8", "--steps", "3"])
    assert capsys.readouterr().out.splitlines() == [
        "initialized: backend=xla world_size=8",
        "step 0: all_reduce(SUM) -> 28.0 (every rank agrees: True, expect 28)",
        "step 1: all_reduce(SUM) -> 36.0 (every rank agrees: True, expect 36)",
        "step 2: all_reduce(SUM) -> 44.0 (every rank agrees: True, expect 44)",
    ]


@pytest.mark.cuda
def test_c10d_world_one_nccl_group_on_the_native_store():
    """Multiproc mode at world 1 on the card: the rendezvous, the port's
    native TCPStore and torch.distributed's nccl group over it."""
    _need_card()
    import socket

    import pytorch_distributed_example_tpu_torch as tdx

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    pg = tdx.init_process_group(backend="nccl", init_method=f"tcp://127.0.0.1:{port}",
                                rank=0, world_size=1, timeout=60)
    try:
        assert tdx.distributed._world.mode == "multiproc"
        assert pg.store.underlying.native
        assert pg.backend_impl.torch_group is not None
        t = tdx.DistTensor.from_process_local(torch.arange(6.0, device="cuda"))
        tdx.all_reduce(t, tdx.ReduceOp.AVG)
        assert t.tensor.device.type == "cuda"
        assert torch.equal(t.tensor[0], torch.arange(6.0, device="cuda"))
    finally:
        tdx.destroy_process_group()
    assert not tdx.is_initialized()


def _ddp_run(device, shard, has_rng, steps):
    """`tests/_ddp_cases.run` on a world-8 driver-mode group on `device`.
    The module is loaded from its file: where another installed package is
    named `tests`, `from tests import ...` would find that one."""
    import importlib.util
    import os

    import pytorch_distributed_example_tpu_torch as tdx

    spec = importlib.util.spec_from_file_location(
        "_ddp_cases", os.path.join(os.path.dirname(__file__), "_ddp_cases.py"))
    cases = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cases)

    tdx.init_process_group(world_size=8, device=device)
    try:
        return cases.run(tdx, steps, shard, has_rng=has_rng)
    finally:
        tdx.destroy_process_group()


@pytest.mark.cuda
def test_ddp_step_on_the_card_matches_the_cpu():
    """Driver mode at world 8 on cuda:0 (ZeRO auto, dropout off) against the
    same run on the CPU: cuDNN's convolution algorithms sum in another
    order than oneDNN's, so losses are held to rtol 1e-5 and params to
    rtol 1e-4, atol 1e-6 (float32; TF32 off)."""
    _need_card()
    card = _ddp_run(None, "auto", False, 3)
    cpu = _ddp_run("cpu", "auto", False, 3)
    np.testing.assert_allclose(card[0], cpu[0], rtol=1e-5, atol=0)
    for n, p in card[1].items():
        np.testing.assert_allclose(p, cpu[1][n], rtol=1e-4, atol=1e-6, err_msg=n)


@pytest.mark.cuda
def test_ddp_zero_auto_matches_off_bitwise_on_the_card():
    """The contract is about the update given the same gradients, so both
    runs take cuDNN's deterministic algorithms: its default weight-gradient
    ones need not sum in the same order from one run to the next."""
    _need_card()
    torch.backends.cudnn.deterministic = True
    try:
        auto = _ddp_run(None, "auto", True, 3)
        off = _ddp_run(None, "off", True, 3)
    finally:
        torch.backends.cudnn.deterministic = False
    assert auto[0] == off[0]
    for n in auto[1]:
        np.testing.assert_array_equal(auto[1][n], off[1][n], err_msg=n)


_SHARDED_ARGV = ["--vocab-size", "128", "--d-model", "256", "--n-layers", "2", "--n-heads", "2",
                 "--seq", "128", "--batch-size", "4", "--lr", "1e-3"]


def _sharded_first_step(device, experts):
    """The first step of the trainer's fsdp 2 x tp 2 step on `device` from
    the same weights: (loss, every gradient gathered, the next two losses)."""
    args = lm.parse_args(["--cpu", *_SHARDED_ARGV, "--tp", "2", *experts])
    cpu = lm.TransformerLM(lm.config_for(args), device="cpu",
                           generator=torch.Generator().manual_seed(0))
    model = lm.TransformerLM(lm.config_for(args), device=device)
    model.load_state_dict(cpu.state_dict())
    mod = lm.shard(model, args.lr, 4, 2)
    opt = mod.step.init_opt_state(mod.params)
    toks = [torch.from_numpy(np.random.default_rng(i).integers(0, 128, (4, 128))).to(device)
            for i in range(3)]
    losses = [float(lm.train_step(mod, opt, toks[0]))]
    grads = {k: DTensor(v._local.grad, v.device_mesh, v.placements).full_tensor().cpu()
             for k, v in mod.params.items()}
    losses += [float(lm.train_step(mod, opt, t)) for t in toks[1:]]
    return losses, grads


@pytest.mark.cuda
@pytest.mark.parametrize("experts", [[], ["--n-experts", "4"]], ids=["dense", "moe"])
def test_sharded_step_on_the_card_matches_the_cpu(experts):
    """float32, TF32 off: the SIMT kernels on the card against the plain
    versions on the CPU, the same arithmetic in another order. The first
    step's gradients to rtol 1e-4 and 1e-5 of their largest entry, three
    steps' losses to rtol 1e-5."""
    _need_card()
    card = _sharded_first_step("cuda", experts)
    cpu = _sharded_first_step("cpu", experts)
    np.testing.assert_allclose(card[0], cpu[0], rtol=1e-5, atol=0)
    for k, g in cpu[1].items():
        torch.testing.assert_close(card[1][k], g, rtol=1e-4,
                                   atol=1e-5 * float(g.abs().max()), msg=k)


@pytest.mark.cuda
def test_sharded_step_launches_each_kernel_once_a_layer():
    """bf16 at head dim 128 over fsdp 2 x tp 2: the four ranks fold into
    B*H, so F, KV and Q launch once a layer a step, on the wgmma route."""
    _need_card()
    args = lm.parse_args([*_SHARDED_ARGV, "--bf16", "--tp", "2"])
    mod, opt, next_tokens = lm.build(args, world=4)
    lm.train_step(mod, opt, next_tokens())
    tfa.reset_launch_counts()
    loss = lm.train_step(mod, opt, next_tokens())
    assert np.isfinite(float(loss))
    assert dict(tfa.LAUNCHES) == {n: args.n_layers for n in tfa.LAUNCHES}
    assert all(tfa.ROUTE_LAUNCHES[f"{n}:wgmma"] == args.n_layers for n in tfa.LAUNCHES)

