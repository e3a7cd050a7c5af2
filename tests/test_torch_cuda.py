"""The port's Hopper kernels on the card, against their plain versions.

Marked `cuda`: each test skips without a card. This file imports neither
JAX nor the JAX package, so it runs where only PyTorch is installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

(`--noconftest` because the repository's conftest pins JAX to the CPU.)
"""

import contextlib
import importlib

import numpy as np
import pytest
import torch

from pytorch_distributed_example_tpu_torch.dtensor import DTensor
from pytorch_distributed_example_tpu_torch.examples import lm
from pytorch_distributed_example_tpu_torch.ops import dense_attention
from pytorch_distributed_example_tpu_torch.parallel import context_parallel as tcp
from pytorch_distributed_example_tpu_torch.utils.cpu_reference import cpu_reference

tfa = importlib.import_module("pytorch_distributed_example_tpu_torch.ops.flash_attention")


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run with -m cuda on the H100)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


# On the float32 route (the forward, dK/dV and dQ as three TF32 passes on the
# tensor cores, which keep float32 accuracy) kernel and plain version
# compute in float32 in another order, and are held to _F32_TOL. The wgmma
# route (bf16 operands at every head dim) rounds P and dS to bf16 beside
# rounding its bf16 outputs once, and is held to the tolerance declared with
# it, `WGMMA_BF16_TOL`.
_F32_TOL = dict(rtol=1e-4, atol=1e-5)
# float32 against the CPU path: the same arithmetic in another order on both
# sides, the atol a share of the largest entry, as chip_smoke.py's F32_TOL
_F32_ATOL_FRAC = 1e-5


def _assert_close(got, want, dtype, D, role, msg=None):
    """`got` against `want` at the tolerance of the route that (dtype, D)
    takes for `role`."""
    got, want = got.float(), want.float()
    top = float(want.abs().max())
    if tfa.kernel_route(dtype, D, role) == "wgmma":
        tol = dict(rtol=tfa.WGMMA_BF16_TOL["rtol"], atol=tfa.WGMMA_BF16_TOL["atol_frac"] * top)
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
    _assert_close(o, po, dtype, D=D, role="flash_fwd")
    if tfa.kernel_route(dtype, D, "flash_fwd") == "wgmma":
        _assert_close(o32, po32, dtype, D=D, role="flash_fwd")
    else:
        torch.testing.assert_close(o32, po32, **_F32_TOL)
    torch.testing.assert_close(lse, plse, rtol=1e-5, atol=1e-5)
    delta = (do.float() * po.float()).sum(-1, keepdim=True)
    dk, dv = tfa._dkdv_cuda(q, k, v, do, plse, delta, scale, causal)
    pdk, pdv = tfa._dkdv_plain(q, k, v, do, plse, delta, scale, causal, blk, blk)
    dq = tfa._dq_cuda(q, k, v, do, plse, delta, scale, causal)
    pdq = tfa._dq_plain(q, k, v, do, plse, delta, scale, causal, blk, blk)
    torch.cuda.synchronize()
    for name, role, got, want in (("dq", "flash_dq", dq, pdq), ("dk", "flash_dkdv", dk, pdk),
                                  ("dv", "flash_dkdv", dv, pdv)):
        _assert_close(got, want, dtype, msg=name, D=D, role=role)


@pytest.mark.cuda
@pytest.mark.parametrize("D", [32, 48, 64, 128, 200, 256])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("L, blk", [(5, 5), (17, 17), (200, 40), (1000, 40), (1024, 128)])
def test_wgmma_routes_match_plain(D, causal, L, blk):
    """The wgmma forward (bf16 and float32 output), dK/dV and dQ against
    their plain versions, with a ragged L and four heads of different
    scales: a tile that read past L into the next head's rows would show.
    L 5 and 17 are shorter than one TMA box. Every instance: D 32 (64-byte
    swizzle), 64, 128, 256 (dK/dV split between the warpgroups), and 48 and
    200, zero-padded to 64 and 256. Every launch takes the wgmma route."""
    _need_card()
    assert all(tfa.kernel_route(torch.bfloat16, D, n) == "wgmma" for n in tfa.LAUNCHES)
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
    for name, role, got, want in (("o", "flash_fwd", o, po), ("o32", "flash_fwd", o32, po32),
                                  ("dk", "flash_dkdv", dk, pdk), ("dv", "flash_dkdv", dv, pdv),
                                  ("dq", "flash_dq", dq, pdq)):
        _assert_close(got, want, torch.bfloat16, msg=name, D=D, role=role)
    for got in (lse, lse32):
        torch.testing.assert_close(got, plse, rtol=1e-5, atol=1e-5)
    want = {name: 0 for name in tfa.ROUTE_LAUNCHES}
    want.update({"flash_fwd:wgmma": 2, "flash_dkdv:wgmma": 1, "flash_dq:wgmma": 1})
    assert dict(tfa.ROUTE_LAUNCHES) == want


@pytest.mark.cuda
@pytest.mark.parametrize("dtype, D, routes", [
    (torch.bfloat16, 128, "wgmma wgmma wgmma"), (torch.bfloat16, 48, "wgmma wgmma wgmma"),
    (torch.bfloat16, 32, "wgmma wgmma wgmma"), (torch.bfloat16, 256, "wgmma wgmma wgmma"),
    (torch.float32, 32, "tf32x3 tf32x3 tf32x3"), (torch.float32, 64, "tf32x3 tf32x3 tf32x3"),
    (torch.float32, 128, "tf32x3 tf32x3 tf32x3"), (torch.float32, 256, "tf32x3 tf32x3 tf32x3"),
])
def test_route_counts_on_the_autograd_path(dtype, D, routes):
    """`flash_attention` forward and backward on CUDA tensors: one launch of
    each role, on the route `kernel_route` names for (dtype, D, role): F, KV
    and Q in `routes`."""
    _need_card()
    fwd, kv, q_route = routes.split()
    assert [tfa.kernel_route(dtype, D, n) for n in tfa.LAUNCHES] == [fwd, kv, q_route]
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
    want.update({f"flash_fwd:{fwd}": 1, f"flash_dkdv:{kv}": 1, f"flash_dq:{q_route}": 1})
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
        # the CPU side: primed, and under one intra-op thread (utils/cpu_reference.py)
        with cpu_reference(threads=1) if device == "cpu" else contextlib.nullcontext():
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
    (torch.bfloat16, 32), (torch.bfloat16, 256), (torch.float32, 32), (torch.float32, 256),
])
def test_kernels_are_bitwise_steady(dtype, D):
    """F, KV and Q on the same inputs three times give the same bits: none
    of them uses atomics or reads another block's output. float32 runs the
    tf32x3 kernels, bf16 the wgmma kernels."""
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
    route = {n: tfa.kernel_route(dtype, D, n) for n in tfa.LAUNCHES}
    assert all(tfa.ROUTE_LAUNCHES[f"{n}:{route[n]}"] == 3 for n in tfa.LAUNCHES)
    roles = ("flash_fwd", "flash_fwd", "flash_dkdv", "flash_dkdv", "flash_dq")
    for again in runs[1:]:
        for name, role, a, b in zip(("o", "lse", "dk", "dv", "dq"), roles, runs[0], again):
            assert torch.equal(a, b), f"{name} ({route[role]}) changed between runs"


def _f64_backward(q, k, v, do, lse, delta, scale, causal):
    """dK, dV and dQ by the plain versions' arithmetic in float64, from the
    same float32 lse and delta."""
    L = q.shape[1]
    q, k, v, do = (t.double() for t in (q, k, v, do))
    s = q @ k.transpose(1, 2) * scale
    if causal:
        s = s.masked_fill(torch.ones(L, L, dtype=torch.bool, device=q.device).triu(1), tfa.NEG_INF)
    p = torch.exp(s - lse.double())
    ds = p * (do @ v.transpose(1, 2) - delta.double())
    return ds.transpose(1, 2) @ q * scale, p.transpose(1, 2) @ do, ds @ k * scale


@pytest.mark.cuda
@pytest.mark.parametrize("D", [32, 64, 128, 256])
@pytest.mark.parametrize("causal", [False, True])
def test_tf32x3_as_exact_as_float32_on_large_logits(D, causal):
    """Heads scaled by 1 to 4 (logits up to 16 times randn's): the float32
    dK/dV and dQ kernels (three TF32 passes) stand no farther from a
    float64 copy of the same arithmetic than twice the plain float32
    versions do. There the plain versions' own error can pass the float32
    tolerance, so they are no reference for it."""
    _need_card()
    assert [tfa.kernel_route(torch.float32, D, n) for n in ("flash_dkdv", "flash_dq")] == [
        "tf32x3", "tf32x3"]
    gen = torch.Generator(device="cuda").manual_seed(D + causal)
    heads = (torch.arange(8, device="cuda", dtype=torch.float32) % 4 + 1).view(8, 1, 1)
    q, k, v, do = (torch.randn((8, 1024, D), device="cuda", generator=gen) * heads
                   for _ in range(4))
    scale, blk = D ** -0.5, 128
    o, lse = tfa._fwd_plain(q, k, v, scale, causal, blk, blk)
    delta = (do * o).sum(-1, keepdim=True)
    got = (*tfa._dkdv_cuda(q, k, v, do, lse, delta, scale, causal),
           tfa._dq_cuda(q, k, v, do, lse, delta, scale, causal))
    plain = (*tfa._dkdv_plain(q, k, v, do, lse, delta, scale, causal, blk, blk),
             tfa._dq_plain(q, k, v, do, lse, delta, scale, causal, blk, blk))
    exact = _f64_backward(q, k, v, do, lse, delta, scale, causal)
    for name, g, pl, ex in zip(("dk", "dv", "dq"), got, plain, exact):
        kernel_err = float((g.double() - ex).abs().max())
        plain_err = float((pl.double() - ex).abs().max())
        assert kernel_err <= 2 * plain_err, (name, kernel_err, plain_err)


def _f64_forward(q, k, v, scale, causal):
    """o and lse by the plain forward's arithmetic in float64 (q scaled
    before q k^T), over the whole sequence at once."""
    L = q.shape[1]
    s = (q.double() * scale) @ k.double().transpose(1, 2)
    if causal:
        s = s.masked_fill(torch.ones(L, L, dtype=torch.bool, device=q.device).triu(1), tfa.NEG_INF)
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(-1, keepdim=True)
    return p @ v.double() / l, m + torch.log(l)


@pytest.mark.cuda
@pytest.mark.parametrize("D", [32, 64, 128, 256])
@pytest.mark.parametrize("causal", [False, True])
def test_tf32x3_forward_as_exact_as_float32_on_large_logits(D, causal):
    """Heads scaled by 1 to 4 (logits up to 16 times randn's): the float32
    forward kernel's o and lse (three TF32 passes, S scaled after the
    product) stand within the float32 tolerance of a float64 copy of the
    plain forward, and no farther from it than twice the plain float32
    forward does."""
    _need_card()
    assert tfa.kernel_route(torch.float32, D, "flash_fwd") == "tf32x3"
    gen = torch.Generator(device="cuda").manual_seed(D + causal + 5)
    heads = (torch.arange(8, device="cuda", dtype=torch.float32) % 4 + 1).view(8, 1, 1)
    q, k, v = (torch.randn((8, 1024, D), device="cuda", generator=gen) * heads
               for _ in range(3))
    scale, blk = D ** -0.5, 128
    got = tfa._fwd_cuda(q, k, v, scale, causal)
    plain = tfa._fwd_plain(q, k, v, scale, causal, blk, blk)
    exact = _f64_forward(q, k, v, scale, causal)
    for name, g, pl, ex in zip(("o", "lse"), got, plain, exact):
        err = (g.double() - ex).abs()
        top = float(ex.abs().max())
        past = int((err > _F32_ATOL_FRAC * top + _F32_TOL["rtol"] * ex.abs()).sum())
        kernel_err, plain_err = float(err.max()), float((pl.double() - ex).abs().max())
        assert past == 0 and kernel_err <= 2 * plain_err, (name, past, kernel_err, plain_err)


@pytest.mark.cuda
def test_wgmma_instances_fit_shared_memory():
    """Every wgmma instance asks for at most the 232,448 bytes of shared
    memory a block may use on the H100; a head dim or role without an
    instance answers -1."""
    _need_card()
    from pytorch_distributed_example_tpu_torch.ops import _build

    lib = _build.load("flash_attention", tfa._SIGNATURES)
    for D in tfa.HEAD_DIMS:
        for role in range(3):
            assert 0 < lib.flash_wgmma_smem_bytes(role, D) <= 232448, (role, D)
    assert lib.flash_wgmma_smem_bytes(0, 48) == -1
    assert lib.flash_wgmma_smem_bytes(3, 128) == -1


@pytest.mark.cuda
def test_tf32x3_instances_fit_shared_memory():
    """Every tf32x3 instance (the forward, dK/dV, dQ) asks for at most the
    232,448 bytes of shared memory a block may use; a head dim or role
    without an instance answers -1."""
    _need_card()
    from pytorch_distributed_example_tpu_torch.ops import _build

    lib = _build.load("flash_attention", tfa._SIGNATURES)
    for D in tfa.HEAD_DIMS:
        for role in range(3):
            assert 0 < lib.flash_tf32x3_smem_bytes(role, D) <= 232448, (role, D)
    assert lib.flash_tf32x3_smem_bytes(1, 48) == -1
    assert lib.flash_tf32x3_smem_bytes(3, 128) == -1


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
    """float32, TF32 off: the float32 kernels on the card (the three-pass
    TF32 forward, dK/dV and dQ) against the plain versions on the CPU,
    the same arithmetic in another order. The first
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


@pytest.mark.cuda
def test_mfu_step_runs_the_d64_kernels_and_matches_dense():
    """One step of the bench's MFU model (the reference's `_bench_mfu`
    configuration: 8 layers, 8 heads of 64, L 512, B 8, bf16) launches F, KV
    and Q 8 times each on wgmma, and its loss is within 1e-2 of the
    `use_flash=False` step's from the same weights."""
    from pytorch_distributed_example_tpu_torch import bench

    _need_card()
    model, opt, tokens = bench.mfu_setup("cuda")
    dense, dense_opt, _ = bench.mfu_setup("cuda", model_overrides={"use_flash": False})
    dense.load_state_dict(model.state_dict())
    tfa.reset_launch_counts()
    loss = float(lm.train_step(model, opt, tokens))
    n = model.cfg.n_layers
    assert dict(tfa.ROUTE_LAUNCHES) == {k: n if k.endswith(":wgmma") else 0
                                        for k in tfa.ROUTE_LAUNCHES}
    dense_loss = float(lm.train_step(dense, dense_opt, tokens))
    assert np.isfinite(loss) and abs(loss - dense_loss) <= 1e-2, (loss, dense_loss)



# -- serving: the decode path, generate() and the engine on the card ----------

_SERVE_CFG = dict(vocab_size=64, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
                  max_seq_len=64, use_flash=False)


def _serve_models(dtype=torch.float32, **over):
    """The same random weights (seed 0) on the CPU and on the card."""
    from pytorch_distributed_example_tpu_torch.models import TransformerConfig, TransformerLM

    cfg = TransformerConfig(**{**_SERVE_CFG, **over}, dtype=dtype)
    cpu = TransformerLM(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    card = TransformerLM(cfg, device="cuda")
    card.load_state_dict(cpu.state_dict())
    return cpu, card


def _f32_close(got, want, msg=None):
    got, want = got.detach().float().cpu(), want.detach().float().cpu()
    torch.testing.assert_close(got, want, rtol=1e-5,
                               atol=1e-5 * float(want.abs().max()), msg=msg)


@pytest.mark.cuda
@torch.no_grad()
def test_decode_paths_on_the_card_match_the_cpu():
    """float32, TF32 off: the scalar-index, positions= and paged paths,
    with table entries equal to num_blocks, a position past the table and a
    parked lane at M - 1; no device-side assert follows."""
    _need_card()
    from pytorch_distributed_example_tpu_torch.models.generate import init_cache
    from pytorch_distributed_example_tpu_torch.serve.cache import init_paged_cache

    cpu, card = _serve_models()
    gen = np.random.default_rng(0)
    M = _SERVE_CFG["max_seq_len"]
    caches = [init_cache(cpu, 2), init_cache(card, 2)]
    for L in (9, 1, 1, 4):
        toks = torch.as_tensor(gen.integers(0, 64, (2, L)))
        outs = [m(toks.to(m.lm_head.weight.device), decode=True, cache=c)
                for m, c in zip((cpu, card), caches)]
        _f32_close(outs[1], outs[0], "scalar-index path")
    pos = torch.tensor([3, M - 2], dtype=torch.int32)
    toks = torch.as_tensor(gen.integers(0, 64, (2, 4)))
    outs = [m(toks.to(m.lm_head.weight.device), decode=True, cache=c,
              positions=pos.to(m.lm_head.weight.device)) for m, c in zip((cpu, card), caches)]
    _f32_close(outs[1], outs[0], "positions= path")
    nblk, bs = 20, 8
    bt = torch.full((3, M // bs), nblk, dtype=torch.int32)
    bt[0, :2] = torch.tensor([4, 9])
    bt[1] = torch.tensor([0, 1, 2, 3, 5, 6, 7, 8])
    pos = torch.tensor([5, M - 2, M - 1], dtype=torch.int32)  # row 2 parked
    toks = torch.as_tensor(gen.integers(0, 64, (3, 4)))
    for quantized in (False, True):
        pools = [init_paged_cache(m, nblk, bs, quantized=quantized) for m in (cpu, card)]
        outs = []
        for m, pool in zip((cpu, card), pools):
            dev = m.lm_head.weight.device
            m(toks[1:2].to(dev), decode=True, cache=pool, positions=torch.zeros(1, device=dev,
              dtype=torch.int32), block_tables=bt[1:2].to(dev))
            outs.append(m(toks.to(dev), decode=True, cache=pool, positions=pos.to(dev),
                          block_tables=bt.to(dev)))
        torch.cuda.synchronize()
        _f32_close(outs[1][:2], outs[0][:2], f"paged path, int8 {quantized}")


@pytest.mark.cuda
@pytest.mark.parametrize("temperature,top_k", [(0.0, None), (0.8, 8)])
def test_generate_on_the_card_matches_the_cpu(temperature, top_k):
    _need_card()
    from pytorch_distributed_example_tpu_torch.models import generate

    cpu, card = _serve_models()
    prompt = torch.as_tensor(np.random.default_rng(1).integers(0, 64, (3, 7)))
    want = generate(cpu, prompt, 20, temperature=temperature, top_k=top_k)
    got = generate(card, prompt, 20, temperature=temperature, top_k=top_k)
    assert got.device.type == "cuda"
    assert torch.equal(got.cpu(), want)


def _serve_trace(n, seed):
    """Prompts of 16 or 32 tokens: with chunked prefill at 16 every chunk is
    16 wide whatever shares its step, so both runs compute on equal shapes."""
    gen = np.random.default_rng(seed)
    return [(gen.integers(0, 64, 16 * int(gen.integers(1, 3))).astype(np.int32),
             int(gen.integers(4, 24)), i) for i in range(n)]


@pytest.mark.cuda
def test_engine_preemption_is_token_exact_on_the_card():
    """bf16 at a small width: the full pool against one cut to force
    preemptions, chunked prefill at one chunk size and the same slots, so
    both runs compute on the same shapes; no flash kernel launches."""
    _need_card()
    from pytorch_distributed_example_tpu_torch.serve import ServeEngine

    _, card = _serve_models(torch.bfloat16)
    outs, preempted = [], []
    tfa.reset_launch_counts()
    for pool in (None, 12):
        eng = ServeEngine(card, slots=4, block_size=8, pool_blocks=pool,
                          prefill_chunk_tokens=16, min_bucket=8)
        for prompt, budget, seed in _serve_trace(12, 2):
            eng.submit(prompt, budget, rid=f"r{seed}", seed=seed)
        out = eng.run(max_steps=5000)
        outs.append({rid: c.tokens for rid, c in out.items()})
        preempted.append(eng.metrics.preempted)
    assert preempted[0] == 0 and preempted[1] > 0
    assert outs[0] == outs[1]
    assert sum(tfa.LAUNCHES.values()) == 0


# -- serving across ranks and pools: TP decode and KV migration on the card ---


def _tp_mesh(device, T=2):
    from pytorch_distributed_example_tpu_torch.mesh import DeviceMesh

    return DeviceMesh([device] * T, (T,), ("tp",))


@pytest.mark.cuda
@pytest.mark.parametrize("kv_quant", [False, True])
def test_tp2_engine_on_the_card_matches_the_cpu(kv_quant):
    """float32, TF32 off: the tp 2 engine (driver mode on cuda:0, the pool
    sharded on its 2 KV heads) gives the CPU's single engine's greedy
    tokens, through preemptions and chunked prefill."""
    _need_card()
    from pytorch_distributed_example_tpu_torch.serve import ServeEngine

    cpu, card = _serve_models()
    outs = []
    for model, mesh in ((cpu, None), (card, _tp_mesh("cuda"))):
        eng = ServeEngine(model, slots=4, block_size=8, pool_blocks=12, prefill_chunk_tokens=16,
                          min_bucket=8, kv_quant=kv_quant, mesh=mesh)
        for prompt, budget, seed in _serve_trace(10, 3):
            eng.submit(prompt, budget, rid=f"r{seed}", seed=seed)
        outs.append({rid: c.tokens for rid, c in eng.run(max_steps=5000).items()})
    assert eng.cache.tree["layers_0"]["attn"]["k"]._local.is_cuda
    assert eng.metrics.preempted > 0
    assert outs[1] == outs[0]


@pytest.mark.cuda
@pytest.mark.parametrize("pool", ["bfloat16", "int8"])
def test_migration_lands_bit_for_bit_on_the_card(pool):
    """bf16 weights, a bf16 or int8 pool: a prefill engine's handoff goes
    through the store (raw bf16 words, int8 payloads and scales) onto a
    decode engine at tp 1 and at tp 2, lands bit for bit, and decodes the
    colocated engine's tokens."""
    _need_card()
    from pytorch_distributed_example_tpu_torch.serve import ServeEngine
    from pytorch_distributed_example_tpu_torch.serve.disagg import recv_migration, send_handoff
    from pytorch_distributed_example_tpu_torch.store import HashStore

    _, card = _serve_models(torch.bfloat16)
    kw = dict(slots=2, block_size=8, prefill_chunk_tokens=16, min_bucket=8,
              kv_quant=pool == "int8")
    prompt, budget, seed = _serve_trace(1, 4)[0]
    colo = ServeEngine(card, **kw)
    colo.submit(prompt, budget, rid="m0", seed=seed)
    want = colo.run(max_steps=500)["m0"].tokens
    for mesh in (None, _tp_mesh("cuda")):
        src = ServeEngine(card, role="prefill", **kw)
        src.submit(prompt, budget, rid="m0", seed=seed)
        handoffs = []
        while not handoffs:
            src.step()
            handoffs = src.pop_handoffs()
        h = handoffs[0]
        store = HashStore()
        send_handoff(store, src, h, chunk_blocks=1)
        dst = ServeEngine(card, role="decode", mesh=mesh, **kw)
        slot = recv_migration(store, "m0", dst)
        sent = src.cache.export_blocks(src.cache.slot_blocks(h.slot))
        got = dst.cache.export_blocks(dst.cache.slot_blocks(slot))
        for layer, node in sent.items():
            for name, t in node["attn"].items():
                assert t.dtype == got[layer]["attn"][name].dtype
                assert torch.equal(got[layer]["attn"][name].view(torch.uint8),
                                   t.view(torch.uint8)), (layer, name)
        out = dst.run(max_steps=500)["m0"].tokens
        # tp 2 sums the bf16 products in another order: its tokens may part
        # from tp 1's after a near-tie, so only tp 1 is held to them
        assert out == want if mesh is None else len(out) == budget


def _resnet_step(device):
    """One CIFAR-example step of a narrow ResNet with SyncBN at world 4 on
    `device` (float32): (loss, params, running statistics) on the host."""
    import pytorch_distributed_example_tpu_torch as tdx
    from pytorch_distributed_example_tpu_torch import optim
    from pytorch_distributed_example_tpu_torch.examples import cifar
    from pytorch_distributed_example_tpu_torch.models import ResNet, convert_sync_batchnorm

    tdx.init_process_group(world_size=4, device=device)
    try:
        model = convert_sync_batchnorm(ResNet(
            stage_sizes=[1, 1], num_filters=16, device="cpu",
            generator=torch.Generator().manual_seed(0)).to(device or "cuda"))
        params, stats = model.params_and_stats()
        opt = optim.sgd(0.1, momentum=0.9)
        x, y = cifar.synthetic_cifar(16, 0)
        dev = device or "cuda"
        p, s, _, loss = cifar.make_train_step(model, opt)(
            params, stats, opt.init(params), torch.from_numpy(x).to(dev),
            torch.from_numpy(y).to(dev).long())
        return float(loss), {n: t.cpu() for n, t in p.items()}, {n: t.cpu() for n, t in s.items()}
    finally:
        tdx.destroy_process_group()


@pytest.mark.cuda
def test_resnet_syncbn_step_on_the_card_matches_the_cpu():
    """float32, TF32 off: cuDNN against oneDNN sums in other orders; the
    loss within rtol 1e-5, params and statistics within rtol 1e-4, atol
    1e-5."""
    _need_card()
    card, cpu = _resnet_step(None), _resnet_step("cpu")
    np.testing.assert_allclose(card[0], cpu[0], rtol=1e-5)
    for a, b in ((card[1], cpu[1]), (card[2], cpu[2])):
        for n in b:
            np.testing.assert_allclose(a[n].numpy(), b[n].numpy(), rtol=1e-4, atol=1e-5,
                                       err_msg=n)


def _bert_steps(device, hook=None, sgd=False, **kw):
    """3 adamw (or SGD 0.1) steps of a 2-layer BERT (d 64) under DDP at
    world 4 on `device`, float32, dropout off: (losses, params) on the
    host."""
    import torch.nn.functional as F

    import pytorch_distributed_example_tpu_torch as tdx
    from pytorch_distributed_example_tpu_torch import optim
    from pytorch_distributed_example_tpu_torch.models import (
        BertConfig,
        BertForSequenceClassification,
    )

    tdx.init_process_group(world_size=4, device=device)
    try:
        dev = device or "cuda"
        cfg = BertConfig(vocab_size=100, d_model=64, n_layers=2, n_heads=4, d_ff=128,
                         max_seq_len=16)
        model = BertForSequenceClassification(cfg, device="cpu",
                                              generator=torch.Generator().manual_seed(0))
        ddp = tdx.DistributedDataParallel(model.to(dev))
        if hook is not None:
            ddp.register_comm_hook(None, hook)
        opt = optim.sgd(0.1) if sgd else optim.adamw(1e-3)
        step = ddp.make_train_step(opt, F.cross_entropy, **kw)
        gen = np.random.default_rng(0)
        x = torch.from_numpy(gen.integers(0, 100, (8, 16))).to(dev)
        y = torch.from_numpy(gen.integers(0, 2, 8)).to(dev)
        p, s = ddp.params, opt.init(ddp.params)
        hs = step.init_hook_state(p) if hasattr(step, "init_hook_state") else None
        losses = []
        for _ in range(3):
            if hs is None:
                p, s, loss = step(p, s, x, y)
            else:
                p, s, hs, loss = step(p, s, hs, x, y)
            losses.append(float(loss))
        return losses, {n: t.cpu() for n, t in p.items()}
    finally:
        tdx.destroy_process_group()


@pytest.mark.cuda
@pytest.mark.parametrize("hook", [None, "bf16_compress_hook", "fp16_compress_hook",
                                  "blockwise_quant_hook", "powerSGD_hook"])
def test_bert_ddp_steps_and_hooks_on_the_card_match_the_cpu(hook):
    """The DDP step with each hook on the card against the CPU (float32,
    TF32 off, 3 steps of SGD 0.1, so that the params move with their
    reduced gradients): losses within rtol 1e-4, params within atol 1e-5.
    Where a value sits on a rounding boundary of the wire on one side, it
    moves by one step of the wire's grid times the learning rate: one ulp
    of the gradient (2^-8 of it in bf16, 2^-11 in fp16; gradients below
    1), so atol 4e-4 and 5e-5; the quantized hook's quantum (1/127 of a
    block's amax), atol 1e-3."""
    _need_card()
    from pytorch_distributed_example_tpu_torch.parallel import comm_hooks

    def make():
        if hook is None:
            return None
        if hook == "blockwise_quant_hook":
            return comm_hooks.blockwise_quant_hook(error_feedback=True)
        if hook == "powerSGD_hook":
            return comm_hooks.powerSGD_hook(rank=2)
        return getattr(comm_hooks, hook)

    card, cpu = _bert_steps(None, make(), sgd=True), _bert_steps("cpu", make(), sgd=True)
    np.testing.assert_allclose(card[0], cpu[0], rtol=1e-4)
    atol = {"blockwise_quant_hook": 1e-3, "bf16_compress_hook": 4e-4,
            "fp16_compress_hook": 5e-5}.get(hook, 1e-5)
    for n, p in cpu[1].items():
        np.testing.assert_allclose(card[1][n].numpy(), p.numpy(), rtol=0, atol=atol, err_msg=n)


@pytest.mark.cuda
def test_bert_grad_accum_and_remat_on_the_card():
    """Within the card: 2 microbatches against one step of the same batch
    (float32 sums in another order: params within atol 1e-6 of adam's
    1e-3 steps), and remat against no remat bit for bit."""
    _need_card()
    one = _bert_steps(None)
    acc = _bert_steps(None, grad_accum_steps=2)
    remat = _bert_steps(None, remat=True)
    np.testing.assert_allclose(acc[0], one[0], rtol=1e-5)
    for n, p in one[1].items():
        if "attn.key.bias" not in n:
            np.testing.assert_allclose(acc[1][n].numpy(), p.numpy(), rtol=0, atol=1e-6, err_msg=n)
        assert torch.equal(remat[1][n], p), n
    assert remat[0] == one[0]


@pytest.mark.cuda
def test_native_flight_recorder_dumps_on_the_card_machine():
    """The native ring's JSON dump on the card's machine, whose C++ runtime
    differs from the one the library is compiled against (the dump once
    crashed there inside iostreams): a wrapped ring of 2048, escapes and
    full-resolution timestamps."""
    _need_card()
    from pytorch_distributed_example_tpu_torch import _native

    rec = _native.NativeFlightRecorder(2048)
    for i in range(3000):
        rec.record(i, 'all"re\\duce', "default_pg", (8, 3, 5), "float32", 120,
                   1760000000.123456789)
        if i % 2:
            rec.complete(i, "default_pg", i % 3 == 0, 1760000001.5)
    entries = rec.dump_entries()
    rec.close()
    assert len(entries) == 2048 and entries[0]["seq"] == 952 and entries[-1]["seq"] == 2999
    assert entries[0]["op"] == 'all"re\\duce'
    assert [e["state"] for e in entries[-3:]] == ["failed", "enqueued", "completed"]
    assert entries[0]["time_created"] == 1760000000.123456789


@pytest.mark.cuda
def test_checkpoint_round_trips_a_card_tree_bitwise(tmp_path):
    """A bf16 / f32 / int tree on the card through save_checkpoint and
    load_checkpoint: every leaf back on the card, in its dtype, bitwise."""
    from pytorch_distributed_example_tpu_torch.checkpoint import load_checkpoint, save_checkpoint

    _need_card()
    gen = torch.Generator(device="cuda").manual_seed(0)
    tree = {"bf": torch.randn(64, 33, device="cuda", generator=gen).to(torch.bfloat16),
            "f": torch.randn(1000, device="cuda", generator=gen),
            "i": torch.randint(-9, 9, (5, 7), device="cuda", generator=gen, dtype=torch.int32),
            "count": torch.tensor(3, dtype=torch.int64, device="cuda")}
    path = save_checkpoint(str(tmp_path / "ck"), tree, step=4)
    got, _, step, _ = load_checkpoint(path, {k: torch.empty_like(v) for k, v in tree.items()})
    assert step == 4
    for k, v in tree.items():
        assert got[k].device == v.device and got[k].dtype == v.dtype, k
        bits = (lambda t: t.view(torch.int16) if t.dtype == torch.bfloat16 else t)
        assert torch.equal(bits(got[k]), bits(v)), k


@pytest.mark.cuda
def test_grad_scaler_verdict_is_unanimous_on_the_card():
    """One rank row's inf: the min over the rank dim and the group's MIN
    all-reduce both make every rank skip."""
    import pytorch_distributed_example_tpu_torch as tdx
    from pytorch_distributed_example_tpu_torch import amp

    _need_card()
    pg = tdx.init_process_group(world_size=8)
    try:
        scaler = amp.GradScaler(init_scale=2.0 ** 16)
        state = scaler.init("cuda")
        grads = {"w": torch.ones(8, 4, 3, device="cuda"), "b": torch.ones(8, 3, device="cuda")}
        grads["w"][5, 2, 1] = float("inf")
        for kw in ({"axis_name": "dp"}, {"group": pg}):
            out, finite = scaler.unscale(grads, state, **kw)
            assert finite.device.type == "cuda" and not bool(finite), kw
            assert float(scaler.update(state, finite).scale) == 2.0 ** 15
        grads["w"][5, 2, 1] = 1.0
        assert bool(scaler.unscale(grads, state, group=pg)[1])
    finally:
        tdx.destroy_process_group()


@pytest.mark.cuda
def test_dcp_reshards_2_ranks_to_1_on_the_card(tmp_path):
    import pytorch_distributed_example_tpu_torch as tdx
    from pytorch_distributed_example_tpu_torch.dtensor import Shard, distribute_tensor
    from pytorch_distributed_example_tpu_torch.mesh import DeviceMesh

    _need_card()
    gen = torch.Generator(device="cuda").manual_seed(1)
    full = {"w": torch.randn(8, 6, device="cuda", generator=gen),
            "v": torch.randn(16, device="cuda", generator=gen).to(torch.bfloat16)}
    mesh2 = DeviceMesh(["cuda:0"] * 2, (2,), ("fsdp",))
    mesh1 = DeviceMesh(["cuda:0"], (1,), ("fsdp",))
    state = {k: distribute_tensor(v, mesh2, [Shard(0)]) for k, v in full.items()}
    path = tdx.dcp_save(state, str(tmp_path / "two"))
    specs = {"w": ("fsdp",), "v": ("fsdp",)}
    got = tdx.dcp_load(tdx.resharded_template(state, mesh1, specs=specs), path)
    for k, v in full.items():
        assert got[k].device.type == "cuda" and got[k].device_mesh == mesh1
        bits = (lambda t: t.view(torch.int16) if t.dtype == torch.bfloat16 else t)
        assert torch.equal(bits(got[k].full_tensor()), bits(v)), k


# -- multiproc mode on the card: a "cuda:gloo" gang on cuda:0 ------------------

_GANG_CASES = ("all_reduce_sum", "all_reduce_avg", "all_reduce_bf16", "all_gather",
               "reduce_scatter", "all_to_all", "broadcast", "ppermute", "replica_all_reduce")

_GANG_COMMON = '''
import numpy as np
import torch
from pytorch_distributed_example_tpu_torch.nn import functional as TF

CASES = {
    "all_reduce_sum": lambda x: TF.all_reduce(x, "SUM", "dp"),
    "all_reduce_avg": lambda x: TF.all_reduce(x, "AVG", "dp"),
    "all_reduce_bf16": lambda x: TF.all_reduce(x.bfloat16(), "SUM", "dp").float(),
    "all_gather": lambda x: TF.all_gather(x, "dp", 0),
    "reduce_scatter": lambda x: TF.reduce_scatter(x, "dp", 0),
    "all_to_all": lambda x: TF.all_to_all(x, "dp", 0, 1),
    "broadcast": lambda x: TF.broadcast(x, 1, "dp"),
    "ppermute": lambda x: TF.ppermute(x, "dp", [(0, 1), (1, 0)]),
    "replica_all_reduce": lambda x: TF.all_reduce(x, "SUM", "dp", replica=True),
}


def run(x_rows):
    """{case: (y, dx)} of each case on these rows, d(sum(y * y))."""
    out = {}
    for name, fn in CASES.items():
        x = torch.tensor(x_rows, device="cuda", requires_grad=True)
        y = fn(x)
        (y * y).sum().backward()
        out[name] = (y.detach().cpu().numpy(), x.grad.cpu().numpy())
    return out


X = np.random.default_rng(0).standard_normal((2, 64, 32)).astype(np.float32)
'''

_GANG_WORKER = _GANG_COMMON + '''
import pickle, sys
rank, port, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
import pytorch_distributed_example_tpu_torch as tdx
from pytorch_distributed_example_tpu_torch import p2p

tdx.init_process_group(backend="cuda:gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                       world_size=2, timeout=120)
mesh = tdx.init_device_mesh(("dp",), (2,))
with mesh:
    res = run(X[rank:rank + 1])
res["_device"] = str(mesh.device)
res["_staged"] = p2p.STAGING["bytes"]
tdx.destroy_process_group()
with open(out, "wb") as f:
    pickle.dump(res, f)
'''


@pytest.mark.cuda
def test_cuda_gloo_gang_is_driver_mode_bitwise(tmp_path):
    """Two processes on cuda:0 over gloo ("cuda:gloo"), each holding its
    rank's row: every differentiable collective's value and gradient are
    driver mode's at world 2 on the card, bit for bit (every sum is of two
    terms); the ring shift's rows went through pinned host memory."""
    import os
    import pickle
    import socket
    import subprocess
    import sys

    _need_card()
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    script = tmp_path / "worker.py"
    script.write_text(_GANG_WORKER)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = {**os.environ, "OMP_NUM_THREADS": "1",
           "PYTHONPATH": repo + os.pathsep + os.environ.get("PYTHONPATH", "")}
    procs = [subprocess.Popen([sys.executable, str(script), str(r), str(port),
                               str(tmp_path / f"r{r}.pkl")], env=env, cwd=repo,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
             for r in range(2)]
    try:
        outs = [p.communicate(timeout=300)[0].decode() for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r}:\n{out}"
    gang = []
    for r in range(2):
        with open(tmp_path / f"r{r}.pkl", "rb") as f:
            gang.append(pickle.load(f))
    ns = {}
    exec(_GANG_COMMON, ns)
    driver = ns["run"](ns["X"])
    for r, res in enumerate(gang):
        assert res["_device"] == "cuda:0" and res["_staged"] > 0
        for name in _GANG_CASES:
            (y, dx), (wy, wdx) = res[name], driver[name]
            if name == "replica_all_reduce":  # one replica: the whole value
                np.testing.assert_array_equal(y, wy, err_msg=name)
            else:
                np.testing.assert_array_equal(y, wy[r:r + 1], err_msg=f"{name} rank {r}")
            np.testing.assert_array_equal(dx, wdx[r:r + 1], err_msg=f"{name} d rank {r}")


@pytest.mark.cuda
def test_gloo_takes_the_cuda_rows_the_backend_does_not_stage():
    """What `ProcessBackend` hands gloo is what gloo takes: every
    collective takes CUDA tensors on cuda:0 and gives the right values
    (`tests/_torch_gloo_probe.py`), and the backend has no send or recv to
    hand it (the port's p2p, `permute`'s rows included, goes through the
    p2p plane)."""
    import importlib.util
    import os

    from pytorch_distributed_example_tpu_torch.backends import process as bp

    _need_card()
    spec = importlib.util.spec_from_file_location(
        "_torch_gloo_probe", os.path.join(os.path.dirname(__file__), "_torch_gloo_probe.py"))
    probe = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(probe)
    assert "permute" not in vars(bp.ProcessBackend)  # the probe's send_recv: not gloo's
    got = probe.probe(probe.COLLECTIVES)
    assert got == {op: "ok" for op in probe.COLLECTIVES}, got


_PLANE_WORKER = '''
import os, pickle, sys
import torch
rank, port, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
import pytorch_distributed_example_tpu_torch as tdx
from pytorch_distributed_example_tpu_torch import distributed as dist, plan
from pytorch_distributed_example_tpu_torch.tensor import DistTensor

tdx.init_process_group(backend="cuda:gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                       world_size=2, timeout=120)
gen = torch.Generator("cuda").manual_seed(5)
sent = {"bf16": torch.randn(3, 1000, device="cuda", generator=gen).bfloat16(),
        "f32": torch.randn(777, device="cuda", generator=gen)}
res = {}
for name, t in sent.items():
    if rank == 0:
        tdx.send(t, 1)
    else:
        buf = torch.empty_like(t)
        tdx.recv(buf, 0)
        res[name] = bool(torch.equal(buf, t)) and buf.device.type == "cuda"
x = torch.randn(1, 4099, device="cuda", generator=torch.Generator("cuda").manual_seed(rank))
stock = DistTensor.wrap(x.clone())
tdx.all_reduce(stock)
os.environ.update(TDX_COLLECTIVE_PLANNER="1", TDX_PLANNER_FORCE="ring",
                  TDX_PLANNER_PROBE_CACHE="")
ring = DistTensor.wrap(x.clone())
tdx.all_reduce(ring)
res["ring"] = (bool(torch.equal(ring.tensor, stock.tensor)), ring.tensor.device.type,
               plan.planner_for_group(dist._get_default_group()).last_choice)
res["frames"] = (dist._p2p_plane.frames_sent, dist._p2p_plane.frames_received)
tdx.destroy_process_group()
with open(out, "wb") as f:
    pickle.dump(res, f)
'''


@pytest.mark.cuda
def test_p2p_plane_carries_cuda_tensors_between_processes_on_the_card(tmp_path):
    """Two processes on cuda:0 ("cuda:gloo"): CUDA tensors, bf16 and float32,
    go rank 0 -> 1 through the p2p plane (device -> pinned host -> socket
    and back) bit for bit, and the planner's ring all-reduce over the plane
    gives CUDA rows bitwise the stock gloo all_reduce's (two terms a sum)."""
    import os
    import pickle
    import socket
    import subprocess
    import sys

    _need_card()
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    script = tmp_path / "plane.py"
    script.write_text(_PLANE_WORKER)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = {**os.environ, "OMP_NUM_THREADS": "1",
           "PYTHONPATH": repo + os.pathsep + os.environ.get("PYTHONPATH", "")}
    procs = [subprocess.Popen([sys.executable, str(script), str(r), str(port),
                               str(tmp_path / f"p{r}.pkl")], env=env, cwd=repo,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
             for r in range(2)]
    try:
        outs = [p.communicate(timeout=300)[0].decode() for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r}:\n{out}"
    res = []
    for r in range(2):
        with open(tmp_path / f"p{r}.pkl", "rb") as f:
            res.append(pickle.load(f))
    assert res[1]["bf16"] and res[1]["f32"]
    for r in range(2):
        assert res[r]["ring"] == (True, "cuda", ("all_reduce", "ring", "force")), res[r]
    assert res[0]["frames"][0] >= 2 and res[1]["frames"][1] >= 2
