"""The route rule of the port's flash kernels, their C interface, and the
wgmma route's declared tolerance, on the CPU.

`kernel_route` says which instance serves a (dtype, head dim) on the card:
the forward, dK/dV and dQ for bf16 at a padded D of 64 or 128 run on the
tensor cores ("wgmma"), the rest on the float32 SIMT kernels ("simt"). The
wgmma route rounds P and dS to bf16 as wgmma operands, so it is held to
`WGMMA_BF16_TOL`; the last tests show that rounding alone, done in a copy of
the plain versions kept in this file, stays inside it. The kernels themselves
are held against the plain versions on the card by `tests/test_torch_cuda.py`
and `chip_smoke.py`.
"""

import ctypes
import importlib
import re
from pathlib import Path

import numpy as np
import pytest
import torch

tfa = importlib.import_module("pytorch_distributed_example_tpu_torch.ops.flash_attention")

CSRC = Path(tfa.__file__).resolve().parent.parent / "csrc"


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_every_head_dim_has_exactly_one_route(dtype):
    for D in range(1, 257):
        route = tfa.kernel_route(dtype, D)
        Dp = tfa.kernel_head_dim(D)
        want = "wgmma" if dtype == torch.bfloat16 and Dp in (64, 128) else "simt"
        assert route == want, (dtype, D, route)
        assert f"flash_fwd:{route}" in tfa.ROUTE_LAUNCHES
        assert f"flash_dkdv:{route}" in tfa.ROUTE_LAUNCHES
        assert f"flash_dq:{route}" in tfa.ROUTE_LAUNCHES


@pytest.mark.parametrize("dtype, D", [
    (torch.bfloat16, 272), (torch.float32, 512), (torch.float16, 64),
    (torch.float64, 128), (torch.int32, 64),
])
def test_route_raises_off_the_instances(dtype, D):
    with pytest.raises(ValueError, match="head dim|has no Hopper kernel"):
        tfa.kernel_route(dtype, D)


@pytest.mark.parametrize("dtype, D, want", [
    (torch.bfloat16, 128, (128, "wgmma")), (torch.bfloat16, 96, (128, "wgmma")),
    (torch.bfloat16, 48, (64, "wgmma")), (torch.bfloat16, 32, (32, "simt")),
    (torch.bfloat16, 200, (256, "simt")), (torch.float32, 128, (128, "simt")),
])
def test_operand_check_names_the_padded_dim_and_route(dtype, D, want):
    q = torch.zeros(2, 64, D, dtype=dtype)
    assert tfa._check_kernel_operands("flash_fwd", q, q, q) == want


def test_wgmma_route_refuses_unaligned_operands():
    flat = torch.zeros(2 * 64 * 128 + 1, dtype=torch.bfloat16)
    q = flat[1:].view(2, 64, 128)
    assert q.is_contiguous() and q.data_ptr() % 16
    with pytest.raises(ValueError, match="16-byte aligned"):
        tfa._check_tma_aligned("flash_fwd", q)


def test_plain_versions_count_no_launches():
    gen = np.random.default_rng(0)
    q, k, v = (torch.tensor(gen.standard_normal((2, 64, 128)), dtype=torch.bfloat16)
               for _ in range(3))
    tfa.reset_launch_counts()
    tfa._fwd(q, k, v, 128 ** -0.5, True, 32, 32)
    assert not any(tfa.LAUNCHES.values()) and not any(tfa.ROUTE_LAUNCHES.values())


def _c_functions():
    """name -> number of parameters of each extern "C" function in csrc."""
    src = (CSRC / "flash_attention.cu").read_text()
    body = src[src.index('extern "C" {'):]
    found = {}
    for m in re.finditer(r"^(?:int|const char\*) (\w+)\(([^)]*)\)", body, re.M):
        found[m.group(1)] = len([a for a in m.group(2).split(",") if a.strip()])
    return found


def test_signatures_declare_every_c_function():
    """Every C function is declared for ctypes with its full argument list,
    so ctypes passes each pointer whole; the wgmma entry points take the
    SIMT ones' arguments."""
    found = _c_functions()
    assert set(tfa._SIGNATURES) == set(found)
    for name, (argtypes, restype) in tfa._SIGNATURES.items():
        assert len(argtypes) == found[name], name
    for role in ("flash_fwd", "flash_dkdv", "flash_dq"):
        assert tfa._SIGNATURES[f"{role}_wgmma"] == tfa._SIGNATURES[role]
    assert tfa._SIGNATURES["flash_wgmma_smem_bytes"] == (
        [ctypes.c_int, ctypes.c_int], ctypes.c_int)


# ---------------------------------------------------------------------------
# the declared tolerance: P and dS rounded to bf16 in copies of the plain
# versions, against the unchanged plain versions
# ---------------------------------------------------------------------------

BH, L, D = 4, 256, 128  # the slice's head dim, a small L
BLOCK = 64


def _bf16(x):
    return x.to(torch.bfloat16).float()


def _fwd_rounding_p(q, k, v, scale, causal):
    """`_fwd_plain` with P rounded to bf16 before P.V, as the wgmma forward
    feeds it to the tensor cores; l still sums the f32 probabilities."""
    o = torch.empty(q.shape, dtype=torch.float32)
    for i in range(L // BLOCK):
        q_start = i * BLOCK
        qb = q[:, q_start:q_start + BLOCK].float()
        m = torch.full((BH, BLOCK), tfa.NEG_INF)
        l = torch.zeros((BH, BLOCK))
        acc = torch.zeros((BH, BLOCK, D))
        num_k = i + 1 if causal else L // BLOCK
        for j in range(num_k):
            kb = k[:, j * BLOCK:(j + 1) * BLOCK].float()
            vb = v[:, j * BLOCK:(j + 1) * BLOCK].float()
            s = (qb @ kb.transpose(1, 2)) * scale
            if causal:
                s = tfa._causal_mask(s, q_start, j * BLOCK)
            m_new = torch.maximum(m, s.amax(-1))
            m_safe = torch.where(m_new <= tfa.NEG_INF / 2, 0.0, m_new)
            p = torch.exp(s - m_safe[..., None])
            alpha = torch.exp(m - m_new)
            l = l * alpha + p.sum(-1)
            acc = acc * alpha[..., None] + _bf16(p) @ vb
            m = m_new
        o[:, q_start:q_start + BLOCK] = acc / l.clamp_min(1e-30)[..., None]
    return o


def _dkdv_rounding_p_ds(q, k, v, do, lse, delta, scale, causal):
    """`_dkdv_plain` with P and dS rounded to bf16 before dV += P^T dO and
    dK += dS^T Q, as the wgmma dK/dV kernel feeds them."""
    dk = torch.empty(q.shape, dtype=torch.float32)
    dv = torch.empty_like(dk)
    for j in range(L // BLOCK):
        cols = slice(j * BLOCK, (j + 1) * BLOCK)
        kb, vb = k[:, cols].float(), v[:, cols].float()
        dkb = torch.zeros((BH, BLOCK, D))
        dvb = torch.zeros_like(dkb)
        for i in range(j if causal else 0, L // BLOCK):
            rows = slice(i * BLOCK, (i + 1) * BLOCK)
            qb, dob = q[:, rows].float(), do[:, rows].float()
            s = (qb @ kb.transpose(1, 2)) * scale
            if causal:
                s = tfa._causal_mask(s, i * BLOCK, j * BLOCK)
            p = torch.exp(s - lse[:, rows])
            dvb = dvb + _bf16(p).transpose(1, 2) @ dob
            ds = p * (dob @ vb.transpose(1, 2) - delta[:, rows])
            dkb = dkb + (_bf16(ds).transpose(1, 2) @ qb) * scale
        dk[:, cols], dv[:, cols] = dkb, dvb
    return dk, dv


def _dq_rounding_ds(q, k, v, do, lse, delta, scale, causal):
    """`_dq_plain` with dS rounded to bf16 before dQ += dS K, as the wgmma
    dQ kernel feeds it."""
    dq = torch.empty(q.shape, dtype=torch.float32)
    for i in range(L // BLOCK):
        rows = slice(i * BLOCK, (i + 1) * BLOCK)
        qb, dob = q[:, rows].float(), do[:, rows].float()
        dqb = torch.zeros((BH, BLOCK, D))
        for j in range(i + 1 if causal else L // BLOCK):
            cols = slice(j * BLOCK, (j + 1) * BLOCK)
            kb, vb = k[:, cols].float(), v[:, cols].float()
            s = (qb @ kb.transpose(1, 2)) * scale
            if causal:
                s = tfa._causal_mask(s, i * BLOCK, j * BLOCK)
            p = torch.exp(s - lse[:, rows])
            ds = p * (dob @ vb.transpose(1, 2) - delta[:, rows])
            dqb = dqb + (_bf16(ds) @ kb) * scale
        dq[:, rows] = dqb
    return dq


def _within_wgmma_tol(got, want, name):
    tol = tfa.WGMMA_BF16_TOL
    err = (got.float() - want.float()).abs()
    allowed = tol["atol_frac"] * want.float().abs().max() + tol["rtol"] * want.float().abs()
    worst = float((err - allowed).max())
    assert worst <= 0, f"{name}: {worst:.3e} past the declared tolerance {tol}"


def _inputs(seed):
    gen = np.random.default_rng(seed)
    return [torch.tensor(gen.standard_normal((BH, L, D)), dtype=torch.float32)
            .to(torch.bfloat16) for _ in range(4)]


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32])
def test_rounding_p_stays_within_declared_tolerance(causal, out_dtype):
    q, k, v, _ = _inputs(40 + causal)
    scale = D ** -0.5
    want, _ = tfa._fwd_plain(q, k, v, scale, causal, BLOCK, BLOCK, out_dtype=out_dtype)
    got = _fwd_rounding_p(q, k, v, scale, causal).to(out_dtype)
    _within_wgmma_tol(got, want, "o")


@pytest.mark.parametrize("causal", [False, True])
def test_rounding_p_and_ds_stays_within_declared_tolerance(causal):
    q, k, v, do = _inputs(50 + causal)
    scale = D ** -0.5
    o, lse = tfa._fwd_plain(q, k, v, scale, causal, BLOCK, BLOCK)
    delta = (do.float() * o.float()).sum(-1, keepdim=True)
    want = tfa._dkdv_plain(q, k, v, do, lse, delta, scale, causal, BLOCK, BLOCK)
    got = _dkdv_rounding_p_ds(q, k, v, do, lse, delta, scale, causal)
    for name, g, w in zip(("dk", "dv"), got, want):
        _within_wgmma_tol(g.to(torch.bfloat16), w, name)


@pytest.mark.parametrize("causal", [False, True])
def test_rounding_ds_in_dq_stays_within_declared_tolerance(causal):
    q, k, v, do = _inputs(60 + causal)
    scale = D ** -0.5
    o, lse = tfa._fwd_plain(q, k, v, scale, causal, BLOCK, BLOCK)
    delta = (do.float() * o.float()).sum(-1, keepdim=True)
    want = tfa._dq_plain(q, k, v, do, lse, delta, scale, causal, BLOCK, BLOCK)
    got = _dq_rounding_ds(q, k, v, do, lse, delta, scale, causal)
    _within_wgmma_tol(got.to(torch.bfloat16), want, "dq")
