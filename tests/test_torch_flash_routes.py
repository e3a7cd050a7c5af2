"""The route rule of the port's flash kernels, their C interface, and the
declared tolerances of the tensor-core routes, on the CPU.

`kernel_route` says which instance serves a (dtype, head dim, role) on the
card: the forward, dK/dV and dQ for bf16 at every padded head dim run on the
tensor cores ("wgmma"); for float32, dK/dV and dQ run on the tensor cores as
three TF32 passes ("tf32x3") and the forward on the SIMT kernel ("simt").
The wgmma route rounds P and dS to bf16 as wgmma operands, so it is held to
`WGMMA_BF16_TOL`; tests below show that rounding alone, done in a copy of
the plain versions kept in this file, stays inside it at head dims 32, 128
and 256. The tf32x3 route splits every operand of every product into a big
and a small TF32 half and is held to the float32 tolerance: copies of the
plain versions that emulate the split stay inside it at the same head dims,
and a single TF32 pass does not. The kernels themselves are held against
the plain versions on the card by `tests/test_torch_cuda.py` and
`chip_smoke.py`.
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


# the route each role takes, by dtype, at every head dim
WANT_ROUTES = {
    torch.bfloat16: {"flash_fwd": "wgmma", "flash_dkdv": "wgmma", "flash_dq": "wgmma"},
    torch.float32: {"flash_fwd": "simt", "flash_dkdv": "tf32x3", "flash_dq": "tf32x3"},
}
ROLES = ("flash_fwd", "flash_dkdv", "flash_dq")


@pytest.mark.parametrize("role", ROLES)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_every_head_dim_has_exactly_one_route(dtype, role):
    for D in range(1, 257):
        route = tfa.kernel_route(dtype, D, role)
        Dp = tfa.kernel_head_dim(D)
        assert route == WANT_ROUTES[dtype][role], (dtype, D, role, route)
        assert Dp in tfa.HEAD_DIMS and Dp >= D
        assert f"{role}:{route}" in tfa.ROUTE_LAUNCHES
    # the role is always named: the routes differ by role for float32
    with pytest.raises(TypeError):
        tfa.kernel_route(dtype, 128)


def test_route_launch_counts_name_exactly_the_routes():
    """ROUTE_LAUNCHES has one count for each (role, route) the rule can give,
    and no other."""
    want = {f"{role}:{routes[role]}" for routes in WANT_ROUTES.values() for role in ROLES}
    assert set(tfa.ROUTE_LAUNCHES) == want


@pytest.mark.parametrize("dtype, D", [
    (torch.bfloat16, 272), (torch.float32, 512), (torch.float16, 64),
    (torch.float64, 128), (torch.int32, 64),
])
def test_route_raises_off_the_instances(dtype, D):
    for role in ROLES:
        with pytest.raises(ValueError, match="head dim|has no Hopper kernel"):
            tfa.kernel_route(dtype, D, role)


@pytest.mark.parametrize("name, dtype, D, want", [
    ("flash_fwd", torch.bfloat16, 128, (128, "wgmma")),
    ("flash_fwd", torch.bfloat16, 96, (128, "wgmma")),
    ("flash_fwd", torch.bfloat16, 48, (64, "wgmma")),
    ("flash_fwd", torch.bfloat16, 32, (32, "wgmma")),
    ("flash_fwd", torch.bfloat16, 200, (256, "wgmma")),
    ("flash_fwd", torch.float32, 128, (128, "simt")),
    ("flash_dkdv", torch.float32, 128, (128, "tf32x3")),
    ("flash_dq", torch.float32, 96, (128, "tf32x3")),
    ("flash_dkdv", torch.float32, 200, (256, "tf32x3")),
    ("flash_dq", torch.bfloat16, 32, (32, "wgmma")),
])
def test_operand_check_names_the_padded_dim_and_route(name, dtype, D, want):
    q = torch.zeros(2, 64, D, dtype=dtype)
    assert tfa._check_kernel_operands(name, q, q, q) == want


@pytest.mark.parametrize("name, Dp, route, rows", [
    ("flash_fwd", 128, "wgmma", 128), ("flash_dkdv", 128, "wgmma", 128),
    ("flash_dq", 256, "wgmma", 128), ("flash_dkdv", 256, "wgmma", 64),
    ("flash_dkdv", 32, "wgmma", 128), ("flash_fwd", 128, "simt", 64),
    ("flash_fwd", 256, "simt", 32), ("flash_dkdv", 64, "tf32x3", 128),
    ("flash_dkdv", 128, "tf32x3", 64), ("flash_dkdv", 256, "tf32x3", 64),
    ("flash_dq", 128, "tf32x3", 128), ("flash_dq", 256, "tf32x3", 64),
])
def test_grid_limit_follows_the_launched_instance(name, Dp, route, rows):
    """The row tile the grid check divides L by is the one the launched
    instance's blocks own: dK/dV at D 256 owns 64 keys a block on the wgmma
    route (its two warpgroups split dK and dV), the other wgmma instances
    128 rows; the tf32x3 instances 128 rows, but 64 keys for dK/dV from D
    128 (split the same way) and 64 rows for dQ at D 256; the SIMT forward
    its `tile_rows`."""
    assert tfa._kernel_tile(name, Dp, route) == rows


@pytest.mark.parametrize("route", ["wgmma", "tf32x3"])
def test_wgmma_route_refuses_unaligned_operands(route):
    """Both tensor-core routes read their tiles through TMA."""
    flat = torch.zeros(2 * 64 * 128 + 1, dtype=torch.bfloat16)
    q = flat[1:].view(2, 64, 128)
    assert q.is_contiguous() and q.data_ptr() % 16
    with pytest.raises(ValueError, match=f"the {route} route needs 16-byte aligned"):
        tfa._check_tma_aligned("flash_dq", route, q)


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
    so ctypes passes each pointer whole; the instances of one role take the
    same arguments on every route."""
    found = _c_functions()
    assert set(tfa._SIGNATURES) == set(found)
    for name, (argtypes, restype) in tfa._SIGNATURES.items():
        assert len(argtypes) == found[name], name
    assert tfa._SIGNATURES["flash_fwd_wgmma"] == tfa._SIGNATURES["flash_fwd"]
    for role in ("flash_dkdv", "flash_dq"):
        assert tfa._SIGNATURES[f"{role}_tf32x3"] == tfa._SIGNATURES[f"{role}_wgmma"]
    for name in ("flash_wgmma_smem_bytes", "flash_tf32x3_smem_bytes"):
        assert tfa._SIGNATURES[name] == ([ctypes.c_int, ctypes.c_int], ctypes.c_int)


def test_every_launched_name_has_a_c_function():
    """The wrappers launch `{role}_{route}` for the tensor-core routes and
    the bare role for the SIMT forward: each has a declared C function."""
    for dtype, routes in WANT_ROUTES.items():
        for role, route in routes.items():
            fn = role if route == "simt" else f"{role}_{route}"
            assert fn in tfa._SIGNATURES, (dtype, role, fn)


# ---------------------------------------------------------------------------
# the declared tolerance: P and dS rounded to bf16 in copies of the plain
# versions, against the unchanged plain versions
# ---------------------------------------------------------------------------

BH, L = 4, 256  # a small L; the head dim is each test's
BLOCK = 64
HEAD_DIMS = [32, 128, 256]  # the trainer's default, the slice's, the largest


def _bf16(x):
    return x.to(torch.bfloat16).float()


def _fwd_rounding_p(q, k, v, scale, causal):
    """`_fwd_plain` with P rounded to bf16 before P.V, as the wgmma forward
    feeds it to the tensor cores; l still sums the f32 probabilities."""
    D = q.shape[-1]
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
    D = q.shape[-1]
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
    D = q.shape[-1]
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


def _inputs(seed, D):
    gen = np.random.default_rng(seed)
    return [torch.tensor(gen.standard_normal((BH, L, D)), dtype=torch.float32)
            .to(torch.bfloat16) for _ in range(4)]


@pytest.mark.parametrize("D", HEAD_DIMS)
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32])
def test_rounding_p_stays_within_declared_tolerance(causal, out_dtype, D):
    q, k, v, _ = _inputs(40 + causal, D)
    scale = D ** -0.5
    want, _ = tfa._fwd_plain(q, k, v, scale, causal, BLOCK, BLOCK, out_dtype=out_dtype)
    got = _fwd_rounding_p(q, k, v, scale, causal).to(out_dtype)
    _within_wgmma_tol(got, want, "o")


@pytest.mark.parametrize("D", HEAD_DIMS)
@pytest.mark.parametrize("causal", [False, True])
def test_rounding_p_and_ds_stays_within_declared_tolerance(causal, D):
    q, k, v, do = _inputs(50 + causal, D)
    scale = D ** -0.5
    o, lse = tfa._fwd_plain(q, k, v, scale, causal, BLOCK, BLOCK)
    delta = (do.float() * o.float()).sum(-1, keepdim=True)
    want = tfa._dkdv_plain(q, k, v, do, lse, delta, scale, causal, BLOCK, BLOCK)
    got = _dkdv_rounding_p_ds(q, k, v, do, lse, delta, scale, causal)
    for name, g, w in zip(("dk", "dv"), got, want):
        _within_wgmma_tol(g.to(torch.bfloat16), w, name)


@pytest.mark.parametrize("D", HEAD_DIMS)
@pytest.mark.parametrize("causal", [False, True])
def test_rounding_ds_in_dq_stays_within_declared_tolerance(causal, D):
    q, k, v, do = _inputs(60 + causal, D)
    scale = D ** -0.5
    o, lse = tfa._fwd_plain(q, k, v, scale, causal, BLOCK, BLOCK)
    delta = (do.float() * o.float()).sum(-1, keepdim=True)
    want = tfa._dq_plain(q, k, v, do, lse, delta, scale, causal, BLOCK, BLOCK)
    got = _dq_rounding_ds(q, k, v, do, lse, delta, scale, causal)
    _within_wgmma_tol(got.to(torch.bfloat16), want, "dq")


# ---------------------------------------------------------------------------
# the tf32x3 route: every product of the float32 dK/dV and dQ kernels as
# three TF32 passes, in copies of the plain versions, against the unchanged
# plain versions at the float32 tolerance
# ---------------------------------------------------------------------------

# chip_smoke.py's and tests/test_torch_cuda.py's float32 tolerance:
# |got - want| <= rtol * |want| + atol_frac * max|want|
F32_TOL = dict(rtol=1e-4, atol_frac=1e-5)


def _tf32(x):
    """x rounded to TF32 on its float32 bits: to nearest (ties away from
    zero), the low 13 mantissa bits cleared."""
    u = x.float().contiguous().view(torch.int32)
    return ((u + 0x1000) & ~0x1FFF).view(torch.float32)


def _tf32_truncated(x):
    """x's top 19 bits: the low 13 mantissa bits cleared."""
    return (x.float().contiguous().view(torch.int32) & ~0x1FFF).view(torch.float32)


def _mm_tf32x3(a, b, small=_tf32):
    """a @ b as the tf32x3 kernels compute it: a = a_big + a_small and b
    likewise, big rounded to TF32, small the remainder taken to TF32 by
    `small`, summed as small*big + big*small + big*big."""
    a_big, b_big = _tf32(a), _tf32(b)
    a_small, b_small = small(a - a_big), small(b - b_big)
    return a_small @ b_big + a_big @ b_small + a_big @ b_big


def _mm_tf32x3_truncated(a, b):
    """`_mm_tf32x3` with the small halves truncated: the kernels hand the
    tensor core the exact float32 remainder, of which it reads the top 19
    bits."""
    return _mm_tf32x3(a, b, small=_tf32_truncated)


def _mm_tf32(a, b):
    """a @ b in a single TF32 pass."""
    return _tf32(a) @ _tf32(b)


# The tensor core as the kernels drive it: each mma.sync m16n8k8 adds its
# eight exact TF32 products to its float32 accumulator and truncates the sum
# toward zero (on the H100 it also drops addend bits below the largest
# addend's last place, which this leaves out; `tests/_chip_tf32_mma.py`
# measures both). The kernels' products, emulated with that sum, in the
# kernels' order (flash_tf32x3.cuh, above `mma3_score`): a score product
# over the head dim takes each two K-steps' big*big in a partial from 0,
# added with a float32 add, the cross terms in one accumulator beside it;
# an accumulation product sums each tile of 32 rows in two partials from 0,
# big*big and the cross terms, added with float32 adds.
_MMA_K, _ACC_TILE = 8, 32


def _rz32(x):
    """float64 x truncated toward zero to float32."""
    f = x.float()
    return torch.where(f.double().abs() > x.abs(), torch.nextafter(f, torch.zeros_like(f)), f)


def _steps(a, b):
    """The products of each K-step of a @ b, exact: (..., K / 8, M, N)."""
    return torch.einsum("...mjk,...jkn->...jmn", a.double().unflatten(-1, (-1, _MMA_K)),
                        b.double().unflatten(-2, (-1, _MMA_K)))


def _mma(c, step):
    """c plus one K-step's products, as the tensor core sums them."""
    return _rz32(c.double() + step)


def _split_tc(a, b):
    """Each K-step's products small*big, big*small and big*big: the big
    halves rounded to TF32, the small ones as the tensor core reads the
    float32 remainder (truncated)."""
    a_big, b_big = _tf32(a), _tf32(b)
    a_small, b_small = _tf32_truncated(a - a_big), _tf32_truncated(b - b_big)
    return _steps(a_small, b_big), _steps(a_big, b_small), _steps(a_big, b_big)


def _mm_tc_score(a, b):
    """A score product (S, dP, S^T, dP^T) as the kernels take it."""
    sb, bs, bb = _split_tc(a, b)
    s = torch.zeros(bb.shape[:-3] + bb.shape[-2:])
    x = torch.zeros_like(s)
    for j in range(0, bb.shape[-3], 2):
        part = torch.zeros_like(s)
        for i in (j, j + 1):
            x = _mma(_mma(x, sb[..., i, :, :]), bs[..., i, :, :])
            part = _mma(part, bb[..., i, :, :])
        s = s + part
    return s + x


def _mm_tc_acc(a, b):
    """An accumulation product (dV, dK, dQ) over one block of the sequence
    as the kernels take it, tile by tile."""
    sb, bs, bb = _split_tc(a, b)
    out = torch.zeros(bb.shape[:-3] + bb.shape[-2:])
    per_tile = _ACC_TILE // _MMA_K
    for t in range(0, bb.shape[-3], per_tile):
        part = torch.zeros_like(out)
        x = torch.zeros_like(out)
        for i in range(t, t + per_tile):
            x = _mma(_mma(x, sb[..., i, :, :]), bs[..., i, :, :])
            part = _mma(part, bb[..., i, :, :])
        out = out + (part + x)
    return out


_TENSOR_CORE = (_mm_tc_score, _mm_tc_acc)


def _dkdv_split(q, k, v, do, lse, delta, scale, causal, mm):
    """`_dkdv_plain` with each of its four products taken by `mm`, the
    register operands P^T and dS^T included; `mm` may be a pair, (the score
    products' S^T and dP^T, the accumulations' dV and dK)."""
    mm, acc_mm = mm if isinstance(mm, tuple) else (mm, mm)
    D = q.shape[-1]
    dk = torch.empty(q.shape, dtype=torch.float32)
    dv = torch.empty_like(dk)
    for j in range(L // BLOCK):
        cols = slice(j * BLOCK, (j + 1) * BLOCK)
        kb, vb = k[:, cols], v[:, cols]
        dkb = torch.zeros((BH, BLOCK, D))
        dvb = torch.zeros_like(dkb)
        for i in range(j if causal else 0, L // BLOCK):
            rows = slice(i * BLOCK, (i + 1) * BLOCK)
            qb, dob = q[:, rows], do[:, rows]
            st = mm(kb, qb.transpose(1, 2)) * scale  # S^T, keys by queries
            if causal:
                st = tfa._causal_mask(st.transpose(1, 2), i * BLOCK, j * BLOCK).transpose(1, 2)
            pt = torch.exp(st - lse[:, rows].transpose(1, 2))
            dvb = dvb + acc_mm(pt, dob)
            dst = pt * (mm(vb, dob.transpose(1, 2)) - delta[:, rows].transpose(1, 2))
            dkb = dkb + acc_mm(dst, qb) * scale
        dk[:, cols], dv[:, cols] = dkb, dvb
    return dk, dv


def _dq_split(q, k, v, do, lse, delta, scale, causal, mm):
    """`_dq_plain` with each of its three products taken by `mm`, the
    register operand dS included; `mm` may be a pair, as `_dkdv_split`'s."""
    mm, acc_mm = mm if isinstance(mm, tuple) else (mm, mm)
    D = q.shape[-1]
    dq = torch.empty(q.shape, dtype=torch.float32)
    for i in range(L // BLOCK):
        rows = slice(i * BLOCK, (i + 1) * BLOCK)
        qb, dob = q[:, rows], do[:, rows]
        dqb = torch.zeros((BH, BLOCK, D))
        for j in range(i + 1 if causal else L // BLOCK):
            cols = slice(j * BLOCK, (j + 1) * BLOCK)
            kb, vb = k[:, cols], v[:, cols]
            s = mm(qb, kb.transpose(1, 2)) * scale
            if causal:
                s = tfa._causal_mask(s, i * BLOCK, j * BLOCK)
            p = torch.exp(s - lse[:, rows])
            ds = p * (mm(dob, vb.transpose(1, 2)) - delta[:, rows])
            dqb = dqb + acc_mm(ds, kb) * scale
        dq[:, rows] = dqb
    return dq


def _f32_excess(got, want):
    """How far past the float32 tolerance the worst entry lies (<= 0 within)."""
    err = (got - want).abs()
    allowed = F32_TOL["atol_frac"] * want.abs().max() + F32_TOL["rtol"] * want.abs()
    return float((err - allowed).max())


def _f32_case(seed, D, causal):
    gen = np.random.default_rng(seed)
    q, k, v, do = (torch.tensor(gen.standard_normal((BH, L, D)), dtype=torch.float32)
                   for _ in range(4))
    scale = D ** -0.5
    o, lse = tfa._fwd_plain(q, k, v, scale, causal, BLOCK, BLOCK)
    delta = (do * o).sum(-1, keepdim=True)
    return (q, k, v, do, lse, delta, scale, causal)


@pytest.mark.parametrize("mm", [_mm_tf32x3, _mm_tf32x3_truncated, _TENSOR_CORE],
                         ids=["nearest", "truncated", "tensor core"])
@pytest.mark.parametrize("D", HEAD_DIMS)
@pytest.mark.parametrize("causal", [False, True])
def test_tf32x3_split_keeps_float32_accuracy(causal, D, mm):
    """The split within the float32 tolerance, its small halves rounded to
    nearest or truncated (as the tensor core reads them), and with the
    tensor core's truncating sums in the kernels' order."""
    args = _f32_case(70 + causal, D, causal)
    want = {"dq": tfa._dq_plain(*args, BLOCK, BLOCK)}
    want["dk"], want["dv"] = tfa._dkdv_plain(*args, BLOCK, BLOCK)
    got = {"dq": _dq_split(*args, mm)}
    got["dk"], got["dv"] = _dkdv_split(*args, mm)
    for name in want:
        excess = _f32_excess(got[name], want[name])
        assert excess <= 0, f"{name}: {excess:.3e} past the float32 tolerance {F32_TOL}"


@pytest.mark.parametrize("D", HEAD_DIMS)
def test_one_tf32_pass_misses_float32_accuracy(D):
    """The tolerance has teeth: a single TF32 pass over the same products
    lands far outside it, for each output."""
    args = _f32_case(80, D, True)
    want = {"dq": tfa._dq_plain(*args, BLOCK, BLOCK)}
    want["dk"], want["dv"] = tfa._dkdv_plain(*args, BLOCK, BLOCK)
    got = {"dq": _dq_split(*args, _mm_tf32)}
    got["dk"], got["dv"] = _dkdv_split(*args, _mm_tf32)
    for name in want:
        assert _f32_excess(got[name], want[name]) > 0, name


def test_tf32_rounding_clears_the_low_bits_to_nearest():
    x = torch.tensor([1.0 + 2 ** -11, 1.0 + 2 ** -10 + 2 ** -11, -(1.0 + 3 * 2 ** -12), 3.0])
    got = _tf32(x)
    assert got.tolist() == [1.0 + 2 ** -10, 1.0 + 2 ** -9, -(1.0 + 2 ** -10), 3.0]
    assert not bool((got.view(torch.int32) & 0x1FFF).any())


def _mm_f64(a, b):
    return a.double() @ b.double()


@pytest.mark.parametrize("D", HEAD_DIMS)
def test_tf32x3_split_as_exact_as_float32_on_large_logits(D):
    """Heads scaled by 1 to 4 (logits up to 16 times as large): there the
    plain float32 versions themselves stand ~1e-5 of max from a float64
    copy of the same arithmetic (on the same float32 lse and delta), and
    the split as the kernels take it (small halves truncated, the tensor
    core's truncating sums in the kernels' order) stands no farther from it
    than twice that. `tests/test_torch_cuda.py` holds the kernels to the
    same bound on the card."""
    gen = np.random.default_rng(90)
    heads = torch.arange(1, BH + 1, dtype=torch.float32).view(BH, 1, 1)
    q, k, v, do = (torch.tensor(gen.standard_normal((BH, L, D)), dtype=torch.float32) * heads
                   for _ in range(4))
    scale = D ** -0.5
    o, lse = tfa._fwd_plain(q, k, v, scale, True, BLOCK, BLOCK)
    args = (q, k, v, do, lse, (do * o).sum(-1, keepdim=True), scale, True)
    exact = (*_dkdv_split(*args, _mm_f64), _dq_split(*args, _mm_f64))
    plain = (*tfa._dkdv_plain(*args, BLOCK, BLOCK), tfa._dq_plain(*args, BLOCK, BLOCK))
    split = (*_dkdv_split(*args, _TENSOR_CORE), _dq_split(*args, _TENSOR_CORE))
    for name, e, p, s in zip(("dk", "dv", "dq"), exact, plain, split):
        plain_err, split_err = float((p - e).abs().max()), float((s - e).abs().max())
        assert split_err <= 2 * plain_err, (name, split_err, plain_err)
