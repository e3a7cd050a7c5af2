"""The route rule of the port's flash kernels, their C interface, and the
declared tolerance of the bf16 route, on the CPU.

`kernel_route` says which instance serves a (dtype, head dim, role) on the
card: the forward, dK/dV and dQ for bf16 at every padded head dim run on the
tensor cores ("wgmma"), and for float32 on the tensor cores as three TF32
passes ("tf32x3"). The wgmma route rounds P and dS to bf16 as wgmma
operands, so it is held to `WGMMA_BF16_TOL`; tests below show that rounding
alone, done in a copy of the plain versions kept in this file, stays inside
it at head dims 32, 128 and 256. The tf32x3 route's arithmetic is emulated
by `tests/_tf32x3_emulation.py` and held to the float32 tolerance in
`tests/test_torch_tf32x3_*.py`. The kernels themselves are held against the
plain versions on the card by `tests/test_torch_cuda.py` and
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
    torch.float32: {"flash_fwd": "tf32x3", "flash_dkdv": "tf32x3", "flash_dq": "tf32x3"},
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
    ("flash_fwd", torch.float32, 128, (128, "tf32x3")),
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
    ("flash_dkdv", 32, "wgmma", 128), ("flash_fwd", 128, "tf32x3", 128),
    ("flash_fwd", 256, "tf32x3", 128), ("flash_dkdv", 64, "tf32x3", 128),
    ("flash_dkdv", 128, "tf32x3", 64), ("flash_dkdv", 256, "tf32x3", 64),
    ("flash_dq", 128, "tf32x3", 128), ("flash_dq", 256, "tf32x3", 64),
])
def test_grid_limit_follows_the_launched_instance(name, Dp, route, rows):
    """The row tile the grid check divides L by is the one the launched
    instance's blocks own: dK/dV at D 256 owns 64 keys a block on the wgmma
    route (its two warpgroups split dK and dV), the other wgmma instances
    128 rows; the tf32x3 instances 128 rows (the forward at every D), but
    64 keys for dK/dV from D 128 (split the same way) and 64 rows for dQ at
    D 256."""
    assert tfa._kernel_tile(name, Dp, route) == rows


@pytest.mark.parametrize("role", ROLES)
@pytest.mark.parametrize("route", ["wgmma", "tf32x3"])
def test_wgmma_route_refuses_unaligned_operands(route, role):
    """Both routes read their tiles through TMA: each wrapper refuses an
    operand off a 16-byte boundary before it launches (the check comes
    before the launch, so CPU tensors reach it here)."""
    dtype = {"wgmma": torch.bfloat16, "tf32x3": torch.float32}[route]
    flat = torch.zeros(2 * 64 * 128 + 1, dtype=dtype)
    q = flat[1:].view(2, 64, 128)
    assert q.is_contiguous() and q.data_ptr() % 16
    assert tfa.kernel_route(dtype, 128, role) == route
    rows = torch.zeros(2, 64, 1)
    call = {
        "flash_fwd": lambda: tfa._fwd_cuda(q, q, q, 0.1, True),
        "flash_dkdv": lambda: tfa._dkdv_cuda(q, q, q, q, rows, rows, 0.1, True),
        "flash_dq": lambda: tfa._dq_cuda(q, q, q, q, rows, rows, 0.1, True),
    }[role]
    tfa.reset_launch_counts()
    with pytest.raises(ValueError, match=f"{role}: the {route} route needs 16-byte aligned"):
        call()
    assert not any(tfa.LAUNCHES.values())


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
    for role in ROLES:
        assert tfa._SIGNATURES[f"{role}_tf32x3"] == tfa._SIGNATURES[f"{role}_wgmma"]
    for name in ("flash_wgmma_smem_bytes", "flash_tf32x3_smem_bytes"):
        assert tfa._SIGNATURES[name] == ([ctypes.c_int, ctypes.c_int], ctypes.c_int)


def test_every_launched_name_has_a_c_function():
    """The wrappers launch `{role}_{route}`: each has a declared C function,
    and no C function is left that no route launches."""
    launched = set()
    for dtype, routes in WANT_ROUTES.items():
        for role, route in routes.items():
            fn = f"{role}_{route}"
            assert fn in tfa._SIGNATURES, (dtype, role, fn)
            launched.add(fn)
    assert {fn for fn in _c_functions() if fn.startswith(ROLES)} == launched


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
