"""Flash attention: forward, dK/dV and dQ as hand-written Hopper kernels.

The port of the JAX package's `ops/flash_attention.py`, with its contracts:

* The public API takes (B, L, H, D); the kernels work on (B*H, L, D).
* `flash_with_lse` returns `(o, lse)`, lse as (B*H, L, 1) float32, and is
  differentiable through both outputs: the lse cotangent folds into the
  backward as `delta = rowsum(dO*O) - dlse`.
* `_fwd(..., out_dtype=None)`, `_dkdv_call` and `_dq_call` keep the
  reference's signatures (minus `interpret`): ring attention calls them
  with its own lse/delta.
* L must tile by the block sizes (`ValueError` otherwise).

Dispatch is by the tensors' device. A CUDA tensor goes to the kernel in
`csrc/flash_attention.cu` (built at first use, see `_build.py`) or raises;
there is no fallback. A CPU tensor goes to the kernel's plain version in
this module: the same blocked online-softmax arithmetic as the Pallas
kernels, in float32, which the CPU tests hold against the reference.

On the card the kernels use their own tiles for any L and mask the ragged
edge; `block_q`/`block_k` set the plain versions' blocking and the tiling
check. One kernel per role covers both of the reference's lowerings, the
VMEM-resident one and the streamed one (`TDX_FLASH_STREAM`, L*D past 1.5M
elements at bf16): it streams the counterpart tiles through shared memory
at every L. The kernels are instantiated for head dims 32, 64, 128 and 256
and for bf16 and float32 operands. Any other head dim up to 256 is
zero-padded to the next instance and the result sliced back (zero columns
leave q k^T unchanged and give zero output columns; the scale stays 1/sqrt
of the true D); a head dim above 256, as in the reference's `_flash_ok`
gate, raises.

Routes. `kernel_route` is the one rule that says which instance serves a
(dtype, head dim, role) on the card. bf16 operands run all three roles on
the tensor cores at every (padded) head dim ("wgmma": wgmma on bf16 tiles fed
by TMA, `csrc/flash_wgmma.cuh`). float32 operands run all three roles on the
tensor cores at float32 accuracy ("tf32x3": every product as three TF32
passes of mma.sync, `csrc/flash_tf32x3.cuh`). Nothing catches a failed build
or launch and tries another instance. Both routes scale q k^T after the
product, where the plain forward (as the Pallas kernel) scales q before it.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch
from torch.autograd.function import once_differentiable

from . import _build

NEG_INF = -1e30

# head dims the Hopper kernels are instantiated for, on every route; others
# up to the last are zero-padded to the next one
HEAD_DIMS = (32, 64, 128, 256)

# the route of each role, by operand dtype, at every head dim
ROUTES = {
    torch.bfloat16: {"flash_fwd": "wgmma", "flash_dkdv": "wgmma", "flash_dq": "wgmma"},
    torch.float32: {"flash_fwd": "tf32x3", "flash_dkdv": "tf32x3", "flash_dq": "tf32x3"},
}

# launches of each kernel since the last reset_launch_counts(); a wrapper
# adds one where it launches its kernel, and nowhere else. LAUNCHES counts by
# role, ROUTE_LAUNCHES by role and route ("flash_fwd:wgmma", ...)
LAUNCHES = {"flash_fwd": 0, "flash_dkdv": 0, "flash_dq": 0}
ROUTE_LAUNCHES = {f"{role}:{route}": 0 for role in LAUNCHES
                  for route in sorted({r[role] for r in ROUTES.values()})}

# How far the wgmma route's outputs (o in bf16 or float32, dK, dV, dQ) may
# stand from the plain versions, which stay float32 throughout: entrywise
# |got - want| <= rtol * |want| + atol_frac * max|want|. The route rounds P
# (forward, dV) and dS (dK, dQ) to bf16 as wgmma operands, 2**-9 relative per
# entry, on top of rounding a bf16 output once as the plain version does
# (which rtol 2**-7 covers). One output entry sums many such rounded terms of
# both signs, so its error is a share of the entry's spread, not of its
# value: an entry near zero can be off by about 1e-3 of max|want|, past the
# atol of 1e-3 * max that rounding a bf16 output alone needs (`BF16_TOL` in
# chip_smoke.py). 4e-3 leaves room for that and for the longer
# tails of many more entries at L 16384. tests/test_torch_flash_routes.py
# holds the rounding alone to it on the CPU; chip_smoke.py holds the kernels
# to it on the card and prints how much of the atol each check uses
# (PERF.md). The float32 route (tf32x3) keeps the float32 tolerance.
WGMMA_BF16_TOL = dict(rtol=2 ** -7, atol_frac=4e-3)

# Block sizes measured on the H100, keyed like the reference's
# flash_tuned.json ("L{seq}", "default_long" with "applies_from",
# "default"). Empty until a sweep on the card fills it; the reference's
# table was measured on a TPU and is not read.
H100_TUNED: dict = {}

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    "flash_fwd_wgmma": ([_P] * 5 + [_I, _I, _I, _F, _I, _I, _I, _P], _I),
    "flash_dkdv_wgmma": ([_P] * 8 + [_I, _I, _I, _F, _I, _I, _P], _I),
    "flash_dq_wgmma": ([_P] * 7 + [_I, _I, _I, _F, _I, _I, _P], _I),
    "flash_fwd_tf32x3": ([_P] * 5 + [_I, _I, _I, _F, _I, _I, _I, _P], _I),
    "flash_dkdv_tf32x3": ([_P] * 8 + [_I, _I, _I, _F, _I, _I, _P], _I),
    "flash_dq_tf32x3": ([_P] * 7 + [_I, _I, _I, _F, _I, _I, _P], _I),
    "flash_wgmma_smem_bytes": ([_I, _I], _I),
    "flash_tf32x3_smem_bytes": ([_I, _I], _I),
    "flash_error_string": ([_I], ctypes.c_char_p),
}
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}  # the C side's DType


def _kernel_tile(name: str, Dp: int, route: str) -> int:
    """Rows of the output tile one block of the instance that `name`
    launches owns at padded head dim Dp: its grid is ceil(L / this) blocks
    high. 128 rows, but on wgmma 64 keys for dK/dV at D 256
    (`Shape<D>::kKvRows`), and on tf32x3 64 keys for dK/dV from D 128
    (`KvShape<D>::kKeys`) and 64 rows for dQ at D 256 (`DqShape<D>::kRows`);
    the tf32x3 forward owns 128 rows at every D (`FwdShape<D>::kRows`)."""
    if route == "tf32x3" and name == "flash_dkdv":
        return 64 if Dp > 64 else 128
    if route == "tf32x3" and name == "flash_dq":
        return 64 if Dp > 128 else 128
    return 64 if name == "flash_dkdv" and Dp > 128 else 128


def reset_launch_counts() -> None:
    for counts in (LAUNCHES, ROUTE_LAUNCHES):
        for name in counts:
            counts[name] = 0


# ---------------------------------------------------------------------------
# plain versions: the Pallas kernels' arithmetic in PyTorch, for CPU tensors
# ---------------------------------------------------------------------------


def _causal_mask(s, q_start, k_start):
    bq, bk = s.shape[-2:]
    q_pos = q_start + torch.arange(bq, device=s.device)[:, None]
    k_pos = k_start + torch.arange(bk, device=s.device)[None, :]
    return s.masked_fill(q_pos < k_pos, NEG_INF)


def _fwd_plain(q, k, v, scale, causal, block_q, block_k, out_dtype=None):
    """`_fwd_kernel`'s online softmax, one q-block at a time."""
    BH, L, D = q.shape
    f32 = dict(dtype=torch.float32, device=q.device)
    o = torch.empty((BH, L, D), dtype=out_dtype or q.dtype, device=q.device)
    lse = torch.empty((BH, L, 1), **f32)
    for i in range(L // block_q):
        q_start = i * block_q
        qb = q[:, q_start:q_start + block_q].float() * scale
        m = torch.full((BH, block_q), NEG_INF, **f32)
        l = torch.zeros((BH, block_q), **f32)
        acc = torch.zeros((BH, block_q, D), **f32)
        num_k = (q_start + block_q - 1) // block_k + 1 if causal else L // block_k
        for j in range(num_k):
            kb = k[:, j * block_k:(j + 1) * block_k].float()
            vb = v[:, j * block_k:(j + 1) * block_k].float()
            s = qb @ kb.transpose(1, 2)
            if causal:
                s = _causal_mask(s, q_start, j * block_k)
            m_new = torch.maximum(m, s.amax(-1))
            m_safe = torch.where(m_new <= NEG_INF / 2, 0.0, m_new)
            p = torch.exp(s - m_safe[..., None])
            alpha = torch.exp(m - m_new)  # both -1e30 -> 1, and acc is 0
            l = l * alpha + p.sum(-1)
            acc = acc * alpha[..., None] + p @ vb
            m = m_new
        l_safe = l.clamp_min(1e-30)
        o[:, q_start:q_start + block_q] = (acc / l_safe[..., None]).to(o.dtype)
        lse[:, q_start:q_start + block_q, 0] = m + torch.log(l_safe)
    return o, lse


def _dkdv_plain(q, k, v, do, lse, delta, scale, causal, block_q, block_k):
    """`_bwd_dkdv_kernel`: per k-block, a loop over the q-blocks that reach it."""
    BH, L, D = q.shape
    dk = torch.empty_like(q)
    dv = torch.empty_like(q)
    for j in range(L // block_k):
        k_start = j * block_k
        kb = k[:, k_start:k_start + block_k].float()
        vb = v[:, k_start:k_start + block_k].float()
        dkb = torch.zeros((BH, block_k, D), dtype=torch.float32, device=q.device)
        dvb = torch.zeros_like(dkb)
        first_q = k_start // block_q if causal else 0
        for i in range(first_q, L // block_q):
            rows = slice(i * block_q, (i + 1) * block_q)
            qb = q[:, rows].float()
            dob = do[:, rows].float()
            s = (qb @ kb.transpose(1, 2)) * scale
            if causal:
                s = _causal_mask(s, i * block_q, k_start)
            p = torch.exp(s - lse[:, rows])  # masked -> exp(-1e30 - lse) = 0
            dvb = dvb + p.transpose(1, 2) @ dob
            dp = dob @ vb.transpose(1, 2)
            dlogits = p * (dp - delta[:, rows])
            dkb = dkb + (dlogits.transpose(1, 2) @ qb) * scale
        dk[:, k_start:k_start + block_k] = dkb.to(dk.dtype)
        dv[:, k_start:k_start + block_k] = dvb.to(dv.dtype)
    return dk, dv


def _dq_plain(q, k, v, do, lse, delta, scale, causal, block_q, block_k):
    """`_bwd_dq_kernel`: per q-block, a loop over k-blocks up to the diagonal."""
    BH, L, D = q.shape
    dq = torch.empty_like(q)
    for i in range(L // block_q):
        q_start = i * block_q
        rows = slice(q_start, q_start + block_q)
        qb = q[:, rows].float()
        dob = do[:, rows].float()
        dqb = torch.zeros((BH, block_q, D), dtype=torch.float32, device=q.device)
        num_k = (q_start + block_q - 1) // block_k + 1 if causal else L // block_k
        for j in range(num_k):
            kb = k[:, j * block_k:(j + 1) * block_k].float()
            vb = v[:, j * block_k:(j + 1) * block_k].float()
            s = (qb @ kb.transpose(1, 2)) * scale
            if causal:
                s = _causal_mask(s, q_start, j * block_k)
            p = torch.exp(s - lse[:, rows])
            dp = dob @ vb.transpose(1, 2)
            dlogits = p * (dp - delta[:, rows])
            dqb = dqb + (dlogits @ kb) * scale
        dq[:, rows] = dqb.to(dq.dtype)
    return dq


# ---------------------------------------------------------------------------
# kernel wrappers: CUDA tensors only
# ---------------------------------------------------------------------------


def _launch(fn: str, device, *args) -> None:
    lib = _build.load("flash_attention", _SIGNATURES)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = getattr(lib, fn)(*args, stream)
    if err != 0:
        raise RuntimeError(
            f"{fn} failed: CUDA error {err} "
            f"({lib.flash_error_string(err).decode()})"
        )


def kernel_head_dim(D: int) -> int:
    """The instantiated head dim the kernels run D at: the smallest of
    HEAD_DIMS that holds it. Raises above the last."""
    for Dp in HEAD_DIMS:
        if D <= Dp:
            return Dp
    raise ValueError(
        f"head dim {D} exceeds the Hopper kernels' limit of {HEAD_DIMS[-1]}"
    )


def pad_head_dim(x, Dp: int):
    """x (..., D) zero-padded to (..., Dp); x itself when D == Dp."""
    D = x.shape[-1]
    return x if D == Dp else torch.nn.functional.pad(x, (0, Dp - D))


def _unpad(x, D: int):
    return x if x.shape[-1] == D else x[..., :D].contiguous()


def kernel_route(dtype, D: int, role: str) -> str:
    """The instance that serves `role` ("flash_fwd", "flash_dkdv" or
    "flash_dq") for `dtype` operands at head dim D on the card: "wgmma"
    for every bf16 role, "tf32x3" for every float32 role, at every head
    dim (`ROUTES`).
    Raises for D above 256 and for a dtype with no kernel."""
    kernel_head_dim(D)  # raises above 256
    if dtype not in ROUTES:
        raise ValueError(
            f"dtype {dtype} has no Hopper kernel; supported dtypes are "
            f"{tuple(ROUTES)}"
        )
    return ROUTES[dtype][role]


def _check_kernel_operands(name, q, *others):
    """(padded head dim, route) for operands the kernels take; raises on
    the rest."""
    BH, L, D = q.shape
    try:
        route = kernel_route(q.dtype, D, name)
    except ValueError as e:
        raise ValueError(f"{name}: {e}") from None
    Dp = kernel_head_dim(D)
    if -(-L // _kernel_tile(name, Dp, route)) > 65535:
        raise ValueError(f"{name}: seq len {L} exceeds the kernel grid")
    for t in (q, *others):
        if t.device != q.device:
            raise ValueError(f"{name}: operands on {t.device} and {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: operands must be contiguous")
    return Dp, route


def _check_tma_aligned(name, route, *ts):
    # TMA reads tiles from 16-byte aligned addresses only
    if any(t.data_ptr() % 16 for t in ts):
        raise ValueError(f"{name}: the {route} route needs 16-byte aligned operands")


def _count(name: str, route: str) -> None:
    LAUNCHES[name] += 1
    ROUTE_LAUNCHES[f"{name}:{route}"] += 1


def _fwd_cuda(q, k, v, scale, causal, out_dtype=None):
    BH, L, D = q.shape
    Dp, route = _check_kernel_operands("flash_fwd", q, k, v)
    out_dtype = out_dtype or q.dtype
    if out_dtype not in (q.dtype, torch.float32):
        raise ValueError(f"flash_fwd: out_dtype {out_dtype} for {q.dtype} operands")
    q, k, v = (pad_head_dim(t, Dp) for t in (q, k, v))
    _check_tma_aligned("flash_fwd", route, q, k, v)
    o = torch.empty((BH, L, Dp), dtype=out_dtype, device=q.device)
    lse = torch.empty((BH, L, 1), dtype=torch.float32, device=q.device)
    _launch(
        f"flash_fwd_{route}", q.device,
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
        BH, L, Dp, float(scale), int(causal),
        _DTYPE_CODES[q.dtype], _DTYPE_CODES[out_dtype],
    )
    _count("flash_fwd", route)
    return _unpad(o, D), lse


def _dkdv_cuda(q, k, v, do, lse, delta, scale, causal):
    BH, L, D = q.shape
    Dp, route = _check_kernel_operands("flash_dkdv", q, k, v, do, lse, delta)
    q, k, v, do = (pad_head_dim(t, Dp) for t in (q, k, v, do))
    _check_tma_aligned("flash_dkdv", route, q, k, v, do)
    dk = torch.empty_like(q)
    dv = torch.empty_like(q)
    _launch(
        f"flash_dkdv_{route}", q.device,
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        BH, L, Dp, float(scale), int(causal), _DTYPE_CODES[q.dtype],
    )
    _count("flash_dkdv", route)
    return _unpad(dk, D), _unpad(dv, D)


def _dq_cuda(q, k, v, do, lse, delta, scale, causal):
    BH, L, D = q.shape
    Dp, route = _check_kernel_operands("flash_dq", q, k, v, do, lse, delta)
    q, k, v, do = (pad_head_dim(t, Dp) for t in (q, k, v, do))
    _check_tma_aligned("flash_dq", route, q, k, v, do)
    dq = torch.empty_like(q)
    _launch(
        f"flash_dq_{route}", q.device,
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
        BH, L, Dp, float(scale), int(causal), _DTYPE_CODES[q.dtype],
    )
    _count("flash_dq", route)
    return _unpad(dq, D)


# ---------------------------------------------------------------------------
# the reference's private entry points, dispatched by device
# ---------------------------------------------------------------------------


def _check_call(q, k, v, block_q, block_k, do=None, lse=None, delta=None):
    ops = [t for t in (q, k, v, do) if t is not None]
    if q.dim() != 3 or any(t.shape != q.shape for t in ops):
        raise ValueError("q, k, v (and dO) must share one (BH, L, D) shape: "
                         f"{[tuple(t.shape) for t in ops]}")
    if any(t.dtype != q.dtype for t in ops):
        raise ValueError(f"operand dtypes differ: {[t.dtype for t in ops]}")
    L = q.shape[1]
    if L % block_q or L % block_k:
        raise ValueError(
            f"seq len {L} must be divisible by block sizes ({block_q},{block_k})"
        )
    for t in (lse, delta):
        if t is not None and (t.shape != (q.shape[0], L, 1) or t.dtype != torch.float32):
            raise ValueError(f"lse/delta must be (BH, L, 1) float32, got "
                             f"{tuple(t.shape)} {t.dtype}")
    if q.device.type not in ("cuda", "cpu"):
        raise ValueError(f"flash attention runs on cuda or cpu tensors, not {q.device}")


def _fwd(q, k, v, scale, causal, block_q, block_k, out_dtype=None):
    """q, k, v: (BH, L, D) -> (o, lse). `out_dtype` overrides o's dtype
    (default q.dtype): ring attention asks for float32 partials."""
    _check_call(q, k, v, block_q, block_k)
    if q.is_cuda:
        return _fwd_cuda(q, k, v, scale, causal, out_dtype)
    return _fwd_plain(q, k, v, scale, causal, block_q, block_k, out_dtype)


def _dkdv_call(q, k, v, do, lse, delta, scale, causal, block_q, block_k):
    """(dK, dV) given precomputed lse and delta."""
    _check_call(q, k, v, block_q, block_k, do, lse, delta)
    if q.is_cuda:
        return _dkdv_cuda(q, k, v, do, lse, delta, scale, causal)
    return _dkdv_plain(q, k, v, do, lse, delta, scale, causal, block_q, block_k)


def _dq_call(q, k, v, do, lse, delta, scale, causal, block_q, block_k):
    """dQ given precomputed lse and delta."""
    _check_call(q, k, v, block_q, block_k, do, lse, delta)
    if q.is_cuda:
        return _dq_cuda(q, k, v, do, lse, delta, scale, causal)
    return _dq_plain(q, k, v, do, lse, delta, scale, causal, block_q, block_k)


def _bwd(q, k, v, o, lse, do, scale, causal, block_q, block_k, dlse=None):
    delta = (do.float() * o.float()).sum(-1, keepdim=True)
    if dlse is not None:
        # d(lse)/d(logits) = softmax = p, so the lse cotangent folds in as
        # dlogits = p * (dp - delta + dlse)
        delta = delta - dlse.float()
    dk, dv = _dkdv_call(q, k, v, do, lse, delta, scale, causal, block_q, block_k)
    dq = _dq_call(q, k, v, do, lse, delta, scale, causal, block_q, block_k)
    return dq, dk, dv


# ---------------------------------------------------------------------------
# public API
# ---------------------------------------------------------------------------


def _unwrap_grad(t):
    """`t` without the wrapper of the innermost `torch.func` grad
    transform: under `vjp` the backward sees its tensors wrapped at the
    transform's level, which hold no storage a kernel can read. A tensor
    still wrapped after that is under a second grad transform, which
    would differentiate the backward: it is first-order only, so that
    raises."""
    from torch._C._functorch import get_unwrapped, is_gradtrackingtensor

    if t is not None and is_gradtrackingtensor(t):
        t = get_unwrapped(t)
        if is_gradtrackingtensor(t):
            raise NotImplementedError("flash attention's backward is first-order: it does "
                                      "not run under nested grad transforms")
    return t


class _FlashWithLse(torch.autograd.Function):
    """(o, lse) of contiguous (BH, L, D) operands, in the `forward` +
    `setup_context` form that `torch.func` transforms take: `vjp` and
    `grad` run the backward below (on the unwrapped tensors: it is
    first-order), and `vmap` folds its batched dim into B·H (the rows are
    independent), so the kernels still launch once for every batched row,
    and the result is the per-row loop's bit for bit."""

    @staticmethod
    def forward(q, k, v, scale, causal, block_q, block_k):
        return _fwd(q, k, v, scale, causal, block_q, block_k)

    @staticmethod
    def setup_context(ctx, inputs, output):
        q, k, v, scale, causal, block_q, block_k = inputs
        ctx.save_for_backward(q, k, v, *output)
        ctx.args = (scale, causal, block_q, block_k)
        # an output with no consumer gets None, not a tensor of zeros
        ctx.set_materialize_grads(False)

    @staticmethod
    @once_differentiable
    def backward(ctx, do, dlse):
        q, k, v, o, lse = (_unwrap_grad(t) for t in ctx.saved_tensors)
        do, dlse = _unwrap_grad(do), _unwrap_grad(dlse)
        scale, causal, block_q, block_k = ctx.args
        do = torch.zeros_like(o) if do is None else do.contiguous()
        dq, dk, dv = _bwd(q, k, v, o, lse, do, scale, causal, block_q,
                          block_k, dlse=dlse)
        return dq, dk, dv, None, None, None, None

    @staticmethod
    def vmap(info, in_dims, q, k, v, scale, causal, block_q, block_k):
        n = info.batch_size

        def fold(x, d):  # (..., n at d, ...) -> (n * BH, L, D)
            x = x.unsqueeze(0).expand(n, *x.shape) if d is None else x.movedim(d, 0)
            return x.reshape(n * x.shape[1], *x.shape[2:]).contiguous()

        q, k, v = (fold(x, d) for x, d in zip((q, k, v), in_dims[:3]))
        o, lse = _FlashWithLse.apply(q, k, v, scale, causal, block_q, block_k)
        return (o.unflatten(0, (n, -1)), lse.unflatten(0, (n, -1))), (0, 0)


def flash_with_lse(q, k, v, scale, causal, block_q, block_k):
    """(o, lse) over (BH, L, D), differentiable through both outputs, and
    through `torch.func`'s `vjp`, `grad` and `vmap`."""
    return _FlashWithLse.apply(q.contiguous(), k.contiguous(), v.contiguous(), scale, causal,
                               block_q, block_k)


def _to_bh(x):
    # (B, L, H, D) -> (B*H, L, D)
    B, L, H, D = x.shape
    return x.transpose(1, 2).reshape(B * H, L, D)


def _from_bh(x, B, H):
    BH, L, D = x.shape
    return x.reshape(B, H, L, D).transpose(1, 2)


def resolved_block_sizes(
    L: int,
    block_q: Optional[int] = None,
    block_k: Optional[int] = None,
) -> tuple:
    """The (block_q, block_k) `flash_attention` uses for length L: a
    per-call block, clamped to L (one that cannot tile L still raises),
    else the H100 table's (exact-L row, then "default_long" from its
    "applies_from", then "default"), fitted to tile L, else 128."""
    row = H100_TUNED.get(f"L{L}")
    long_row = H100_TUNED.get("default_long") or {}
    if row is None and long_row and L >= int(long_row.get("applies_from", 1 << 62)):
        row = long_row
    if row is None:
        row = H100_TUNED.get("default") or {}

    def fit(b):
        # clamp to L, then halve until it tiles; fall back to 128 where
        # halving a non-power-of-two passes every divisor
        b = min(b, L)
        while b > 128 and L % b:
            b //= 2
        if L % b:
            b = min(128, L)
        return b

    block_q = fit(int(row.get("block_q", 128))) if block_q is None else min(block_q, L)
    block_k = fit(int(row.get("block_k", 128))) if block_k is None else min(block_k, L)
    return block_q, block_k


def flash_attention(
    q,
    k,
    v,
    causal: bool = False,
    scale: Optional[float] = None,
    block_q: Optional[int] = None,
    block_k: Optional[int] = None,
):
    """Flash attention over (B, L, H, D) tensors; differentiable.

    L must be divisible by the block sizes (`resolved_block_sizes`)."""
    B, L, H, D = q.shape
    if scale is None:
        scale = 1.0 / (D ** 0.5)
    bq, bk = resolved_block_sizes(L, block_q, block_k)
    o, _ = flash_with_lse(_to_bh(q), _to_bh(k), _to_bh(v), scale, causal, bq, bk)
    return _from_bh(o, B, H)


def gather_paged_kv(pool_k, pool_v, block_tables, k_scale=None, v_scale=None,
                    out_dtype=None):
    """Each row's logical K/V layout out of a paged block pool (reference
    `ops/flash_attention.py:809-847`), a plain torch gather: no kernel
    stands behind it in either package.

    pool_k/pool_v: (num_blocks, block_size, KV, Dh); block_tables: (B, nb)
    integer ids. Returns ((B, nb*block_size, KV, Dh),) * 2 in logical
    position order. An id past the pool's last block reads the last block,
    as XLA's gather clamps it; the caller's causal mask hides what it
    reads. (The serve pool's last block is its sink, `serve/cache.py`, so
    there the id `num_blocks` marking an unallocated block is in range.)

    With `k_scale`/`v_scale` ((num_blocks, block_size, KV) float32, the
    int8 pool's scale planes) the gather dequantizes: the int8 payload
    times its scale, cast to `out_dtype` (float32 by default)."""
    B, nb = block_tables.shape
    _, bs, KV, Dh = pool_k.shape
    idx = block_tables.long().clamp(0, pool_k.shape[0] - 1)

    def one(pool, scale):
        g = pool[idx]  # (B, nb, bs, KV, Dh)
        if scale is not None:
            g = (g.float() * scale[idx][..., None]).to(out_dtype or torch.float32)
        return g.reshape(B, nb * bs, KV, Dh)

    return one(pool_k, k_scale), one(pool_v, v_scale)
