"""The float32 flash kernels' tensor-core arithmetic ("tf32x3"), emulated on
the CPU, for the `tests/test_torch_tf32x3_*.py` files.

The float32 forward, dK/dV and dQ kernels (`csrc/flash_tf32x3.cuh`) split
every operand of every product into a big and a small TF32 half and are
held to the float32 tolerance. Copies of the plain versions of
`ops/flash_attention.py` here take each product as the kernels do, so that
the tests can show the split stays inside that tolerance and a single TF32
pass does not. The kernels themselves are held against the plain versions
on the card by `tests/test_torch_cuda.py` and `chip_smoke.py`.

Every function here runs its tensor arithmetic under one intra-op thread
(`one_thread`): the tensors are small, and the test runner's workers share
the machine's cores, where many threads each would mostly wait on one
another.
"""

import contextlib
import functools
import importlib

import numpy as np
import torch

# the module, not the `flash_attention` function the package exports
tfa = importlib.import_module("pytorch_distributed_example_tpu_torch.ops.flash_attention")

BH, L = 4, 256  # a small L; the head dim is each test's
BLOCK = 64
HEAD_DIMS = [32, 128, 256]  # the trainer's default, the slice's, the largest

# chip_smoke.py's and tests/test_torch_cuda.py's float32 tolerance:
# |got - want| <= rtol * |want| + atol_frac * max|want|
F32_TOL = dict(rtol=1e-4, atol_frac=1e-5)
# chip_smoke.py's tolerance of lse, the same form
LSE_TOL = dict(rtol=1e-5, atol_frac=1e-6)

# keys a stage of the forward kernel (`FwdShape<D>::kBlockK`): its online
# softmax steps over k-tiles of this length, and its O += P V sums each in
# one pair of partials
FWD_BLOCK_K = {32: 64, 64: 64, 128: 32, 256: 16}


@contextlib.contextmanager
def one_thread():
    """The body under one intra-op thread, the count restored on exit."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(old)


def _single_threaded(fn):
    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        with one_thread():
            return fn(*args, **kwargs)
    return wrapped


def tf32(x):
    """x rounded to TF32 on its float32 bits: to nearest (ties away from
    zero), the low 13 mantissa bits cleared."""
    u = x.float().contiguous().view(torch.int32)
    return ((u + 0x1000) & ~0x1FFF).view(torch.float32)


def tf32_truncated(x):
    """x's top 19 bits: the low 13 mantissa bits cleared."""
    return (x.float().contiguous().view(torch.int32) & ~0x1FFF).view(torch.float32)


def mm_tf32x3(a, b, small=tf32):
    """a @ b as the tf32x3 kernels compute it: a = a_big + a_small and b
    likewise, big rounded to TF32, small the remainder taken to TF32 by
    `small`, summed as small*big + big*small + big*big."""
    a_big, b_big = tf32(a), tf32(b)
    a_small, b_small = small(a - a_big), small(b - b_big)
    return a_small @ b_big + a_big @ b_small + a_big @ b_big


def mm_tf32x3_truncated(a, b):
    """`mm_tf32x3` with the small halves truncated: the kernels hand the
    tensor core the exact float32 remainder, of which it reads the top 19
    bits."""
    return mm_tf32x3(a, b, small=tf32_truncated)


def mm_tf32(a, b):
    """a @ b in a single TF32 pass."""
    return tf32(a) @ tf32(b)


def mm_f64(a, b):
    return a.double() @ b.double()


# The tensor core as the kernels drive it: each mma.sync m16n8k8 adds its
# eight exact TF32 products to its float32 accumulator and truncates the sum
# toward zero (on the H100 it also drops addend bits below the largest
# addend's last place, which this leaves out; `tests/_chip_tf32_mma.py`
# measures both). The kernels' products, emulated with that sum, in the
# kernels' order (flash_tf32x3.cuh, above `mma3_score`): a score product
# over the head dim takes each two K-steps' big*big in a partial from 0,
# added with a float32 add, the cross terms in one accumulator beside it;
# an accumulation product sums each tile of rows (32 for the backward's
# emulation, a stage of keys for the forward's) in two partials from 0,
# big*big and the cross terms, added with float32 adds.
MMA_K, ACC_TILE = 8, 32


def rz32(x):
    """float64 x truncated toward zero to float32."""
    f = x.float()
    return torch.where(f.double().abs() > x.abs(), torch.nextafter(f, torch.zeros_like(f)), f)


def steps(a, b):
    """The products of each K-step of a @ b, exact: (..., K / 8, M, N)."""
    return torch.einsum("...mjk,...jkn->...jmn", a.double().unflatten(-1, (-1, MMA_K)),
                        b.double().unflatten(-2, (-1, MMA_K)))


def mma(c, step):
    """c plus one K-step's products, as the tensor core sums them."""
    return rz32(c.double() + step)


def split_tc(a, b):
    """Each K-step's products small*big, big*small and big*big: the big
    halves rounded to TF32, the small ones as the tensor core reads the
    float32 remainder (truncated)."""
    a_big, b_big = tf32(a), tf32(b)
    a_small, b_small = tf32_truncated(a - a_big), tf32_truncated(b - b_big)
    return steps(a_small, b_big), steps(a_big, b_small), steps(a_big, b_big)


def mm_tc_score(a, b):
    """A score product (S, dP, S^T, dP^T) as the kernels take it."""
    sb, bs, bb = split_tc(a, b)
    s = torch.zeros(bb.shape[:-3] + bb.shape[-2:])
    x = torch.zeros_like(s)
    for j in range(0, bb.shape[-3], 2):
        part = torch.zeros_like(s)
        for i in (j, j + 1):
            x = mma(mma(x, sb[..., i, :, :]), bs[..., i, :, :])
            part = mma(part, bb[..., i, :, :])
        s = s + part
    return s + x


def mm_tc_acc(a, b, tile=ACC_TILE):
    """An accumulation product (O, dV, dK, dQ) over one block of the
    sequence as the kernels take it, `tile` rows at a time."""
    sb, bs, bb = split_tc(a, b)
    out = torch.zeros(bb.shape[:-3] + bb.shape[-2:])
    per_tile = tile // MMA_K
    for t in range(0, bb.shape[-3], per_tile):
        part = torch.zeros_like(out)
        x = torch.zeros_like(out)
        for i in range(t, t + per_tile):
            x = mma(mma(x, sb[..., i, :, :]), bs[..., i, :, :])
            part = mma(part, bb[..., i, :, :])
        out = out + (part + x)
    return out


TENSOR_CORE = (mm_tc_score, mm_tc_acc)


def fwd_tensor_core(D):
    """The forward kernel's pair at head dim D: the score product, and the
    accumulation summed over its whole stage of keys."""
    return mm_tc_score, functools.partial(mm_tc_acc, tile=FWD_BLOCK_K[D])


@_single_threaded
def dkdv_split(q, k, v, do, lse, delta, scale, causal, mm):
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


@_single_threaded
def dq_split(q, k, v, do, lse, delta, scale, causal, mm):
    """`_dq_plain` with each of its three products taken by `mm`, the
    register operand dS included; `mm` may be a pair, as `dkdv_split`'s."""
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


@_single_threaded
def fwd_split(q, k, v, scale, causal, mm, block_k):
    """`_fwd_plain` as the forward kernel takes it: S = q k^T by `mm`,
    scaled after the product, and O += P V by `mm` (a pair, as
    `dkdv_split`'s), the online softmax stepping over k-tiles of `block_k`
    keys. Every query row at once: a k-tile wholly above a row's diagonal
    leaves its m, l and O as they are (p = 0, alpha = 1), as the kernel's
    skipped tile does. Returns (o, lse), lse as (BH, L, 1)."""
    mm, acc_mm = mm if isinstance(mm, tuple) else (mm, mm)
    BH_, L_, D = q.shape
    m = torch.full((BH_, L_), tfa.NEG_INF, dtype=torch.float32)
    l = torch.zeros((BH_, L_))
    acc = torch.zeros((BH_, L_, D))
    for j in range(L_ // block_k):
        cols = slice(j * block_k, (j + 1) * block_k)
        s = mm(q, k[:, cols].transpose(1, 2)).float() * scale
        if causal:
            s = tfa._causal_mask(s, 0, j * block_k)
        m_new = torch.maximum(m, s.amax(-1))
        m_safe = torch.where(m_new <= tfa.NEG_INF / 2, 0.0, m_new)
        p = torch.exp(s - m_safe[..., None])
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(-1)
        acc = acc * alpha[..., None] + acc_mm(p, v[:, cols]).float()
        m = m_new
    l_safe = l.clamp_min(1e-30)
    return acc / l_safe[..., None], (m + torch.log(l_safe))[..., None]


def f64_forward(q, k, v, scale, causal):
    """o and lse by the plain forward's arithmetic in float64 (q scaled
    before q k^T), over the whole sequence at once; lse as (BH, L, 1)."""
    L_ = q.shape[1]
    s = (q.double() * scale) @ k.double().transpose(1, 2)
    if causal:
        s = s.masked_fill(torch.ones(L_, L_, dtype=torch.bool).triu(1), tfa.NEG_INF)
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(-1, keepdim=True)
    return p @ v.double() / l, m + torch.log(l)


def excess(got, want, tol=F32_TOL):
    """How far past `tol` the worst entry lies (<= 0 within)."""
    err = (got - want).abs()
    allowed = tol["atol_frac"] * want.abs().max() + tol["rtol"] * want.abs()
    return float((err - allowed).max())


def randn_case(seed, D, n=4, head_scales=1, length=L):
    """n (BH, length, D) float32 tensors drawn from a seed with numpy, the
    heads scaled by 1 .. head_scales."""
    gen = np.random.default_rng(seed)
    heads = torch.arange(BH, dtype=torch.float32).remainder(head_scales).add(1).view(BH, 1, 1)
    return [torch.tensor(gen.standard_normal((BH, length, D)), dtype=torch.float32) * heads
            for _ in range(n)]


@_single_threaded
def f32_case(seed, D, causal):
    """A backward case: q, k, v, dO from a seed, and the plain forward's lse
    and delta."""
    q, k, v, do = randn_case(seed, D)
    scale = D ** -0.5
    o, lse = tfa._fwd_plain(q, k, v, scale, causal, BLOCK, BLOCK)
    delta = (do * o).sum(-1, keepdim=True)
    return (q, k, v, do, lse, delta, scale, causal)


@_single_threaded
def plain_backward(args):
    """{"dq", "dk", "dv"} of the plain versions on a `f32_case`."""
    want = {"dq": tfa._dq_plain(*args, BLOCK, BLOCK)}
    want["dk"], want["dv"] = tfa._dkdv_plain(*args, BLOCK, BLOCK)
    return want


def split_backward(args, mm):
    """{"dq", "dk", "dv"} of the split versions on a `f32_case`."""
    got = {"dq": dq_split(*args, mm)}
    got["dk"], got["dv"] = dkdv_split(*args, mm)
    return got
