"""Context parallelism: ring attention and Ulysses, in both modes.

The port of the JAX package's `parallel/context_parallel.py`. There each
rank holds its sequence shard inside `shard_map`: ring attention moves the
KV shards one hop around the ring with `lax.ppermute`, Ulysses reshards
with `lax.all_to_all`. The port runs the ranks two ways:

* **driver mode**: the W ranks' shards are one rank-stacked tensor (W, B,
  L/W, H, D) on one device, the layout of the reference's own driver
  mode. The ring shift i -> i+1 is `torch.roll(x, 1, dims=0)`, a rank's
  `axis_index` its index along dim 0, and Ulysses' all_to_all a reshape
  and permute of the stacked dims;
* **multiproc mode**: inside an entered multiproc mesh whose axes include
  `axis_name` (`mesh.py`), a process holds its own shard (1, B, L/W, H,
  D). The ring shift is the c10d core's isend/irecv pair
  (`distributed.permute`, `ProcessBackend.permute`), the causal skip
  reads this process's axis index, and Ulysses' reshard is the all_to_all
  of the axis's group (`nn.functional.all_to_all`).

The reference's per-step kernel choice (`lax.cond` on the origin of the
KV shard a rank holds) is a slice of the rank dim. At step 0 every rank
runs the causal kernel on its own shard. At step s > 0, ranks r >= s hold
an earlier rank's shard and run the non-causal kernel, and ranks r < s
hold a later one and skip it (o = 0, lse = -1e30). In driver mode the
active ranks fold into B*H, so each ring step is one launch of each
kernel; in multiproc mode rank r launches each kernel r + 1 times a call,
and a rank that skips a step still takes part in its shifts.

`make_cp_attention(mesh, axis_name, ...)` takes and returns global (B, L,
H, D) tensors, the sequence split over the W ranks of the mesh's
`axis_name`; a bare world size W stands in for a driver-mode mesh as well.
"""

from __future__ import annotations

import functools
import inspect
from typing import Callable, Optional

import torch

from .. import mesh as _mesh
from ..nn import functional as nnf
from ..ops.flash_attention import _dkdv_call, _dq_call, _fwd, resolved_block_sizes
from ..ops.reference import dense_attention

NEG_INF = -1e30

# "auto" picks the flash block kernel once a shard's dense f32 scores
# (B, H, Lq, Lk) would pass this many bytes per ring step
AUTO_FLASH_SCORE_BYTES = 256 * (1 << 20)


def auto_block_kernel(B: int, H: int, Lq: int, Lk: int) -> str:
    """The reference's `block_kernel="auto"` rule: "flash" when the dense
    block's scores would pass 256 MB and the shards tile by the flash block
    sizes, else "dense"."""
    bq, bk = resolved_block_sizes(min(Lq, Lk))
    divisible = Lq % bq == 0 and Lk % bk == 0 and Lq == Lk
    big = B * H * Lq * Lk * 4 > AUTO_FLASH_SCORE_BYTES
    return "flash" if divisible and big else "dense"


# ---------------------------------------------------------------------------
# ring attention, dense block
# ---------------------------------------------------------------------------


def _local_attention_block(q, k, v, mask, scale):
    """Every rank's (q-shard x kv-shard) partial: (unnormalised o, m, l).

    q: (W, B, Lq, H, D); k, v: (W, B, Lk, H, D); mask: (W, Lq, Lk) or None.
    m and l, the running max and normaliser, are (W, B, H, Lq)."""
    s = torch.einsum("wbqhd,wbkhd->wbhqk", q.float(), k.float()) * scale
    if mask is not None:
        s = s.masked_fill(~mask[:, None, None], NEG_INF)
    m = s.amax(-1)
    # a fully masked row keeps m = -1e30 but normalises against 0, so p is 0
    m_safe = torch.where(m <= NEG_INF / 2, 0.0, m)
    p = torch.exp(s - m_safe[..., None])
    l = p.sum(-1)
    o = torch.einsum("wbhqk,wbkhd->wbqhd", p.to(v.dtype), v)
    return o, m, l


def _ring_perm(W: int):
    return [(i, (i + 1) % W) for i in range(W)]


def _ring_dense(q, k, v, causal, scale, axis_name="sp"):
    Wl, B, Lq, H, D = q.shape
    Lk = k.shape[2]
    b = _mesh.axis_binding(axis_name)
    W = Wl if b is None else b.size
    f32 = dict(dtype=torch.float32, device=q.device)
    o = torch.zeros((Wl, B, Lq, H, D), **f32)
    m = torch.full((Wl, B, H, Lq), NEG_INF, **f32)
    l = torch.zeros((Wl, B, H, Lq), **f32)
    r = nnf.rank_ids(axis_name, W, q.device)
    k_cur, v_cur = k, v
    for s in range(W):
        mask = None
        if causal:
            src = (r - s) % W  # the owner of the KV shard each rank holds
            q_pos = r[:, None, None] * Lq + torch.arange(Lq, device=q.device)[None, :, None]
            k_pos = src[:, None, None] * Lk + torch.arange(Lk, device=q.device)[None, None, :]
            mask = q_pos >= k_pos
        ob, mb, lb = _local_attention_block(q, k_cur, v_cur, mask, scale)
        m_new = torch.maximum(m, mb)
        alpha = torch.exp(m - m_new)  # rescales the accumulator
        beta = torch.exp(mb - m_new)  # rescales the new block
        l = l * alpha + lb * beta
        o = o * alpha.transpose(2, 3)[..., None] + ob.float() * beta.transpose(2, 3)[..., None]
        m = m_new
        if b is None:
            k_cur, v_cur = torch.roll(k_cur, 1, 0), torch.roll(v_cur, 1, 0)
        elif s < W - 1:  # the differentiable shift: its backward sends the other way
            k_cur, v_cur = (nnf.ppermute(t, axis_name, _ring_perm(W)) for t in (k_cur, v_cur))
    l = l.clamp_min(1e-30)
    return (o / l.transpose(2, 3)[..., None]).to(q.dtype)


# ---------------------------------------------------------------------------
# ring attention, flash block: the kernels once per ring step
# ---------------------------------------------------------------------------


def _ring_steps(W: int, causal: bool):
    """(first active rank, causal kernel?) for each ring step."""
    for s in range(W):
        yield (s, s == 0) if causal else (0, False)


def _fold(x):
    # ranks r.. of (W, BH, L, ...) -> (n*BH, L, ...), one kernel launch
    return x.reshape(-1, *x.shape[2:])


def _steps(q, causal, b):
    """(step, local start) of each ring step at which this process's rows
    from `start` on are active (driver mode: all W rows held; multiproc:
    this process's one row, active from its own rank's step on)."""
    W, lo = (q.shape[0], 0) if b is None else (b.size, b.index)
    for s, (a, diag) in enumerate(_ring_steps(W, causal)):
        yield s, max(a - lo, 0), diag


def _shifted(ts, b, last: bool):
    """The ring shift i -> i+1 of each tensor: `torch.roll` in driver mode,
    the core's isend/irecv over b's group in multiproc mode (where the
    KV shards are not sent on after the `last` step)."""
    if b is None:
        return [torch.roll(t, 1, 0) for t in ts]
    return [nnf._core("permute", t[0], b, _ring_perm(b.size)).unsqueeze(0)
            if not last else t for t in ts]


def _ring_flash_fwd(q, k, v, causal, scale, bq, bk, b=None):
    """(W, BH, L, D) ring forward: (o in q's dtype, lse). Each step's
    partial comes from the kernel's f32 accumulator (`out_dtype=f32`) and
    combines exactly by log-sum-exp."""
    o = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    lse = torch.full(q.shape[:3] + (1,), NEG_INF, dtype=torch.float32, device=q.device)
    k_cur, v_cur = k, v
    W = q.shape[0] if b is None else b.size
    for s, a, diag in _steps(q, causal, b):
        if a < q.shape[0]:  # a rank that skips the step still shifts
            o_b, lse_b = _fwd(_fold(q[a:]), _fold(k_cur[a:]), _fold(v_cur[a:]), scale, diag,
                              bq, bk, out_dtype=torch.float32)
            o_b, lse_b = o_b.view(o[a:].shape), lse_b.view(lse[a:].shape)
            lse_new = torch.logaddexp(lse[a:], lse_b)
            o[a:] = o[a:] * torch.exp(lse[a:] - lse_new) + o_b * torch.exp(lse_b - lse_new)
            lse[a:] = lse_new
        k_cur, v_cur = _shifted((k_cur, v_cur), b, s == W - 1)
    return o.to(q.dtype), lse


class _RingFlash(torch.autograd.Function):
    """The reference's custom ring VJP (`_ring_core_fwd`/`_ring_core_bwd`).

    Residuals are (q, k, v, o, lse), all of one shard's size. The backward
    rotates the KV shards around the ring once more; at each step the flash
    backward kernels run with the ring's final lse and delta, so each
    step's partials are exact pieces of the global gradient and just sum.
    Each shard's dK/dV accumulator travels with the shard and arrives home
    after the full cycle. The partials come back in q's dtype and are
    summed in float32, as the reference sums them."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale, bq, bk, b):
        o, lse = _ring_flash_fwd(q, k, v, causal, scale, bq, bk, b)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.args = (causal, scale, bq, bk, b)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        causal, scale, bq, bk, b = ctx.args
        do = do.contiguous()
        delta = (do.float() * o.float()).sum(-1, keepdim=True)
        dq, dk, dv = (torch.zeros(q.shape, dtype=torch.float32, device=q.device)
                      for _ in range(3))
        k_cur, v_cur = k, v
        W = q.shape[0] if b is None else b.size
        for s, a, diag in _steps(q, causal, b):
            if a < q.shape[0]:  # a rank that skips the step still shifts
                args = [_fold(t[a:]) for t in (q, k_cur, v_cur, do, lse, delta)]
                dq_p = _dq_call(*args, scale, diag, bq, bk)
                dk_p, dv_p = _dkdv_call(*args, scale, diag, bq, bk)
                dq[a:] += dq_p.view(dq[a:].shape)
                dk[a:] += dk_p.view(dk[a:].shape)
                dv[a:] += dv_p.view(dv[a:].shape)
            # the kv shard and its gradient accumulator move on together;
            # the accumulators arrive home after the W-th shift
            k_cur, v_cur = _shifted((k_cur, v_cur), b, s == W - 1)
            dk, dv = _shifted((dk, dv), b, False)
        return (dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None, None, None, None,
                None)


def _stacked_to_bh(x):
    # (W, B, L, H, D) -> (W, B*H, L, D), contiguous: the kernels take
    # nothing else, and at B = 1 the reshape alone would be a strided view
    W, B, L, H, D = x.shape
    return x.transpose(2, 3).reshape(W, B * H, L, D).contiguous()


def _ring_attention_flash(q, k, v, causal, scale, axis_name="sp"):
    W, B, Lq, H, D = q.shape
    bq, bk = resolved_block_sizes(Lq)
    if Lq != k.shape[2] or Lq % bq or Lq % bk:
        raise ValueError(
            f"flash block kernel needs equal, block-divisible shard lengths: "
            f"Lq={Lq} Lk={k.shape[2]} blocks=({bq},{bk}); use "
            f"block_kernel='dense' or pad the sequence"
        )
    o = _RingFlash.apply(_stacked_to_bh(q), _stacked_to_bh(k), _stacked_to_bh(v),
                         causal, scale, bq, bk, _mesh.axis_binding(axis_name))
    return o.reshape(W, B, H, Lq, D).transpose(2, 3)


def ring_attention(q, k, v, causal: bool = False, scale: Optional[float] = None,
                   block_kernel: str = "auto", axis_name: str = "sp"):
    """Ring attention over rank-stacked shards; differentiable.

    q, k, v: (W, B, L_local, H, D), rank r's sequence shard at index r;
    inside an entered multiproc mesh with `axis_name`, (1, B, L_local, H,
    D), this process's shard.
    Returns each rank's output for its own queries, (W, B, L_local, H, D):
    softmax attention over the global sequence, with causal masking by
    global position.

    `block_kernel` sets how a ring step's (Lq x Lk) partial is computed:
    "dense" (an einsum over the scores; autograd differentiates the ring),
    "flash" (the flash kernels per step, combined by log-sum-exp, with the
    custom ring backward), or "auto" (the reference's rule,
    `auto_block_kernel`)."""
    W, B, Lq, H, D = q.shape
    if scale is None:
        scale = 1.0 / (D ** 0.5)
    if block_kernel == "auto":
        block_kernel = auto_block_kernel(B, H, Lq, k.shape[2])
    if block_kernel == "flash":
        return _ring_attention_flash(q, k, v, causal, scale, axis_name)
    if block_kernel != "dense":
        raise ValueError(f"block_kernel must be auto|dense|flash, got {block_kernel!r}")
    return _ring_dense(q, k, v, causal, scale, axis_name)


# ---------------------------------------------------------------------------
# Ulysses
# ---------------------------------------------------------------------------


def ulysses_attention(q, k, v, attn_fn: Optional[Callable] = None, causal: bool = False,
                      scale: Optional[float] = None, axis_name: str = "sp"):
    """DeepSpeed-Ulysses over rank-stacked shards (in multiproc mode, this
    process's shard (1, B, L_local, H, D); the reshard is the all_to_all
    of `axis_name`'s group).

    q, k, v: (W, B, L_local, H, D), H divisible by W. The all_to_all that
    gives rank r head group r over the whole sequence is a reshape and
    permute: (W, B, L_local, H, D) -> (W, B, L, H/W, D). `attn_fn` (dense
    attention by default) runs over (B, L, H/W, D) with the ranks folded
    into the batch, which attention keeps apart; the inverse all_to_all
    brings the output back to (W, B, L_local, H, D)."""
    W, B, Ll, H, D = q.shape
    b = _mesh.axis_binding(axis_name)
    W = W if b is None else b.size
    if H % W != 0:
        raise ValueError(f"heads {H} not divisible by world size {W}")
    Hg = H // W

    def seq_to_heads(x):  # [src, b, l, grp, h, d] -> [grp, b, src, l, h, d]
        x = x.reshape(W, B, Ll, W, Hg, D).permute(3, 1, 0, 2, 4, 5)
        return x.reshape(W * B, W * Ll, Hg, D)

    def heads_to_seq(x):  # [grp, b, src, l, h, d] -> [src, b, l, grp, h, d]
        x = x.reshape(W, B, W, Ll, Hg, D).permute(2, 1, 3, 0, 4, 5)
        return x.reshape(W, B, Ll, H, D)

    if attn_fn is None:
        attn_fn = dense_attention
    # pass causal/scale only to a kernel that takes them; a causal request
    # that a custom kernel cannot honour fails loudly, as in the reference
    try:
        accepted = set(inspect.signature(attn_fn).parameters)
    except (TypeError, ValueError):
        accepted = set()
    kwargs = {}
    if "causal" in accepted:
        kwargs["causal"] = causal
    elif causal:
        raise ValueError(
            "ulysses_attention: causal=True but attn_fn does not accept a "
            "'causal' keyword; apply masking inside attn_fn or use mode='ring'"
        )
    if "scale" in accepted:
        kwargs["scale"] = scale
    if b is not None:  # head group r of the whole sequence, and back
        def seq_to_heads(x):  # (1, B, Ll, H, D) -> (B, L, Hg, D)
            return nnf.all_to_all(x, axis_name, split_axis=2, concat_axis=1)[0]

        def heads_to_seq(x):  # (B, L, Hg, D) -> (1, B, Ll, H, D)
            return nnf.all_to_all(x.unsqueeze(0), axis_name, split_axis=1, concat_axis=2)
    of = attn_fn(seq_to_heads(q), seq_to_heads(k), seq_to_heads(v), **kwargs)
    return heads_to_seq(of)


# ---------------------------------------------------------------------------
# global tensors in, global tensors out
# ---------------------------------------------------------------------------


def make_cp_attention(mesh, axis_name: str = "sp", mode: str = "ring", causal: bool = True,
                      attn_fn: Optional[Callable] = None) -> Callable:
    """Ring or Ulysses attention over the W ranks of `mesh`'s `axis_name`
    (a `DeviceMesh`; an int is W itself, driver mode), as a callable on
    global (B, L, H, D) tensors that returns the global output.

    The reference shards L over the mesh axis with `shard_map`; in driver
    mode the W shards are stacked on one device, over a multiproc mesh
    each process takes its own shard, and the output shards are
    all-gathered back into the global output (on every process). L must
    divide by W. `mode` is "ring" or "ulysses"."""
    world = mesh if isinstance(mesh, int) else mesh.axis_size(axis_name)
    multiproc = not isinstance(mesh, int) and mesh.multiproc
    if mode == "ring":
        local = functools.partial(ring_attention, causal=causal, axis_name=axis_name)
    elif mode == "ulysses":
        local = functools.partial(ulysses_attention, causal=causal, attn_fn=attn_fn,
                                  axis_name=axis_name)
    else:
        raise ValueError(f"mode must be ring|ulysses, got {mode!r}")

    def attention(q, k, v):
        B, L, H, D = q.shape
        if L % world:
            raise ValueError(f"seq len {L} does not split into {world} shards")

        def shard(x):  # (B, L, H, D) -> (W, B, L/W, H, D)
            x = x.reshape(B, world, L // world, H, D).transpose(0, 1)
            if multiproc:
                i = mesh.axis_index(axis_name)
                x = x[i:i + 1]
            return x.contiguous()

        if not multiproc:
            o = local(shard(q), shard(k), shard(v))
            return o.transpose(0, 1).reshape(B, L, H, D)
        with mesh:
            o = local(shard(q), shard(k), shard(v))  # (1, B, L/W, H, D)
            return nnf.all_gather(o, axis_name, 1, replica=True)

    return attention
