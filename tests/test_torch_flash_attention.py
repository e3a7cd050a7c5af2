"""The port's flash attention against the JAX package's, on the CPU.

The same numpy inputs go through the reference (its Pallas kernels in
interpret mode) and through the port, whose CPU tensors take the kernels'
plain versions: the same blocked online softmax in float32. Tolerances:
float32 outputs agree to ~1e-6 relative; 1e-5 leaves room for the two
frameworks' matmuls summing in another order. Gradients sum over more
terms (a whole column of blocks), so they get 2e-5.

The reference has two lowerings of each kernel: VMEM-resident, and streamed
(counterpart blocks on a grid axis, past L*D = 1.5M elements at bf16).
Unset, `TDX_FLASH_STREAM` picks the resident one at these sizes; the
`_streamed` tests force the streamed one with `TDX_FLASH_STREAM=1`, as the
reference's own tests do. The port has one plain version (and one Hopper
kernel) per role for both, under the same tolerances.

The Hopper kernels themselves are held against the plain versions on the
card, by `tests/test_torch_cuda.py` and `chip_smoke.py`.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_distributed_example_tpu.ops.reference import (
    dense_attention as jax_dense,
)
from pytorch_distributed_example_tpu_torch.ops import _build
from pytorch_distributed_example_tpu_torch.ops.reference import dense_attention

# the modules, not the `flash_attention` functions their packages export
jfa = importlib.import_module("pytorch_distributed_example_tpu.ops.flash_attention")
tfa = importlib.import_module("pytorch_distributed_example_tpu_torch.ops.flash_attention")

BH, L, D = 4, 64, 32
BQ, BK = 32, 16
SCALE = 1.0 / D ** 0.5
FWD_TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=2e-5, atol=2e-5)


def _inputs(seed, n=3, shape=(BH, L, D)):
    gen = np.random.default_rng(seed)
    return [gen.standard_normal(shape).astype(np.float32) for _ in range(n)]


def _t(x, requires_grad=False):
    return torch.tensor(x, requires_grad=requires_grad)


def _stream(monkeypatch, stream):
    """Force the reference's streamed lowering, or leave its auto choice
    (resident at these sizes)."""
    if stream:
        monkeypatch.setenv("TDX_FLASH_STREAM", "1")
    else:
        monkeypatch.delenv("TDX_FLASH_STREAM", raising=False)


def _check_fwd(causal):
    q, k, v = _inputs(0)
    jo, jlse = jfa._fwd(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                        SCALE, causal, BQ, BK, True)
    o, lse = tfa._fwd(_t(q), _t(k), _t(v), SCALE, causal, BQ, BK)
    assert o.shape == (BH, L, D) and lse.shape == (BH, L, 1)
    assert lse.dtype == torch.float32
    np.testing.assert_allclose(o.numpy(), np.asarray(jo), **FWD_TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse), **FWD_TOL)


@pytest.mark.parametrize("causal", [False, True])
def test_fwd_matches_jax(causal):
    _check_fwd(causal)


@pytest.mark.parametrize("causal", [False, True])
def test_fwd_matches_jax_streamed(causal, monkeypatch):
    _stream(monkeypatch, True)
    _check_fwd(causal)


@pytest.mark.parametrize("causal", [False, True])
def test_flash_with_lse_grads_match_jax_vjp(causal):
    """dQ/dK/dV through both outputs, with a nonzero lse cotangent (the
    reference folds it into delta, `test_flash_attention.py:168`)."""
    _check_flash_with_lse_vjp(causal)


@pytest.mark.parametrize("causal", [False, True])
def test_flash_with_lse_grads_match_jax_vjp_streamed(causal, monkeypatch):
    _stream(monkeypatch, True)
    _check_flash_with_lse_vjp(causal)


def _check_flash_with_lse_vjp(causal):
    q, k, v, do = _inputs(1, 4)
    (dlse,) = _inputs(2, 1, (BH, L, 1))

    def f(q, k, v):
        return jfa.flash_with_lse(q, k, v, SCALE, causal, BQ, BK, True)

    (jo, jlse), vjp = jax.vjp(f, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    jgrads = vjp((jnp.asarray(do), jnp.asarray(dlse)))

    tq, tk, tv = _t(q, True), _t(k, True), _t(v, True)
    o, lse = tfa.flash_with_lse(tq, tk, tv, SCALE, causal, BQ, BK)
    torch.autograd.backward([o, lse], [_t(do), _t(dlse)])
    np.testing.assert_allclose(o.detach().numpy(), np.asarray(jo), **FWD_TOL)
    np.testing.assert_allclose(lse.detach().numpy(), np.asarray(jlse), **FWD_TOL)
    for name, got, want in zip("qkv", (tq.grad, tk.grad, tv.grad), jgrads):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **GRAD_TOL,
                                   err_msg=f"d{name}")


def test_unused_lse_gets_no_cotangent():
    """With lse unused, torch hands the backward None for dlse: the grads
    are the reference's with a zero lse cotangent."""
    q, k, v, do = _inputs(3, 4)

    def f(q, k, v):
        return jfa.flash_with_lse(q, k, v, SCALE, True, BQ, BK, True)

    _, vjp = jax.vjp(f, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    jgrads = vjp((jnp.asarray(do), jnp.zeros((BH, L, 1), jnp.float32)))
    tq, tk, tv = _t(q, True), _t(k, True), _t(v, True)
    o, _ = tfa.flash_with_lse(tq, tk, tv, SCALE, True, BQ, BK)
    o.backward(_t(do))
    for name, got, want in zip("qkv", (tq.grad, tk.grad, tv.grad), jgrads):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **GRAD_TOL,
                                   err_msg=f"d{name}")


@pytest.mark.parametrize("causal", [False, True])
def test_private_backward_calls_match_jax(causal):
    """`_dkdv_call`/`_dq_call` from a given lse and delta, as ring
    attention calls them."""
    _check_private_backward_calls(causal)


@pytest.mark.parametrize("causal", [False, True])
def test_private_backward_calls_match_jax_streamed(causal, monkeypatch):
    _stream(monkeypatch, True)
    _check_private_backward_calls(causal)


def _check_private_backward_calls(causal):
    q, k, v, do = _inputs(4, 4)
    (delta,) = _inputs(5, 1, (BH, L, 1))
    _, lse = tfa._fwd(_t(q), _t(k), _t(v), SCALE, causal, BQ, BK)
    args = [jnp.asarray(x) for x in (q, k, v, do, lse.numpy(), delta)]
    jdk, jdv = jfa._dkdv_call(*args, SCALE, causal, BQ, BK, True)
    jdq = jfa._dq_call(*args, SCALE, causal, BQ, BK, True)
    targs = [_t(x) for x in (q, k, v, do)] + [lse, _t(delta)]
    dk, dv = tfa._dkdv_call(*targs, SCALE, causal, BQ, BK)
    dq = tfa._dq_call(*targs, SCALE, causal, BQ, BK)
    for name, got, want in (("dq", dq, jdq), ("dk", dk, jdk), ("dv", dv, jdv)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **GRAD_TOL,
                                   err_msg=name)


def test_out_dtype_f32_from_bf16():
    """Ring attention's f32 partials: bf16 operands, o in float32 from the
    f32 accumulator. Both sides upcast the same bf16 values, so the f32
    tolerance holds."""
    _check_out_dtype_f32_from_bf16()


def test_out_dtype_f32_from_bf16_streamed(monkeypatch):
    _stream(monkeypatch, True)
    _check_out_dtype_f32_from_bf16()


def _check_out_dtype_f32_from_bf16():
    q, k, v = _inputs(6)
    jargs = [jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)]
    targs = [_t(x).to(torch.bfloat16) for x in (q, k, v)]
    jo, jlse = jfa._fwd(*jargs, SCALE, True, BQ, BK, True, out_dtype=jnp.float32)
    o, lse = tfa._fwd(*targs, SCALE, True, BQ, BK, out_dtype=torch.float32)
    assert o.dtype == torch.float32
    np.testing.assert_allclose(o.numpy(), np.asarray(jo), **FWD_TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse), **FWD_TOL)


def test_seq_that_does_not_tile_raises():
    q = torch.zeros(1, 96, 1, 16)
    with pytest.raises(ValueError, match="divisible"):
        tfa.flash_attention(q, q, q, block_q=64, block_k=64)
    with pytest.raises(ValueError, match="divisible"):
        tfa._fwd(q[:, :, 0], q[:, :, 0], q[:, :, 0], 1.0, True, 64, 64)


@pytest.mark.parametrize("L_, bq, bk, want", [
    (1024, None, None, (128, 128)),
    (32, None, None, (32, 32)),
    (96, None, None, (96, 96)),
    (256, 64, 512, (64, 256)),
])
def test_resolved_block_sizes(L_, bq, bk, want):
    """The reference's fitting with an empty table, which is what the
    port's H100 table is until a sweep on the card fills it."""
    assert tfa.resolved_block_sizes(L_, bq, bk) == want


@pytest.mark.parametrize("causal", [False, True])
def test_dense_matches_jax_dense(causal):
    q, k, v = (x.reshape(2, 2, L, D).transpose(0, 2, 1, 3) for x in _inputs(7))
    want = jax_dense(*(jnp.asarray(x) for x in (q, k, v)), causal=causal)
    got = dense_attention(_t(q), _t(k), _t(v), causal=causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FWD_TOL)


@pytest.mark.parametrize("causal", [False, True])
def test_flash_matches_port_dense(causal):
    """Within the port: flash (B, L, H, D) and its grads against dense."""
    q, k, v, do = (x.reshape(2, 2, L, D).transpose(0, 2, 1, 3) for x in _inputs(8, 4))
    outs, grads = [], []
    for fn in (lambda *a: tfa.flash_attention(*a, causal=causal, block_q=BQ, block_k=BK),
               lambda *a: dense_attention(*a, causal=causal)):
        ts = [_t(np.ascontiguousarray(x), True) for x in (q, k, v)]
        o = fn(*ts)
        o.backward(_t(np.ascontiguousarray(do)))
        outs.append(o.detach().numpy())
        grads.append([t.grad.numpy() for t in ts])
    np.testing.assert_allclose(outs[0], outs[1], **FWD_TOL)
    for name, a, b in zip("qkv", *grads):
        np.testing.assert_allclose(a, b, **GRAD_TOL, err_msg=f"d{name}")


@pytest.mark.parametrize("D_, Dp", [(16, 32), (48, 64), (96, 128), (200, 256), (256, 256)])
def test_padded_head_dim_matches_unpadded(D_, Dp):
    """On the card a head dim without an instance is zero-padded to the
    next one: the plain versions on padded operands, sliced back, equal the
    plain versions on the originals, and the padded columns are zero."""
    assert tfa.kernel_head_dim(D_) == Dp
    q, k, v, do = (_t(x) for x in _inputs(20 + D_, 4, (2, L, D_)))
    scale = D_ ** -0.5
    pads = [tfa.pad_head_dim(x, Dp) for x in (q, k, v, do)]
    o, lse = tfa._fwd_plain(q, k, v, scale, True, BQ, BK)
    po, plse = tfa._fwd_plain(*pads[:3], scale, True, BQ, BK)
    delta = (do * o).sum(-1, keepdim=True)
    want = [o, lse, *tfa._dkdv_plain(q, k, v, do, lse, delta, scale, True, BQ, BK),
            tfa._dq_plain(q, k, v, do, lse, delta, scale, True, BQ, BK)]
    got = [po, plse, *tfa._dkdv_plain(*pads, lse, delta, scale, True, BQ, BK),
           tfa._dq_plain(*pads, lse, delta, scale, True, BQ, BK)]
    for name, g, w in zip(("o", "lse", "dk", "dv", "dq"), got, want):
        tol = FWD_TOL if name in ("o", "lse") else GRAD_TOL
        np.testing.assert_allclose(g[..., :w.shape[-1]].numpy(), w.numpy(), **tol,
                                   err_msg=name)
        if name != "lse":
            assert not g[..., w.shape[-1]:].any(), name


def test_head_dim_above_256_raises():
    assert tfa.kernel_head_dim(256) == 256
    with pytest.raises(ValueError, match="head dim 272 exceeds"):
        tfa.kernel_head_dim(272)


def test_head_dim_96_matches_jax_flash():
    """D = 96, which the card runs padded to 128, through the public API
    (forward and grads) against the reference's flash."""
    q, k, v, do = (x.reshape(1, 2, L, 96).transpose(0, 2, 1, 3)
                   for x in _inputs(30, 4, (2, L, 96)))
    jq, jk, jv = (jnp.asarray(x) for x in (q, k, v))
    jo, vjp = jax.vjp(lambda q, k, v: jfa.flash_attention(q, k, v, causal=True, block_q=BQ,
                                                          block_k=BK, interpret=True),
                      jq, jk, jv)
    jgrads = vjp(jnp.asarray(do))
    ts = [_t(np.ascontiguousarray(x), True) for x in (q, k, v)]
    o = tfa.flash_attention(*ts, causal=True, block_q=BQ, block_k=BK)
    o.backward(_t(np.ascontiguousarray(do)))
    np.testing.assert_allclose(o.detach().numpy(), np.asarray(jo), **FWD_TOL)
    for name, t, want in zip("qkv", ts, jgrads):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(want), **GRAD_TOL,
                                   err_msg=f"d{name}")


def test_kernels_refuse_to_load_without_a_card(monkeypatch):
    """Loading the Hopper kernels needs an sm_90 card: without one it
    raises, and nothing falls back to the plain versions."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _build.load("flash_attention", tfa._SIGNATURES)


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.nvcc()


# -- under torch.func: vmap folds into B*H, vjp is autograd's -----------------


def _vmapped_inputs(V=3):
    return [torch.tensor(x) for x in _inputs(7, 3, (V, 2, L, 2, D))]  # (V, B, L, H, D)


def _flash(q, k, v):
    return tfa.flash_attention(q, k, v, causal=True, block_q=BQ, block_k=BK)


@pytest.mark.parametrize("in_dims", [(0, 0, 0), (0, None, None)], ids=["all", "q-only"])
def test_vmap_of_flash_is_bitwise_the_loop(in_dims):
    """`torch.func.vmap` folds the vmapped dim into B*H: one call of the
    kernel's plain version for every row, bit for bit the per-row loop,
    lse included, and nested vmaps fold the same way."""
    q, k, v = _vmapped_inputs()
    args = [x if d == 0 else x[0] for x, d in zip((q, k, v), in_dims)]
    got = torch.func.vmap(_flash, in_dims=in_dims)(*args)
    want = torch.stack([_flash(*(a[i] if d == 0 else a for a, d in zip(args, in_dims)))
                        for i in range(q.shape[0])])
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    bh = [tfa._to_bh(x[0]) for x in (q, k, v)]
    o, lse = torch.func.vmap(lambda a: tfa.flash_with_lse(a, *bh[1:], SCALE, True, BQ, BK))(
        torch.stack([bh[0], bh[0]]))
    wo, wlse = tfa.flash_with_lse(*bh, SCALE, True, BQ, BK)
    torch.testing.assert_close(lse, torch.stack([wlse, wlse]), rtol=0, atol=0)
    torch.testing.assert_close(o[1], wo, rtol=0, atol=0)
    expand = lambda x: x.unsqueeze(1).expand(-1, 2, *x.shape[1:])  # noqa: E731
    nested = torch.func.vmap(torch.func.vmap(_flash))(*(expand(x) for x in (q, k, v)))
    loop = torch.stack([_flash(q[i], k[i], v[i]) for i in range(q.shape[0])])
    for j in range(2):
        torch.testing.assert_close(nested[:, j], loop, rtol=0, atol=0)


def test_vmap_of_flash_launches_once_per_call(monkeypatch):
    calls = []
    real = tfa._fwd

    def spy(q, *a, **kw):
        calls.append(tuple(q.shape))
        return real(q, *a, **kw)

    monkeypatch.setattr(tfa, "_fwd", spy)
    q, k, v = _vmapped_inputs(V=3)
    torch.func.vmap(_flash)(q, k, v)
    assert calls == [(3 * 2 * 2, L, D)]  # V * B * H rows, one call


def test_torch_func_vjp_gives_autograds_gradients():
    """`torch.func.vjp` of flash, alone and of its vmap (the 1F1B
    recompute's composition), against autograd's backward, bitwise."""
    q, k, v = _vmapped_inputs()
    do = torch.tensor(_inputs(8, 1, tuple(q.shape))[0])
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    torch.stack([_flash(*(a[i] for a in leaves)) for i in range(q.shape[0])]).backward(do)
    want = [x.grad for x in leaves]
    _, fn = torch.func.vjp(torch.func.vmap(_flash), q, k, v)
    for g, w in zip(fn(do), want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    _, fn = torch.func.vjp(_flash, q[1], k[1], v[1])
    for g, w in zip(fn(do[1]), want):
        torch.testing.assert_close(g, w[1], rtol=0, atol=0)


def test_backward_under_vjp_sees_plain_tensors(monkeypatch):
    """The kernels read raw storage, which `torch.func`'s grad wrappers do
    not have: under `vjp` (and `vjp` of `vmap`) the backward hands the
    kernels' entry points unwrapped tensors, as the card needs."""
    from torch._C._functorch import is_functorch_wrapped_tensor

    seen = []
    real = tfa._dkdv_call

    def spy(*args):
        seen.extend(is_functorch_wrapped_tensor(a) for a in args if isinstance(a, torch.Tensor))
        return real(*args)

    monkeypatch.setattr(tfa, "_dkdv_call", spy)
    q, k, v = _vmapped_inputs()
    for fn, args in ((_flash, (q[0], k[0], v[0])), (torch.func.vmap(_flash), (q, k, v))):
        out, pull = torch.func.vjp(fn, *args)
        pull(torch.ones_like(out))
    assert seen and not any(seen)


def test_second_derivative_through_flash_raises():
    """The backward is first-order: a second derivative through flash, by
    nested grad transforms or by autograd's double backward, raises
    instead of dropping the outer level's gradient."""
    q, k, v = (x[0] for x in _vmapped_inputs())
    loss = lambda q: (_flash(q, k, v) ** 2).sum()  # noqa: E731
    torch.func.grad(loss)(q)  # first order runs
    with pytest.raises(NotImplementedError, match="first-order"):
        torch.func.grad(lambda q: torch.func.grad(loss)(q).sum())(q)
    leaf = q.clone().requires_grad_()
    (g,) = torch.autograd.grad(loss(leaf), leaf, create_graph=True)
    with pytest.raises(RuntimeError, match="once_differentiable"):
        g.sum().backward()
