"""The port's ring attention and Ulysses against the JAX package's, on the CPU.

The reference runs under `shard_map` on a 4-device virtual CPU mesh (the
repo conftest's), with its Pallas flash kernels in interpret mode; the port
runs the same four ranks in driver mode, rank-stacked on one device, with
the kernels' plain versions. The same numpy inputs go through both.

Tolerances: float32 outputs agree to ~1e-6; 1e-5 leaves room for the two
frameworks summing in another order (the ring adds a log-sum-exp combine
per step). Gradients sum over the whole ring, so they get 2e-5. The bf16
ring rounds its output once, on each side, from float32 partials that
differ only in summation order: one bf16 ulp (2**-8 relative) apart at
most, so rtol 2**-7 with an atol of 1e-3 of the largest entry.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from pytorch_distributed_example_tpu._compat import shard_map_fn
from pytorch_distributed_example_tpu.mesh import init_device_mesh
from pytorch_distributed_example_tpu.parallel import context_parallel as jcp
from pytorch_distributed_example_tpu_torch.mesh import DeviceMesh
from pytorch_distributed_example_tpu_torch.ops import dense_attention
from pytorch_distributed_example_tpu_torch.parallel import context_parallel as tcp

W = 4
B, L, H, D = 1, 4 * 64, 2, 32  # shards of 64 rows
FWD_TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=2e-5, atol=2e-5)
BF16_TOL = dict(rtol=2 ** -7)


def _inputs(seed, n=4, shape=(B, L, H, D)):
    gen = np.random.default_rng(seed)
    return [gen.standard_normal(shape).astype(np.float32) for _ in range(n)]


def _mesh():
    return init_device_mesh(("sp",), (W,), devices=jax.devices()[:W]).jax_mesh


def _jax_sharded(local):
    spec = P(None, "sp", None, None)
    return jax.jit(shard_map_fn(local, mesh=_mesh(), in_specs=(spec,) * 3, out_specs=spec))


def _shard(x):
    # global (B, L, H, D) numpy -> rank-stacked (W, B, L/W, H, D) tensor
    b, l, h, d = x.shape
    return torch.tensor(np.ascontiguousarray(
        x.reshape(b, W, l // W, h, d).transpose(1, 0, 2, 3, 4)))


def _unshard(t):
    w, b, ll, h, d = t.shape
    return t.detach().transpose(0, 1).reshape(b, w * ll, h, d).float().numpy()


def _stream(monkeypatch, stream):
    if stream:
        monkeypatch.setenv("TDX_FLASH_STREAM", "1")
    else:
        monkeypatch.delenv("TDX_FLASH_STREAM", raising=False)


@pytest.mark.parametrize("block_kernel, stream", [
    ("dense", False), ("flash", False), ("flash", True),
], ids=["dense", "flash-resident", "flash-streamed"])
@pytest.mark.parametrize("causal", [False, True])
def test_ring_matches_jax(block_kernel, stream, causal, monkeypatch):
    """Outputs, and dQ/dK/dV through the port's backward (autograd over the
    dense ring; the custom ring Function over the flash one) against
    `jax.vjp` of the reference's ring, both kernel lowerings."""
    _stream(monkeypatch, stream)
    q, k, v, do = _inputs(0)
    fn = _jax_sharded(functools.partial(jcp.ring_attention, axis_name="sp", causal=causal,
                                        block_kernel=block_kernel))
    jo, vjp = jax.vjp(fn, *(jnp.asarray(x) for x in (q, k, v)))
    jgrads = vjp(jnp.asarray(do))

    ts = [_shard(x).requires_grad_() for x in (q, k, v)]
    o = tcp.ring_attention(*ts, causal=causal, block_kernel=block_kernel)
    assert o.shape == (W, B, L // W, H, D)
    o.backward(_shard(do))
    np.testing.assert_allclose(_unshard(o), np.asarray(jo), **FWD_TOL)
    for name, t, want in zip("qkv", ts, jgrads):
        np.testing.assert_allclose(_unshard(t.grad), np.asarray(want), **GRAD_TOL,
                                   err_msg=f"d{name}")


@pytest.mark.parametrize("stream", [False, True], ids=["resident", "streamed"])
def test_ring_flash_bf16_combines_f32_partials(stream, monkeypatch):
    """bf16 operands: each step's partial comes from the kernel's float32
    accumulator (`_fwd(..., out_dtype=f32)`) on both sides, and the output
    rounds to bf16 once."""
    _stream(monkeypatch, stream)
    q, k, v = _inputs(1, 3)
    fn = _jax_sharded(functools.partial(jcp.ring_attention, axis_name="sp", causal=True,
                                        block_kernel="flash"))
    jo = np.asarray(fn(*(jnp.asarray(x, jnp.bfloat16) for x in (q, k, v))).astype(jnp.float32))
    ts = [_shard(x).to(torch.bfloat16) for x in (q, k, v)]
    o = tcp.ring_attention(*ts, causal=True, block_kernel="flash")
    assert o.dtype == torch.bfloat16
    np.testing.assert_allclose(_unshard(o), jo, atol=1e-3 * np.abs(jo).max(), **BF16_TOL)


@pytest.mark.parametrize("b, h", [(1, 1), (1, 2), (2, 2)])
def test_ring_flash_hands_the_kernels_contiguous_operands(b, h, monkeypatch):
    """The card's kernels take contiguous operands only (the plain versions
    take any): every tensor the ring passes to `_fwd`, `_dq_call` and
    `_dkdv_call` is contiguous, at every ring step, for shapes where a
    reshape alone would leave a strided view."""
    calls = []

    def contiguous_only(fn):
        def run(*args, **kwargs):
            tensors = [a for a in args if isinstance(a, torch.Tensor)]
            assert all(t.is_contiguous() for t in tensors), fn.__name__
            calls.append(fn.__name__)
            return fn(*args, **kwargs)
        return run

    for name in ("_fwd", "_dq_call", "_dkdv_call"):
        monkeypatch.setattr(tcp, name, contiguous_only(getattr(tcp, name)))
    q, k, v = (_shard(x).requires_grad_() for x in _inputs(4, 3, (b, L, h, D)))
    tcp.ring_attention(q, k, v, causal=True, block_kernel="flash").sum().backward()
    assert sorted(set(calls)) == ["_dkdv_call", "_dq_call", "_fwd"]
    assert len(calls) == 3 * W


@pytest.mark.parametrize("causal", [False, True])
def test_ulysses_matches_jax(causal):
    """Ulysses (its all_to_all a permute of the stacked dims) against the
    reference's, outputs and grads, with dense attention inside."""
    q, k, v, do = _inputs(2, shape=(2, L, W, D))  # heads divisible by W
    mesh = init_device_mesh(("sp",), (W,), devices=jax.devices()[:W])
    fn = jcp.make_cp_attention(mesh, axis_name="sp", mode="ulysses", causal=causal)
    jo, vjp = jax.vjp(fn, *(jnp.asarray(x) for x in (q, k, v)))
    jgrads = vjp(jnp.asarray(do))
    ts = [torch.tensor(x, requires_grad=True) for x in (q, k, v)]
    o = tcp.make_cp_attention(W, mode="ulysses", causal=causal)(*ts)
    o.backward(torch.tensor(do))
    np.testing.assert_allclose(o.detach().numpy(), np.asarray(jo), **FWD_TOL)
    for name, t, want in zip("qkv", ts, jgrads):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(want), **GRAD_TOL,
                                   err_msg=f"d{name}")


def test_ulysses_refuses_heads_that_do_not_split():
    x = torch.zeros(W, 1, 8, 3, 4)
    with pytest.raises(ValueError, match="not divisible"):
        tcp.ulysses_attention(x, x, x)


@pytest.mark.parametrize("b, h, shard", [
    (1, 1, 4096),   # 64 MB of scores: dense
    (1, 1, 8192),   # 256 MB and more: flash
    (2, 8, 2048),   # 512 MB: flash
    (1, 2, 9000),   # big, but no block size tiles it: dense
])
def test_auto_block_kernel_matches_jax(b, h, shard, monkeypatch):
    """The "auto" rule picks what the reference's picks. The reference's
    choice is read by tracing its ring with its flash path replaced by a
    recorder (jax.eval_shape: no compute)."""
    chosen = []

    def record(q, k, v, axis_name, causal, scale):
        chosen.append("flash")
        return q

    monkeypatch.setattr(jcp, "_ring_attention_flash", record)
    fn = shard_map_fn(
        functools.partial(jcp.ring_attention, axis_name="sp", causal=True),
        mesh=_mesh(), in_specs=(P(None, "sp", None, None),) * 3,
        out_specs=P(None, "sp", None, None))
    x = jax.ShapeDtypeStruct((b, W * shard, h, 8), jnp.float32)
    jax.eval_shape(fn, x, x, x)
    want = chosen[0] if chosen else "dense"
    assert tcp.auto_block_kernel(b, h, shard, shard) == want


@pytest.mark.parametrize("causal", [False, True])
def test_make_cp_attention_takes_and_returns_global_tensors(causal):
    """Global (B, L, H, D) in and out, against the reference's callable on
    the mesh and against the port's dense attention over the whole
    sequence."""
    q, k, v = _inputs(3, 3)
    mesh = init_device_mesh(("sp",), (W,), devices=jax.devices()[:W])
    jo = jcp.make_cp_attention(mesh, axis_name="sp", mode="ring", causal=causal)(
        *(jnp.asarray(x) for x in (q, k, v)))
    ts = [torch.tensor(x) for x in (q, k, v)]
    o = tcp.make_cp_attention(W, mode="ring", causal=causal)(*ts)
    assert o.shape == (B, L, H, D)
    np.testing.assert_allclose(o.numpy(), np.asarray(jo), **FWD_TOL)
    np.testing.assert_allclose(o.numpy(), dense_attention(*ts, causal=causal).numpy(),
                               **FWD_TOL)
    with pytest.raises(ValueError, match="ring\\|ulysses"):
        tcp.make_cp_attention(W, mode="star")
    with pytest.raises(ValueError, match="does not split"):
        tcp.make_cp_attention(3)(*ts)


@pytest.mark.parametrize("mode", ["ring", "ulysses"])
def test_make_cp_attention_takes_a_mesh_and_axis_name(mode):
    """The reference's form, `make_cp_attention(mesh, axis_name=...)`: W is
    the size of the driver-mode mesh's axis, and the result is the int
    form's bit for bit and the reference's on its ("sp", 4) mesh."""
    q, k, v = _inputs(5, 3, shape=(2, L, W, D))
    jmesh = init_device_mesh(("sp",), (W,), devices=jax.devices()[:W])
    jo = jcp.make_cp_attention(jmesh, axis_name="sp", mode=mode, causal=True)(
        *(jnp.asarray(x) for x in (q, k, v)))
    ts = [torch.tensor(x) for x in (q, k, v)]
    tmesh = DeviceMesh(["cpu"] * 8, (2, W), ("dp", "sp"))
    o = tcp.make_cp_attention(tmesh, axis_name="sp", mode=mode, causal=True)(*ts)
    np.testing.assert_allclose(o.numpy(), np.asarray(jo), **FWD_TOL)
    torch.testing.assert_close(o, tcp.make_cp_attention(W, mode=mode, causal=True)(*ts),
                               rtol=0, atol=0)
    with pytest.raises(ValueError):
        tcp.make_cp_attention(tmesh, axis_name="cp")
