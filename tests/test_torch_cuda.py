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

tfa = importlib.import_module("pytorch_distributed_example_tpu_torch.ops.flash_attention")


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run with -m cuda on the H100)")
    torch.backends.cuda.matmul.allow_tf32 = False


# Kernel and plain version both compute in float32 from the same operands,
# in another order; bf16 outputs then round once more on each side (2**-8
# relative each), so bf16 is held to rtol 2**-7 and an atol of 1e-3 of the
# plain output's largest entry, as chip_smoke.py holds it.
_F32_TOL = dict(rtol=1e-4, atol=1e-5)


def _assert_close(got, want, dtype, msg=None):
    got, want = got.float(), want.float()
    if dtype == torch.bfloat16:
        tol = dict(rtol=2 ** -7, atol=1e-3 * float(want.abs().max()))
    else:
        tol = _F32_TOL
    torch.testing.assert_close(got, want, **tol, msg=msg)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("causal", [False, True])
def test_kernels_match_plain(dtype, D, causal):
    _need_card()
    gen = torch.Generator(device="cuda").manual_seed(0)
    # L = 200 leaves a ragged last 64-row tile for the kernels to mask;
    # the plain versions tile it by 40
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
    _assert_close(o, po, dtype)
    torch.testing.assert_close(o32, po32, **_F32_TOL)
    torch.testing.assert_close(lse, plse, rtol=1e-5, atol=1e-5)
    delta = (do.float() * po.float()).sum(-1, keepdim=True)
    dk, dv = tfa._dkdv_cuda(q, k, v, do, plse, delta, scale, causal)
    pdk, pdv = tfa._dkdv_plain(q, k, v, do, plse, delta, scale, causal, blk, blk)
    dq = tfa._dq_cuda(q, k, v, do, plse, delta, scale, causal)
    pdq = tfa._dq_plain(q, k, v, do, plse, delta, scale, causal, blk, blk)
    torch.cuda.synchronize()
    for name, got, want in (("dq", dq, pdq), ("dk", dk, pdk), ("dv", dv, pdv)):
        _assert_close(got, want, dtype, msg=name)


@pytest.mark.cuda
def test_flash_attention_goes_through_the_kernels():
    """Autograd on CUDA tensors launches each kernel once per call and
    matches the CPU path; an unsupported head dim raises."""
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
    for got, want in zip(results[1], results[0]):
        torch.testing.assert_close(got, want, **_F32_TOL)
    x = torch.zeros(1, 128, 1, 96, device="cuda")
    with pytest.raises(ValueError, match="head dim 96"):
        tfa.flash_attention(x, x, x)
