"""The float32 dK/dV and dQ kernels' arithmetic ("tf32x3"), emulated on the
CPU (`tests/_tf32x3_emulation.py`), against the plain versions.

Every product of `flash_dkdv_tf32x3_kernel` and `flash_dq_tf32x3_kernel`
(`csrc/flash_tf32x3.cuh`) runs as three TF32 passes. Copies of the plain
versions that take each product so stay within the float32 tolerance of
them at head dims 32, 128 and 256: with the small halves rounded to
nearest, truncated (as the tensor core reads them), and with the tensor
core's truncating sums in the kernels' order. A single TF32 pass does not.
On large logits, where the plain versions' own error grows, the split
stands no farther from a float64 copy than twice the plain versions.
"""

import pytest
import torch

from tests import _tf32x3_emulation as em

SPLITS = [em.mm_tf32x3, em.mm_tf32x3_truncated, em.TENSOR_CORE]


@pytest.mark.parametrize("mm", SPLITS, ids=["nearest", "truncated", "tensor core"])
@pytest.mark.parametrize("D", em.HEAD_DIMS)
@pytest.mark.parametrize("causal", [False, True])
def test_tf32x3_split_keeps_float32_accuracy(causal, D, mm):
    """The split within the float32 tolerance, its small halves rounded to
    nearest or truncated (as the tensor core reads them), and with the
    tensor core's truncating sums in the kernels' order."""
    args = em.f32_case(70 + causal, D, causal)
    want = em.plain_backward(args)
    got = em.split_backward(args, mm)
    for name in want:
        excess = em.excess(got[name], want[name])
        assert excess <= 0, f"{name}: {excess:.3e} past the float32 tolerance {em.F32_TOL}"


@pytest.mark.parametrize("D", em.HEAD_DIMS)
def test_one_tf32_pass_misses_float32_accuracy(D):
    """The tolerance has teeth: a single TF32 pass over the same products
    lands far outside it, for each output."""
    args = em.f32_case(80, D, True)
    want = em.plain_backward(args)
    got = em.split_backward(args, em.mm_tf32)
    for name in want:
        assert em.excess(got[name], want[name]) > 0, name


def test_tf32_rounding_clears_the_low_bits_to_nearest():
    x = torch.tensor([1.0 + 2 ** -11, 1.0 + 2 ** -10 + 2 ** -11, -(1.0 + 3 * 2 ** -12), 3.0])
    got = em.tf32(x)
    assert got.tolist() == [1.0 + 2 ** -10, 1.0 + 2 ** -9, -(1.0 + 2 ** -10), 3.0]
    assert not bool((got.view(torch.int32) & 0x1FFF).any())


@pytest.mark.parametrize("D", em.HEAD_DIMS)
def test_tf32x3_split_as_exact_as_float32_on_large_logits(D):
    """Heads scaled by 1 to 4 (logits up to 16 times as large): there the
    plain float32 versions themselves stand ~1e-5 of max from a float64
    copy of the same arithmetic (on the same float32 lse and delta), and
    the split as the kernels take it (small halves truncated, the tensor
    core's truncating sums in the kernels' order) stands no farther from it
    than twice that. `tests/test_torch_cuda.py` holds the kernels to the
    same bound on the card."""
    q, k, v, do = em.randn_case(90, D, head_scales=4)
    scale = D ** -0.5
    with em.one_thread():
        o, lse = em.tfa._fwd_plain(q, k, v, scale, True, em.BLOCK, em.BLOCK)
    args = (q, k, v, do, lse, (do * o).sum(-1, keepdim=True), scale, True)
    exact = em.split_backward(args, em.mm_f64)
    plain = em.plain_backward(args)
    split = em.split_backward(args, em.TENSOR_CORE)
    for name in ("dk", "dv", "dq"):
        plain_err = float((plain[name] - exact[name]).abs().max())
        split_err = float((split[name] - exact[name]).abs().max())
        assert split_err <= 2 * plain_err, (name, split_err, plain_err)
