"""The float32 forward kernel's arithmetic ("tf32x3"), emulated on the CPU
(`tests/_tf32x3_emulation.py`), against the plain forward, a float64 copy
of it and the JAX package's forward.

`flash_fwd_tf32x3_kernel` (`csrc/flash_tf32x3.cuh`) takes S = q k^T and
O += P V each as three TF32 passes, scales S after the product (the plain
forward, as the Pallas kernel, scales q before it) and steps its online
softmax over stages of `FWD_BLOCK_K[D]` keys. `fwd_split` does the same on
the CPU. It stays within the float32 tolerance of the plain forward (lse
within lse's) at every head dim, causal and full, and a single TF32 pass
does not; on large logits it stands no farther from a float64 copy than
twice the plain forward; and it agrees with the JAX package's forward (its
Pallas kernel in interpret mode) within the float32 tolerance.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests import _tf32x3_emulation as em

jfa = importlib.import_module("pytorch_distributed_example_tpu.ops.flash_attention")

HEAD_DIMS = sorted(em.FWD_BLOCK_K)  # every instance: 32, 64, 128, 256
SPLITS = {"nearest": lambda D: em.mm_tf32x3, "truncated": lambda D: em.mm_tf32x3_truncated,
          "tensor core": em.fwd_tensor_core}


def _case(seed, D, causal, mm, head_scales=1):
    """(split, plain) forwards, each (o, lse), on inputs from `seed`."""
    q, k, v = em.randn_case(seed, D, n=3, head_scales=head_scales)
    scale = D ** -0.5
    split = em.fwd_split(q, k, v, scale, causal, mm, em.FWD_BLOCK_K[D])
    with em.one_thread():
        plain = em.tfa._fwd_plain(q, k, v, scale, causal, em.BLOCK, em.BLOCK)
    return split, plain, (q, k, v, scale)


@pytest.mark.parametrize("mm", list(SPLITS))
@pytest.mark.parametrize("D", HEAD_DIMS)
@pytest.mark.parametrize("causal", [False, True])
def test_tf32x3_forward_keeps_float32_accuracy(causal, D, mm):
    """o within the float32 tolerance of the plain forward and lse within
    lse's, the small halves rounded to nearest or truncated, and with the
    tensor core's truncating sums in the kernel's order."""
    (o, lse), (po, plse), _ = _case(100 + D + causal, D, causal, SPLITS[mm](D))
    excess = em.excess(o, po)
    assert excess <= 0, f"o: {excess:.3e} past the float32 tolerance {em.F32_TOL}"
    excess = em.excess(lse, plse, em.LSE_TOL)
    assert excess <= 0, f"lse: {excess:.3e} past lse's tolerance {em.LSE_TOL}"


@pytest.mark.parametrize("D", HEAD_DIMS)
@pytest.mark.parametrize("causal", [False, True])
def test_one_tf32_pass_misses_float32_accuracy_in_the_forward(causal, D):
    """The tolerance has teeth: a single TF32 pass over both products lands
    outside it, for o and for lse."""
    (o, lse), (po, plse), _ = _case(100 + D + causal, D, causal, em.mm_tf32)
    assert em.excess(o, po) > 0
    assert em.excess(lse, plse, em.LSE_TOL) > 0


@pytest.mark.parametrize("D", HEAD_DIMS)
@pytest.mark.parametrize("causal", [False, True])
def test_tf32x3_forward_as_exact_as_float32_on_large_logits(causal, D):
    """Heads scaled by 1 to 4 (logits up to 16 times as large): the split
    forward as the kernel takes it stands no farther from a float64 copy of
    the plain forward than twice the plain forward does, for o and lse.
    `tests/test_torch_cuda.py` and `chip_smoke.py` hold the kernel to the
    same bound on the card."""
    split, plain, (q, k, v, scale) = _case(110 + D + causal, D, causal,
                                           em.fwd_tensor_core(D), head_scales=4)
    exact = em.f64_forward(q, k, v, scale, causal)
    for name, s, p, e in zip(("o", "lse"), split, plain, exact):
        split_err = float((s.double() - e).abs().max())
        plain_err = float((p.double() - e).abs().max())
        assert split_err <= 2 * plain_err, (name, split_err, plain_err)


@pytest.mark.parametrize("D", HEAD_DIMS)
@pytest.mark.parametrize("causal", [False, True])
def test_tf32x3_forward_matches_jax(causal, D):
    """The split forward as the kernel takes it against the JAX package's
    `_fwd` (its Pallas kernel in interpret mode) on the same numpy inputs
    at a small L: o within the float32 tolerance, lse within lse's."""
    length = 64
    q, k, v = em.randn_case(120 + D + causal, D, n=3, length=length)
    scale = D ** -0.5
    o, lse = em.fwd_split(q, k, v, scale, causal, em.fwd_tensor_core(D), em.FWD_BLOCK_K[D])
    jo, jlse = jfa._fwd(*(jnp.asarray(t.numpy()) for t in (q, k, v)), scale, causal, 32, 16, True)
    jo, jlse = (torch.tensor(np.asarray(t)) for t in (jo, jlse))
    assert o.shape == jo.shape and lse.shape == jlse.shape
    excess = em.excess(o, jo)
    assert excess <= 0, f"o: {excess:.3e} past the float32 tolerance {em.F32_TOL}"
    excess = em.excess(lse, jlse, em.LSE_TOL)
    assert excess <= 0, f"lse: {excess:.3e} past lse's tolerance {em.LSE_TOL}"
