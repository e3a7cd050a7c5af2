"""The port's MNIST ConvNet against the reference's flax ConvNet, on the CPU.

The reference is initialized from `PRNGKey(0)` and its params carried over
with `convnet_from_flax`. On a seeded numpy batch (NHWC to the reference,
NCHW to the port) the logits and the gradients of the mean cross-entropy
with respect to every param, converted the same way, must agree in
float32 within rtol 1e-5 and atol 1e-6 (the same arithmetic summed in
another order: XLA's convolutions and dots against oneDNN's). A batch with
exact ties inside every pool window checks that the port's max pool splits
the cotangent evenly over tied maxima, as the reference's reshape-and-max
does.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F

from pytorch_distributed_example_tpu.models import ConvNet as JConvNet
from pytorch_distributed_example_tpu.models.convnet import max_pool_2x2 as jpool
from pytorch_distributed_example_tpu_torch.models import ConvNet, convnet_from_flax
from pytorch_distributed_example_tpu_torch.models.convnet import max_pool_2x2

TOL = dict(rtol=1e-5, atol=1e-6)


@pytest.fixture(scope="module")
def reference():
    model = JConvNet()
    params = model.init(jax.random.PRNGKey(0), jnp.zeros((1, 28, 28, 1)))
    return model, params


def _batches():
    rng = np.random.default_rng(0)
    seeded = rng.standard_normal((16, 28, 28, 1)).astype(np.float32)
    # exact ties: constant images give equal values over every pool
    # window of both pools (a VALID conv of a constant is constant)
    tied = np.concatenate([np.full((4, 28, 28, 1), v, np.float32) for v in (0.5, -1.0)])
    return {"seeded": seeded, "tied": tied}


@pytest.mark.parametrize("name", ["seeded", "tied"])
def test_logits_and_grads_match_reference(reference, name):
    jmodel, jparams = reference
    x = _batches()[name]
    y = np.random.default_rng(1).integers(0, 10, x.shape[0]).astype(np.int32)

    def jloss(p):
        logits = jmodel.apply(p, x)
        return optax.softmax_cross_entropy_with_integer_labels(logits, y).mean(), logits

    (jl, jlogits), jgrads = jax.value_and_grad(jloss, has_aux=True)(jparams)

    model = ConvNet(device="cpu")
    model.load_state_dict(convnet_from_flax(jparams))
    logits = model(torch.from_numpy(x.transpose(0, 3, 1, 2).copy()))
    loss = F.cross_entropy(logits, torch.from_numpy(y).long())
    loss.backward()
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(jlogits), **TOL)
    np.testing.assert_allclose(loss.item(), float(jl), **TOL)
    want = convnet_from_flax(jgrads)
    assert sorted(want) == sorted(n for n, _ in model.named_parameters())
    for n, p in model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[n].numpy(), **TOL, err_msg=n)


def test_pool_splits_tied_cotangent_like_the_reference():
    x = np.zeros((1, 1, 4, 4), np.float32)
    x[0, 0, :2, :2] = [[3.0, 3.0], [1.0, 3.0]]  # a 3-way tie
    x[0, 0, 2:, 2:] = 7.0  # a 4-way tie
    t = torch.from_numpy(x).requires_grad_()
    max_pool_2x2(t).sum().backward()
    jg = jax.grad(lambda a: jpool(a).sum())(jnp.asarray(x.transpose(0, 2, 3, 1)))
    np.testing.assert_array_equal(t.grad.numpy(), np.asarray(jg).transpose(0, 3, 1, 2))
    assert t.grad[0, 0, 0, 0] == pytest.approx(1 / 3) and t.grad[0, 0, 3, 3] == 0.25
    # the forward is max_pool2d's
    torch.testing.assert_close(max_pool_2x2(t), F.max_pool2d(t, 2), rtol=0, atol=0)


def test_init_is_flax_lecun_normal(reference):
    """Kernels: truncated normal at +-2 std, variance 1/fan_in; biases 0."""
    _, jparams = reference
    model = ConvNet(device="cpu", generator=torch.Generator().manual_seed(0))
    ref = convnet_from_flax(jparams)
    for n, p in model.state_dict().items():
        if n.endswith("bias"):
            assert not p.any(), n
            continue
        fan_in = p[0].numel()
        std = (1.0 / fan_in) ** 0.5
        assert abs(float(p.std()) / std - 1) < 0.12, n
        bound = 2 * std / 0.87962566103423978
        assert float(p.abs().max()) <= bound and float(ref[n].abs().max()) <= bound * 1.0001, n


def test_dropout_masks_and_generator():
    model = ConvNet(device="cpu", generator=torch.Generator().manual_seed(0))
    x = torch.randn(6, 1, 28, 28, generator=torch.Generator().manual_seed(1))
    masks = model.dropout_masks(6, torch.Generator().manual_seed(2))
    assert [m.shape for m in masks] == [(6, 20, 8, 8), (6, 50)]
    assert 0.4 < float(masks[0].float().mean()) < 0.6  # rate 0.5
    a = model(x, generator=torch.Generator().manual_seed(2))
    torch.testing.assert_close(a, model(x, masks=masks), rtol=0, atol=0)
    assert not torch.equal(a, model(x))  # dropout off without masks or generator
    everything = tuple(torch.ones_like(m) for m in masks)
    # all kept: flax's x / keep_prob at both dropouts
    h = F.relu(max_pool_2x2(model.conv1(x)))
    h = F.relu(max_pool_2x2(model.conv2(h) / 0.5)).flatten(1)
    torch.testing.assert_close(model(x, masks=everything),
                               model.fc2(F.relu(model.fc1(h)) / 0.5), rtol=0, atol=0)


def test_converter_refuses_unknown_params(reference):
    _, jparams = reference
    bad = {"params": {**jparams["params"], "Dense_9": {"kernel": np.zeros((2, 2))}}}
    with pytest.raises(KeyError, match="Dense_9"):
        convnet_from_flax(bad)


def test_builds_on_the_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is cuda:0")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ConvNet()
