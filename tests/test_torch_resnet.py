"""The port's ResNet (`models/resnet.py`) and CIFAR step against the reference's.

Both packages get the same params: the reference's flax variables, carried
over with `resnet_from_flax` (conv kernels HWIO -> OIHW). The inputs are
NHWC images from a numpy seed. The nets are narrow so the CPU keeps up: a
BasicBlock net of two stages at 8 filters and a Bottleneck net of two
stages at 4 filters. Everything is float32, and the tolerances are rtol
1e-5, atol 1e-5 (the convolutions and the norms' means sum in other
orders; the running variance, a difference of two means, gets atol 1e-5
for the same reason).

SyncBatchNorm is held at world 2 and 4 against flax's
`BatchNorm(axis_name=...)` under `shard_map` on the conftest's CPU devices:
each rank's logits, the synced running statistics and the mean gradients.
One step of the CIFAR example's train step at world 2 is held against the
reference example's `local_step`.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P
from torch.func import functional_call

import pytorch_distributed_example_tpu_torch as tdx
from pytorch_distributed_example_tpu._compat import shard_map_fn
from pytorch_distributed_example_tpu.models import resnet as jresnet
from pytorch_distributed_example_tpu_torch import optim
from pytorch_distributed_example_tpu_torch.examples import cifar
from pytorch_distributed_example_tpu_torch.models import (
    ResNet,
    ResNet18,
    convert_sync_batchnorm,
    resnet_from_flax,
    resnet_to_flax,
)
from pytorch_distributed_example_tpu_torch.models.resnet import BasicBlock, Bottleneck

TOL = dict(rtol=1e-5, atol=1e-5)
NETS = {
    "basic": (dict(stage_sizes=[1, 1], block_cls=jresnet.BasicBlock, num_filters=8),
              dict(stage_sizes=[1, 1], block_cls=BasicBlock, num_filters=8)),
    "bottleneck": (dict(stage_sizes=[1, 1], block_cls=jresnet.Bottleneck, num_filters=4),
                   dict(stage_sizes=[1, 1], block_cls=Bottleneck, num_filters=4)),
}


def _images(n, seed=0):
    return np.random.default_rng(seed).standard_normal((n, 32, 32, 3)).astype(np.float32)


def _flax_variables(jkw, seed=0):
    """Flax init, with running statistics moved off (0, 1) so that the
    eval path reads them."""
    v = jax.device_get(jresnet.ResNet(**jkw).init(jax.random.PRNGKey(seed),
                                                   jnp.zeros((1, 32, 32, 3))))
    gen = np.random.default_rng(seed + 1)
    stats = jax.tree_util.tree_map(
        lambda a: (gen.standard_normal(a.shape) * 0.1 + (1.0 if a.min() == 1 else 0.0)
                   ).astype(np.float32), v["batch_stats"])
    # the zero-initialized second scale of each block would hide its conv
    params = jax.tree_util.tree_map(
        lambda a: a if a.any() else (gen.standard_normal(a.shape) * 0.5).astype(np.float32),
        v["params"])
    return {"params": params, "batch_stats": stats}


def _port(pkw, variables, sync=False):
    model = ResNet(device="cpu", **pkw)
    params, stats = resnet_from_flax(variables)
    model.load_state_dict({**params, **stats})
    if sync:
        convert_sync_batchnorm(model)
    return model, params, stats


def _np_stats(tree):
    return {n: t.detach().numpy() for n, t in tree.items()}


@pytest.mark.parametrize("net", sorted(NETS))
def test_eval_logits_match_flax(net):
    jkw, pkw = NETS[net]
    v = _flax_variables(jkw)
    x = _images(4)
    want = np.asarray(jresnet.ResNet(**jkw).apply(v, jnp.asarray(x)))
    model, _, _ = _port(pkw, v)
    got = model(torch.from_numpy(x))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.detach().numpy(), want, **TOL)


@pytest.mark.parametrize("net", sorted(NETS))
def test_train_logits_and_batch_stats_match_flax(net):
    """Train mode: batch statistics (the biased variance), the running
    buffers updated with momentum 0.9, the converters both ways."""
    jkw, pkw = NETS[net]
    v = _flax_variables(jkw)
    x = _images(6, seed=2)
    want, mut = jresnet.ResNet(**jkw).apply(v, jnp.asarray(x), train=True,
                                            mutable=["batch_stats"])
    model, params, stats = _port(pkw, v)
    got, new = model(torch.from_numpy(x), train=True)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    block = "Bottleneck" if net == "bottleneck" else "BasicBlock"
    back = resnet_to_flax(params, {n: new[n] for n in stats}, block=block)
    jax.tree_util.tree_map(lambda a, b: np.testing.assert_allclose(a, np.asarray(b), **TOL),
                           back["batch_stats"], jax.device_get(mut["batch_stats"]))
    # eval leaves the buffers alone; train returns new ones and leaves them too
    assert torch.equal(model.bn_init.running_mean, stats["bn_init.running_mean"])
    same = resnet_to_flax(params, stats, block=block)
    jax.tree_util.tree_map(np.testing.assert_array_equal, same["params"], v["params"])


def test_biased_variance_and_momentum():
    """flax's BatchNorm, not nn.BatchNorm2d's: the biased batch variance
    goes into the running variance, with ra = 0.9 ra + 0.1 batch."""
    model = ResNet(stage_sizes=[1], num_filters=4, device="cpu")
    x = torch.from_numpy(_images(3))
    _, new = model(x, train=True)
    h = model.conv_init(x.permute(0, 3, 1, 2))
    var = h.var(dim=(0, 2, 3), unbiased=False)
    torch.testing.assert_close(new["bn_init.running_var"], 0.9 + 0.1 * var,
                               rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(new["bn_init.running_mean"], 0.1 * h.mean(dim=(0, 2, 3)),
                               rtol=1e-5, atol=1e-6)


def _reference_step(jkw, variables, x, y, world, lr=0.1, momentum=0.9):
    """The reference example's `local_step` (`examples/cifar/main.py`)
    under shard_map over `world` CPU devices: (params, batch_stats, loss)."""
    model = jresnet.convert_sync_batchnorm(jresnet.ResNet(**jkw), axis_name="_ranks")
    opt = optax.sgd(lr, momentum=momentum)
    mesh = Mesh(np.array(jax.devices()[:world]), ("_ranks",))

    def local_step(params, batch_stats, opt_state, x, y):
        def loss_fn(p):
            logits, mut = model.apply({"params": p, "batch_stats": batch_stats}, x,
                                      train=True, mutable=["batch_stats"])
            loss = optax.softmax_cross_entropy_with_integer_labels(logits, y).mean()
            return loss, mut["batch_stats"]

        (loss, new_stats), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
        grads = jax.tree_util.tree_map(lambda g: jax.lax.pmean(g, "_ranks"), grads)
        updates, opt_state = opt.update(grads, opt_state, params)
        return (optax.apply_updates(params, updates), new_stats, opt_state,
                jax.lax.pmean(loss, "_ranks"), grads)

    step = jax.jit(shard_map_fn(local_step, mesh=mesh,
                                in_specs=(P(), P(), P(), P("_ranks"), P("_ranks")),
                                out_specs=(P(), P(), P(), P(), P())))
    p, s = variables["params"], variables["batch_stats"]
    out = step(p, s, opt.init(p), jnp.asarray(x), jnp.asarray(y))
    return jax.device_get(out)


@pytest.mark.parametrize("world", [2, 4])
def test_sync_batchnorm_matches_flax_under_shard_map(world):
    """SyncBN in driver mode (the rank vmap and the c10d fold) against flax
    BatchNorm(axis_name) under shard_map: the mean loss, the mean
    gradients after one SGD step, and the synced running statistics."""
    jkw, pkw = NETS["basic"]
    v = _flax_variables(jkw)
    x = _images(2 * world, seed=3)
    y = np.random.default_rng(4).integers(0, 10, 2 * world).astype(np.int32)
    jp, js, _, jloss, _ = _reference_step(jkw, v, x, y, world)
    pg = tdx.init_process_group(world_size=world, device="cpu")
    try:
        model, params, stats = _port(pkw, v, sync=True)
        opt = optim.sgd(0.1, momentum=0.9)
        step = cifar.make_train_step(model, opt, pg)
        p, s, _, loss = step(params, stats, opt.init(params), torch.from_numpy(x),
                             torch.from_numpy(y).long())
    finally:
        tdx.destroy_process_group()
    np.testing.assert_allclose(float(loss), float(jloss), **TOL)
    back = resnet_to_flax(p, s)
    jax.tree_util.tree_map(lambda a, b: np.testing.assert_allclose(a, b, **TOL),
                           back["params"], jp)
    jax.tree_util.tree_map(lambda a, b: np.testing.assert_allclose(a, b, **TOL),
                           back["batch_stats"], js)


def test_synced_statistics_are_the_global_batch_statistics():
    """At world 4 every rank's synced running statistics equal BN over the
    whole global batch in one forward."""
    jkw, pkw = NETS["basic"]
    v = _flax_variables(jkw)
    x = torch.from_numpy(_images(8, seed=5))
    y = torch.zeros(8, dtype=torch.long)
    whole, params, stats = _port(pkw, v)
    _, want = whole(x, train=True)
    pg = tdx.init_process_group(world_size=4, device="cpu")
    try:
        model, _, _ = _port(pkw, v, sync=True)
        step = cifar.make_train_step(model, optim.sgd(0.0), pg)
        _, got, _, _ = step(params, stats, {}, x, y)
    finally:
        tdx.destroy_process_group()
    for n in want:
        np.testing.assert_allclose(got[n].numpy(), want[n].detach().numpy(), **TOL, err_msg=n)


def test_sync_batchnorm_outside_the_rank_vmap_raises():
    model = convert_sync_batchnorm(ResNet(stage_sizes=[1], num_filters=4, device="cpu"))
    with pytest.raises(RuntimeError, match="rank-vmapped"):
        model(torch.from_numpy(_images(2)), train=True)
    model(torch.from_numpy(_images(2)))  # eval reads the running statistics


def test_cifar_step_matches_the_reference_example():
    """One step of `examples/cifar.py`'s train step at world 2 (SyncBN,
    SGD 0.1 momentum 0.9) on the reference's synthetic CIFAR, against the
    reference example's `local_step`."""
    jkw, pkw = NETS["basic"]
    v = _flax_variables(jkw)
    x, y = cifar.synthetic_cifar(8, 0)
    jp, js, jo, jloss, _ = _reference_step(jkw, v, x, y, 2)
    pg = tdx.init_process_group(world_size=2, device="cpu")
    try:
        model, params, stats = _port(pkw, v, sync=True)
        opt = optim.sgd(0.1, momentum=0.9)
        step = cifar.make_train_step(model, opt, pg)
        p, s, o, loss = step(params, stats, opt.init(params), torch.from_numpy(x),
                             torch.from_numpy(y).long())
        correct = cifar.make_eval_step(model, pg)(p, s, torch.from_numpy(x),
                                                  torch.from_numpy(y).long())
    finally:
        tdx.destroy_process_group()
    np.testing.assert_allclose(float(loss), float(jloss), **TOL)
    back = resnet_to_flax(p, s)
    jax.tree_util.tree_map(lambda a, b: np.testing.assert_allclose(a, b, **TOL),
                           back["params"], jp)
    trace = resnet_to_flax(o, {})["params"]
    jax.tree_util.tree_map(lambda a, b: np.testing.assert_allclose(a, b, **TOL),
                           trace, jo[0].trace)
    logits = functional_call(model, {**p, **s}, (torch.from_numpy(x),))
    assert int(correct) == int((logits.argmax(-1) == torch.from_numpy(y).long()).sum())


def test_resnet18_shapes_and_init():
    model = ResNet18(device="cpu", generator=torch.Generator().manual_seed(0))
    n = sum(p.numel() for p in model.parameters())
    jn = sum(a.size for a in jax.tree_util.tree_leaves(jax.eval_shape(
        lambda: jresnet.ResNet18().init(jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3))))
        ["params"]))
    assert n == jn == 11_173_962
    views = model.hook_views()
    assert list(views)[0] == "blocks.0.bn0.bias"  # BasicBlock_0/BatchNorm_0/bias sorts first
    assert views["conv_init.weight"] == (2, 3, 1, 0) and views["fc.weight"] == (1, 0)
    assert sorted(views) == sorted(dict(model.named_parameters()))


def test_cifar_example_runs_on_the_cpu():
    out = cifar.main(["--cpu", "--epochs", "1", "--batch-size", "4", "--train-size", "16",
                      "--test-size", "8"])
    assert len(out["losses"]) == 2 and all(np.isfinite(out["losses"]))
    with pytest.raises(NotImplementedError, match="multiproc"):
        cifar.main(["--cpu", "--init-method", "tcp://localhost:1"])


def test_bench_resnet_ddp_runs_on_a_cpu_group():
    from pytorch_distributed_example_tpu_torch.bench import bench_resnet_ddp

    tdx.init_process_group(world_size=2, device="cpu")
    try:
        model = convert_sync_batchnorm(ResNet(stage_sizes=[1, 1], num_filters=8, device="cpu"))
        out = bench_resnet_ddp(batch_per_rank=4, warmup=1, steps=2, windows=2, model=model)
    finally:
        tdx.destroy_process_group()
    assert out["device"] == "cpu" and out["ranks_on_device"] == 2 and np.isfinite(out["final_loss"])
    samples = out["batch_per_rank"] * 2 * 2  # steps x batch a rank x ranks on the device
    np.testing.assert_allclose(np.multiply(out["windows"], out["window_s"]), samples, rtol=1e-12)
