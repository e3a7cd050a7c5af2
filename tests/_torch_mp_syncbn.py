"""Cases of the SyncBatchNorm gang tests: the CIFAR example's train step
(`examples/cifar.make_train_step`, SyncBN over the step's group inside the
forward) as a rank of a multiproc gang, and `examples/cifar.main` with
`--init-method`, which brings up its own gang. The flax variables come
pickled from the test (`models.resnet_from_flax` converts them). No JAX
here.
"""

import pickle

import numpy as np
import torch

from pytorch_distributed_example_tpu_torch import distributed as dist
from pytorch_distributed_example_tpu_torch import optim
from pytorch_distributed_example_tpu_torch.examples import cifar
from pytorch_distributed_example_tpu_torch.models import (ResNet, convert_sync_batchnorm,
                                                          resnet_from_flax)
from pytorch_distributed_example_tpu_torch.models.resnet import BasicBlock

NET = dict(stage_sizes=[1, 1], block_cls=BasicBlock, num_filters=8)
ROWS = 4  # a rank's batch
LR, MOMENTUM = 0.1, 0.9
MAIN_ARGS = ["--cpu", "--epochs", "1", "--batch-size", "4", "--train-size", "32",
             "--test-size", "8"]


def step_case(variables, world, rows):
    """One train step of the CIFAR example on the synthetic batch of
    `world` ranks; `rows` are the global rows this process holds."""
    model = ResNet(device="cpu", **NET)
    params, stats = resnet_from_flax(variables)
    model.load_state_dict({**params, **stats})
    convert_sync_batchnorm(model)
    x, y = cifar.synthetic_cifar(world * ROWS, 0)
    x, y = torch.from_numpy(x[rows]), torch.from_numpy(y[rows]).long()
    opt = optim.sgd(LR, momentum=MOMENTUM)
    step = cifar.make_train_step(model, opt, None)
    p, s, _, loss = step(params, stats, opt.init(params), x, y)
    correct = cifar.make_eval_step(model, None)(p, s, x, y)
    return {"loss": float(loss), "params": {k: v.detach().numpy() for k, v in p.items()},
            "stats": {k: v.detach().numpy() for k, v in s.items()},
            "correct": int(correct)}


def own_group(*args):
    return args[:1] == ("main",)


def gang(rank, world, *args):
    """("main",): `cifar.main` over the gang at the worker's port (passed
    first); (path,): the train step on the pickled variables."""
    if args[1:2] == ("main",):
        out = cifar.main(MAIN_ARGS + ["--init-method", f"tcp://127.0.0.1:{args[0]}", "--rank",
                                      str(rank), "--world-size", str(world)])
        return {"losses": out["losses"], "epochs": out["epochs"]}
    with open(args[0], "rb") as f:
        variables = pickle.load(f)
    assert dist._world.mode == "multiproc"
    return step_case(variables, world, np.arange(rank * ROWS, (rank + 1) * ROWS))
