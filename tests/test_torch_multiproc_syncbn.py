"""SyncBatchNorm in multiproc mode: the CIFAR example's train step as a
gloo gang of 2 processes on the CPU (`tests/_torch_mp_syncbn.py`).

Each process holds its rank's 4 images; its norms all-reduce the batch
statistics over the step's group inside the forward (and the cotangents
in the backward). The first step's loss, new running statistics and
params, and the eval count, are held to the port's driver mode at world 2
and to the reference example's `local_step` under `shard_map` on the
conftest's CPU devices, on the same flax variables and the reference's
synthetic CIFAR: float32, rtol 1e-4 / atol 1e-6 against driver mode and
`test_torch_resnet.py`'s rtol 1e-5 / atol 1e-5 against the reference.
"""

import pickle

import jax
import numpy as np
import pytest
import torch

import pytorch_distributed_example_tpu_torch as tdx
from pytorch_distributed_example_tpu.models import resnet as jresnet
from pytorch_distributed_example_tpu_torch.models import resnet_to_flax
from tests import _torch_mp_syncbn as cases
from tests._torch_gang import run_gang
from tests.test_torch_resnet import NETS, _flax_variables, _reference_step

W = 2
DRIVER_TOL = dict(rtol=1e-4, atol=1e-6)
REF_TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("syncbn")
    jkw, _ = NETS["basic"]
    assert jkw["block_cls"] is jresnet.BasicBlock and jkw["num_filters"] == 8
    variables = _flax_variables(jkw)
    path = tmp / "variables.pkl"
    with open(path, "wb") as f:
        pickle.dump(jax.tree.map(np.asarray, variables), f)
    rcs, texts, gang = run_gang("tests._torch_mp_syncbn", tmp, W, args=(str(path),))
    for r, (rc, text) in enumerate(zip(rcs, texts)):
        assert rc == 0, f"rank {r} failed:\n{text}"
    tdx.init_process_group(world_size=W, device="cpu")
    try:
        driver = cases.step_case(variables, W, np.arange(W * cases.ROWS))
    finally:
        tdx.destroy_process_group()
    x, y = cases.cifar.synthetic_cifar(W * cases.ROWS, 0)
    reference = _reference_step(jkw, variables, x, y, W, cases.LR, cases.MOMENTUM)
    return gang, driver, reference


def _close(a, b, tol, what):
    for k in b:
        np.testing.assert_allclose(a[k], b[k], err_msg=f"{what} {k}", **tol)


def test_syncbn_gang_matches_driver_mode(run):
    gang, driver, _ = run
    for r, res in enumerate(gang):
        np.testing.assert_allclose(res["loss"], driver["loss"], **DRIVER_TOL)
        _close(res["params"], driver["params"], DRIVER_TOL, f"rank {r} params")
        _close(res["stats"], driver["stats"], DRIVER_TOL, f"rank {r} batch stats")
        assert res["correct"] == driver["correct"]


def test_syncbn_gang_matches_reference(run):
    gang, _, (jp, js, _, jloss, _) = run
    for r, res in enumerate(gang):
        np.testing.assert_allclose(res["loss"], float(jloss), **REF_TOL)
        back = resnet_to_flax({k: torch.from_numpy(v) for k, v in res["params"].items()},
                              {k: torch.from_numpy(v) for k, v in res["stats"].items()})
        jax.tree_util.tree_map(lambda a, b: np.testing.assert_allclose(a, b, **REF_TOL),
                               back["params"], jp)
        jax.tree_util.tree_map(lambda a, b: np.testing.assert_allclose(a, b, **REF_TOL),
                               back["batch_stats"], js)


def test_cifar_example_trains_as_a_two_process_gang(tmp_path):
    """`examples/cifar.main(["--cpu", "--init-method", "tcp://...", "--rank",
    r, "--world-size", 2])` in each process: the gang trains an epoch (4
    steps of 4 images a rank), the same losses on both ranks."""
    rcs, texts, gang = run_gang("tests._torch_mp_syncbn", tmp_path, W, args=("main",))
    for r, (rc, text) in enumerate(zip(rcs, texts)):
        assert rc == 0, f"rank {r} failed:\n{text}"
        assert "world_size=2" in text and "one rank a process" in text, text
    assert len(gang[0]["losses"]) == 4 and all(np.isfinite(gang[0]["losses"]))
    np.testing.assert_array_equal(gang[0]["losses"], gang[1]["losses"])
