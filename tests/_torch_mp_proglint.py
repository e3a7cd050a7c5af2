"""Gang cases of the port's proglint J005 agreement
(`tests/test_torch_proglint.py`), one process a rank under
`TDX_PROGLINT=1`:

* ``gang(rank, world, "ring,ring")``: every rank builds the same planner
  body (`plan/driver.py::compiled_body`) and a ZeRO DDP step; each first
  call agrees its collectives across the gang, then runs. Returns the
  results and the registered fingerprints.
* ``gang(rank, world, "ring,rhd")``: rank r builds the body of the r-th
  schedule (a skewed `TDX_PLANNER_FORCE`); the first call must raise
  `ProgramScheduleMismatchError` on every rank before any collective
  dispatches. Returns its message.

Imports neither JAX nor the JAX package.
"""

import torch

from pytorch_distributed_example_tpu_torch import distributed as dist
from pytorch_distributed_example_tpu_torch import optim
from pytorch_distributed_example_tpu_torch.mesh import DeviceMesh
from pytorch_distributed_example_tpu_torch.parallel.ddp import make_ddp_train_step
from pytorch_distributed_example_tpu_torch.plan import driver
from pytorch_distributed_example_tpu_torch.schedule import ProgramScheduleMismatchError
from pytorch_distributed_example_tpu_torch.tools import proglint


def _ddp(rank):
    def apply_fn(params, x):
        return x @ params["w"] + params["b"]

    def loss_fn(logits, y):
        return ((logits - y) ** 2).mean()

    step = make_ddp_train_step(apply_fn, loss_fn, optim.adam(1e-3))
    params = {"w": torch.ones((4, 3)), "b": torch.zeros((3,))}
    x = torch.arange(8, dtype=torch.float32).reshape(2, 4) + rank
    y = torch.ones((2, 3))
    opt = step.init_opt_state(params)
    params, opt, loss = step(params, opt, x, y)
    params, opt, loss2 = step(params, opt, x, y)
    return {"loss": float(loss), "loss2": float(loss2), "w": params["w"]}


def gang(rank, world, algs):
    alg = algs.split(",")[rank]
    pg = dist._get_default_group()
    prog = driver.compiled_body("all_reduce", alg, world)
    x = torch.arange(8, dtype=torch.float32)[None] + 10 * rank  # this rank's row
    out = {"wrapped": hasattr(prog, "_proglint_wrapped")}
    try:
        with DeviceMesh.from_group(pg, driver.AXIS):
            out["y"] = prog(x)
            out["again"] = prog(x)
    except ProgramScheduleMismatchError as e:
        out["mismatch"] = str(e)
        return out
    out["ddp"] = _ddp(rank)
    out["registry"] = [(name, k, fp.canonical()) for name, k, fp in proglint.registry().entries()]
    return out
