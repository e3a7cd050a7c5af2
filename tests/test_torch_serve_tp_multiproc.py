"""Tensor-parallel serving as a process gang, and TP decode of the MoE MLP.

The engine's ``mesh=`` over a multiproc ("tp", 2) mesh: a gloo gang of two
processes on the CPU (`tests/_torch_mp_serve_tp.py`), one engine a
process, against the reference's TP 2 engine on two of the conftest's
virtual CPU devices and against the port's driver-mode TP 2 engine: the
tiny float32 model of `test_torch_serve_tp.py` (vocab 64, d 32, 2 layers,
4 heads over 2 KV heads, block size 4), the same traffic, greedy tokens
equal token for token on both processes, with the int8 pool, prefix
sharing and pool pressure too; one decode call's logits equal on both
processes and within rtol 1e-5 / atol 1e-6 of driver mode's.

Then the MoE's TP decode (4 experts, top-k 1 and 2) in driver mode at tp
2 against the reference's GSPMD TP engine: greedy tokens equal, and one
decode call's logits within rtol 1e-5 / atol 1e-5 of the single card's.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_distributed_example_tpu import serve as jserve
from pytorch_distributed_example_tpu.mesh import init_device_mesh
from pytorch_distributed_example_tpu.models import transformer as jtr
from pytorch_distributed_example_tpu_torch import serve as tserve
from pytorch_distributed_example_tpu_torch.mesh import DeviceMesh
from pytorch_distributed_example_tpu_torch.models import convert
from pytorch_distributed_example_tpu_torch.models import transformer as ttr
from tests import _torch_mp_serve_tp as cases
from tests._torch_gang import run_gang

LOGIT_TOL = dict(rtol=1e-5, atol=1e-6)
MOE_LOGIT_TOL = dict(rtol=1e-5, atol=1e-5)


@functools.lru_cache(maxsize=None)
def _pair(n_experts=0, top_k=1):
    jcfg = jtr.TransformerConfig(dtype=jnp.float32, n_experts=n_experts, moe_top_k=top_k,
                                 **cases.KW)
    jmodel = jtr.TransformerLM(jcfg)
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(0), jnp.zeros((1, 4), jnp.int32))
    state = convert.from_flax(jax.tree.map(np.asarray, params))
    tmodel = ttr.TransformerLM(ttr.TransformerConfig(
        dtype=torch.float32, n_experts=n_experts, moe_top_k=top_k, **cases.KW), device="cpu")
    tmodel.load_state_dict(state)
    return jmodel, params, tmodel


def _jmesh(T=2):
    return init_device_mesh(("tp",), (T,), devices=jax.devices()[:T])


def _tmesh(T=2):
    return DeviceMesh(["cpu"] * T, (T,), ("tp",))


@pytest.fixture(scope="module")
def gang(tmp_path_factory):
    _, _, tmodel = _pair()
    path = str(tmp_path_factory.mktemp("serve_tp_mp") / "state.pt")
    torch.save(tmodel.state_dict(), path)
    rcs, outs, res = run_gang("tests._torch_mp_serve_tp", tmp_path_factory.mktemp("gang"), 2,
                              args=(path, ",".join(sorted(cases.CASES))), timeout=240)
    assert rcs == [0, 0], "\n".join(outs)
    return res


@pytest.mark.parametrize("case", sorted(cases.CASES))
def test_gang_tp2_engine_matches_reference_and_driver_mode(gang, case):
    jmodel, params, tmodel = _pair()
    kw = dict(cases.ENGINE, **cases.CASES[case])
    want = cases.run(jserve.ServeEngine(jmodel, params, mesh=_jmesh(), **kw), case)
    driver = cases.run(tserve.ServeEngine(tmodel, mesh=_tmesh(), **kw), case)
    assert driver == want
    for r in range(2):
        got = gang[r][case]
        assert got["tokens"] == want, (r, case)
        # the KV-head shard of every block, the sink included
        assert got["pool_local"] == (1, got["pool_local"][1], cases.BS, 1, 8)
    if case == "pressure":
        assert gang[0][case]["preempted"] > 0
    if case == "prefix_cache":
        assert gang[0][case]["cow"] > 0


def test_gang_decode_logits_match_driver_mode(gang):
    _, _, tmodel = _pair()
    driver = tserve.ServeEngine(tmodel, mesh=_tmesh(), **cases.ENGINE)
    want = cases.decode_logits(driver.decoder, tmodel, _tmesh()).numpy()
    assert gang[0]["logits"].tobytes() == gang[1]["logits"].tobytes()
    np.testing.assert_allclose(gang[0]["logits"], want, **LOGIT_TOL)


@pytest.mark.parametrize("top_k", [1, 2])
def test_moe_tp2_decode_matches_reference_and_single_card(top_k):
    jmodel, params, tmodel = _pair(n_experts=4, top_k=top_k)
    kw = dict(cases.ENGINE)
    want = cases.run(jserve.ServeEngine(jmodel, params, mesh=_jmesh(), **kw), "plain")
    eng = tserve.ServeEngine(tmodel, mesh=_tmesh(), **kw)
    assert cases.run(eng, "plain") == want
    assert cases.run(tserve.ServeEngine(tmodel, **kw), "plain") == want
    with torch.no_grad():
        single = cases.decode_logits(tmodel, tmodel)
    np.testing.assert_allclose(cases.decode_logits(eng.decoder, tmodel, _tmesh()).numpy(),
                               single.numpy(), **MOE_LOGIT_TOL)
