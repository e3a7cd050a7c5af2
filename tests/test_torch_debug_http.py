"""The port's debug HTTP frontend (`utils/debug_http.py`), on the CPU.

Every route over a live port process group: the index (the reference's,
byte for byte), `/world`, `/status` and `/flight_recorder` after a
collective, `/ddp_logging` from a `DistributedDataParallel`'s logger,
`/serve` from an engine's metrics, an unknown route's 404 and a failing
handler's 500. Then the serve worker example's ``--debug-port`` under the
elastic agent: each rank of a 2-process gang answers `/world` with the
gang's size and `/serve` with its engine's metrics.
"""

import json
import os
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

import pytorch_distributed_example_tpu_torch as tdx
from pytorch_distributed_example_tpu.utils import debug_http as jdebug
from pytorch_distributed_example_tpu_torch.utils.debug_http import DebugServer

from tests._mp_util import free_port


def _get(url, path):
    with urllib.request.urlopen(url + path, timeout=10) as r:
        return json.loads(r.read().decode())


@pytest.fixture()
def default_pg():
    own = not tdx.is_initialized()
    if own:
        tdx.init_process_group(world_size=2, device="cpu")
    yield tdx.distributed._get_default_group()
    if own:
        tdx.destroy_process_group()


@pytest.fixture()
def server():
    srv = DebugServer()
    yield srv
    srv.shutdown()


def test_index_matches_the_reference(server):
    ref = jdebug.DebugServer()
    try:
        assert _get(server.url, "/") == _get(ref.url, "/")
        assert _get(server.url, "/?x=1") == _get(server.url, "")
    finally:
        ref.shutdown()


def test_world_before_init(server):
    if tdx.is_initialized():
        pytest.skip("a port process group is live in this process")
    assert _get(server.url, "/world") == {"initialized": False}
    assert _get(server.url, "/status") == {}


def test_routes_serve_runtime_state(default_pg, server):
    w = _get(server.url, "/world")
    assert w["initialized"] and w["mode"] == "driver"
    assert w["groups"]["default_pg"]["size"] == default_pg.size() == 2
    assert w["groups"]["default_pg"]["ranks"] == [0, 1]

    t = tdx.DistTensor.from_rank_fn(lambda r: torch.tensor([float(r)]))
    tdx.all_reduce(t)
    st = _get(server.url, "/status")
    assert st["default_pg"]["last_enqueued_op"] == "all_reduce"
    fr = _get(server.url, "/flight_recorder")
    assert any(e.get("op") == "all_reduce" for e in fr["entries"])

    from pytorch_distributed_example_tpu_torch.models import ConvNet

    ddp = tdx.DistributedDataParallel(
        ConvNet(device="cpu", generator=torch.Generator().manual_seed(0)))
    server.register_ddp_logger("convnet", ddp.logger)
    assert _get(server.url, "/ddp_logging")["convnet"]["world_size"] == 2


def test_serve_route_reads_engine_metrics(server):
    from pytorch_distributed_example_tpu_torch.models import TransformerConfig, TransformerLM
    from pytorch_distributed_example_tpu_torch.serve import ServeEngine

    cfg = TransformerConfig(vocab_size=64, d_model=32, n_layers=2, n_heads=4,
                            max_seq_len=32, use_flash=False, dtype=torch.float32)
    eng = ServeEngine(TransformerLM(cfg, device="cpu",
                                    generator=torch.Generator().manual_seed(0)),
                      slots=2, min_bucket=4)
    server.register_serve_metrics("engine", eng.metrics)
    eng.submit(np.arange(1, 6, dtype=np.int32), 3, rid="a")
    eng.run(max_steps=50)
    snap = _get(server.url, "/serve")["engine"]
    assert snap["completed"] == 1 and snap["slots"] == 2


def test_unknown_route_404_and_handler_failure_500(server):
    with pytest.raises(urllib.error.HTTPError) as e:
        _get(server.url, "/nope")
    assert e.value.code == 404
    assert json.loads(e.value.read()) == {"error": "unknown route"}

    class Broken:
        def get_ddp_logging_data(self):
            raise KeyError("gone")

    server.register_ddp_logger("broken", Broken())
    with pytest.raises(urllib.error.HTTPError) as e:
        _get(server.url, "/ddp_logging")
    assert e.value.code == 500
    assert "KeyError" in json.loads(e.value.read())["error"]


def test_serve_worker_gang_answers_its_size():
    """The example's ``--debug-port`` under the agent: rank r listens on
    port + r, `/world` names the 2-process gang, `/serve` the engine."""
    from pytorch_distributed_example_tpu_torch.elastic import LocalElasticAgent, WorkerSpec
    from pytorch_distributed_example_tpu_torch.serve.worker import GangRouter, wait_registered
    from pytorch_distributed_example_tpu_torch.store import TCPStore

    port, debug = free_port(), free_port()
    spec = WorkerSpec(
        entrypoint=["pytorch_distributed_example_tpu_torch.examples.serve_worker",
                    "--slots", "2", "--min-bucket", "4", "--debug-port", str(debug)],
        module=True, nproc_per_node=2, master_port=port, max_restarts=0,
        env={"TDX_SERVE_CPU": "1", "OMP_NUM_THREADS": "1"},
    )
    agent = LocalElasticAgent(spec)
    res = {}
    th = threading.Thread(target=lambda: res.update(run=agent.run()), daemon=True)
    th.start()
    store = TCPStore("127.0.0.1", port, is_master=False, timeout=60.0)
    try:
        wait_registered(store, 0, 2, timeout=120.0)
        router = GangRouter(store)
        rid = router.submit(np.arange(1, 6, dtype=np.int32), 3, rid="a")
        assert len(router.wait_all([rid], timeout=60.0)[rid]) == 3
        for r in range(2):
            url = f"http://127.0.0.1:{debug + r}"
            w = _get(url, "/world")
            assert w["mode"] == "multiproc" and w["process_rank"] == r
            assert w["groups"]["default_pg"]["size"] == 2
            assert "default_pg" in _get(url, "/status")
            assert "entries" in _get(url, "/flight_recorder")
            assert _get(url, "/serve")["engine"]["slots"] == 2
        done = sum(_get(f"http://127.0.0.1:{debug + r}", "/serve")["engine"]["completed"]
                   for r in range(2))
        assert done == 1
        router.shutdown()
        th.join(timeout=60.0)
        assert "SUCCEEDED" in str(res["run"].state)
    finally:
        if th.is_alive():  # a failed check: stop the gang (the agent's store is still up)
            GangRouter(store).shutdown(sweep=False)
            th.join(timeout=30.0)
        store.close()
