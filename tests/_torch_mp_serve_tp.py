"""Cases of `tests/test_torch_serve_tp_multiproc.py`: the port's serve
engine over a multiproc ("tp", 2) mesh, one engine a process of a gloo
gang on the CPU, each process holding its tp rank's weights, its KV-head
shard of the pool and a full copy of the slot lanes.

The model's weights come from the reference's init (a flax tree converted
by the test and saved as a torch state dict); the traffic is the test's.
Each process returns its engine's tokens by request, one decode call's
logits, and what the plane and the pool show. No JAX here.
"""

import numpy as np
import torch

from pytorch_distributed_example_tpu_torch import serve as tserve
from pytorch_distributed_example_tpu_torch.dtensor import DTensor
from pytorch_distributed_example_tpu_torch.mesh import init_device_mesh
from pytorch_distributed_example_tpu_torch.models import transformer as ttr

M, BS, V = 32, 4, 64
KW = dict(vocab_size=V, d_model=32, n_layers=2, n_heads=4, n_kv_heads=2, max_seq_len=M,
          use_flash=False)
CASES = {
    "plain": dict(),
    "kv_quant": dict(kv_quant=True),
    "prefix_cache": dict(prefix_cache=True),
    "pressure": dict(slots=3, pool_blocks=8),
}
ENGINE = dict(slots=2, min_bucket=4, block_size=BS, prefill_chunk_tokens=4)
BUDGETS = [6, 4, 9, 5]


def model(state_path: str, n_experts: int = 0, top_k: int = 1):
    cfg = ttr.TransformerConfig(dtype=torch.float32, n_experts=n_experts, moe_top_k=top_k,
                                **KW)
    m = ttr.TransformerLM(cfg, device="cpu")
    m.load_state_dict(torch.load(state_path))
    return m


def prompts(case: str):
    gen = np.random.default_rng(0)
    out = [gen.integers(0, V, (n,)).astype(np.int32) for n in (5, 7, 3, 6)]
    if case == "prefix_cache":
        out = [np.concatenate([np.arange(9, dtype=np.int32), p]) for p in out]
    return out


def run(eng, case: str):
    rids = [eng.submit(p, b, rid=f"r{i}", seed=i)
            for i, (p, b) in enumerate(zip(prompts(case), BUDGETS))]
    out = eng.run(max_steps=800)
    return [out[r].tokens for r in rids]


def decode_logits(decoder, tmodel, mesh=None):
    """One decode call of `decoder` on a fresh pool, sharded over `mesh`
    when one is given: (2, 4, V)."""
    from pytorch_distributed_example_tpu_torch.parallel.tensor_parallel import shard_kv_pool

    cache = tserve.PagedKVCache(tmodel, 2, num_blocks=8, block_size=BS)
    tree = shard_kv_pool(cache.tree, mesh) if mesh is not None else cache.tree
    toks = torch.as_tensor(prompts("plain")[0][:4]).long()[None].repeat(2, 1)
    tables = np.arange(4, dtype=np.int32).reshape(2, 2)
    return decoder(toks, decode=True, positions=torch.zeros(2, dtype=torch.int32),
                   block_tables=tables, cache=tree)


def gang(rank, world, state_path, cases):
    mesh = init_device_mesh(("tp",), (world,))
    tmodel = model(state_path)
    res = {}
    for case in cases.split(","):
        eng = tserve.ServeEngine(tmodel, mesh=mesh, **dict(ENGINE, **CASES[case]))
        k0 = eng.cache.tree["layers_0"]["attn"]["k"]
        res[case] = {"tokens": run(eng, case), "preempted": eng.metrics.preempted,
                     "cow": getattr(eng.cache, "cow_copies", 0),
                     "pool_local": tuple(k0._local.shape) if isinstance(k0, DTensor) else None}
    res["logits"] = decode_logits(eng.decoder, tmodel, mesh).numpy()
    return res
