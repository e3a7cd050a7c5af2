"""Serve worker gang member — the process the elastic agent spawns; the
port of the reference's `examples/serve_worker/main.py`.

One `ServeWorker` per gang member: builds a deterministic engine (every
rank of every generation builds the same weights from --seed, so a
re-formed gang replays token-identically), connects to the agent's
store, runs the generation-entry protocol (start fault point →
leader-elected geometry restore → register), and serves the shared
ledger until the agent signals drain or the front door shuts the plane
down.

Launch under the agent (one card, a gang of 2 that may grow to 3):

    python -m pytorch_distributed_example_tpu_torch.elastic.run \\
        --standalone --nproc-per-node 2:3 --serve-drain-grace-s 30 \\
        -m pytorch_distributed_example_tpu_torch.examples.serve_worker \\
        --config CFG_1B

then drive traffic and resizes from a controller process through
`serve.worker.GangRouter` + `serve.worker.ElasticGangScaler`.

Each worker takes ``cuda:{LOCAL_RANK % device_count}``, so on one card
the whole gang shares cuda:0; ``--cpu`` (or ``TDX_SERVE_CPU=1``) runs it
on the CPU. On the card TF32 is off, as everywhere the port holds token
streams. ``--config CFG_1B`` serves the ~1B model (vocab 32000, d 2048,
16 layers, 16 heads, max_seq_len 2048, bf16); the default is the small
CI model.

Pre-warm knobs: ``TDX_COMPILE_CACHE=<dir>`` points the kernels' build
cache at a directory every incarnation shares and warms the engine's
program calls at startup. ``TDX_PREWARM_DIR=<dir>``: the first
incarnation to arrive warms its engine and writes the manifest there,
and every later incarnation (any gang width) passes it to the engine's
``precompiled=``, which warms at construction (`serve/prewarm.py`).

``--debug-port P`` joins the generation's process group (gloo, on the
CPU: it carries no tensors) and serves `utils/debug_http.py`'s routes on
port P + rank, the engine's metrics at ``/serve``. At exit each worker
prints one ``serve_worker timings`` JSON line of wall-clock stamps: its
start, CUDA ready, model built, engine built (with its warm pass),
registered, and its first token.
"""

from __future__ import annotations

import argparse
import json
import os
import time

T_START = time.time()

import torch  # noqa: E402

CONFIGS = {
    "CFG_1B": dict(vocab_size=32000, d_model=2048, n_layers=16, n_heads=16,
                   max_seq_len=2048, bf16=True),
}


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser()
    p.add_argument("--vocab", type=int, default=64)
    p.add_argument("--d-model", type=int, default=32)
    p.add_argument("--layers", type=int, default=2)
    p.add_argument("--heads", type=int, default=4)
    p.add_argument("--max-seq-len", type=int, default=32)
    p.add_argument("--config", choices=sorted(CONFIGS), default=None,
                   help="a named model in place of the small one")
    p.add_argument("--slots", type=int, default=4)
    p.add_argument("--min-bucket", type=int, default=16)
    p.add_argument("--temperature", type=float, default=0.0)
    p.add_argument("--seed", type=int, default=0,
                   help="weight init seed — identical across the gang")
    p.add_argument("--poll-interval-s", type=float, default=0.005)
    p.add_argument("--debug-port", type=int, default=0,
                   help="serve the debug HTTP routes on this port + rank")
    p.add_argument("--cpu", action="store_true", help="run on the CPU")
    return p.parse_args(argv)


def model_config(args):
    """The TransformerConfig of --config, or of the small flags."""
    from ..models import TransformerConfig

    if args.config is not None:
        kw = dict(CONFIGS[args.config])
        dtype = torch.bfloat16 if kw.pop("bf16") else torch.float32
        return TransformerConfig(**kw, dtype=dtype, use_flash=False)
    return TransformerConfig(vocab_size=args.vocab, d_model=args.d_model,
                             n_layers=args.layers, n_heads=args.heads,
                             max_seq_len=args.max_seq_len, dtype=torch.float32,
                             use_flash=False)


def build_model(args, device):
    """The gang's model: the same weights on every rank from --seed."""
    from ..models import TransformerLM

    return TransformerLM(model_config(args), device=device,
                         generator=torch.Generator(device).manual_seed(args.seed))


def worker_device(cpu: bool) -> torch.device:
    if cpu:
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass --cpu to serve on the CPU")
    local = int(os.environ.get("LOCAL_RANK", "0"))
    return torch.device("cuda", local % torch.cuda.device_count())


def stamped_engine_class():
    """`ServeEngine`, also keeping the wall-clock time of its first emitted
    token (its clock is time.time): the engine notes every prefill's first
    token with `_note_recovery`, restored or not."""
    from ..serve.engine import ServeEngine

    class StampedEngine(ServeEngine):
        first_token = None

        def _note_recovery(self, now):
            if self.first_token is None:
                self.first_token = now
            super()._note_recovery(now)

    return StampedEngine


def main(argv=None) -> str:
    args = parse_args(argv)
    stamps = {"start": T_START}
    cache_dir = os.environ.get("TDX_COMPILE_CACHE", "")
    if cache_dir:
        from ..serve.prewarm import enable_compile_cache

        enable_compile_cache(cache_dir)
    cpu = args.cpu or bool(os.environ.get("TDX_SERVE_CPU"))
    dev = worker_device(cpu)
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.cuda.set_device(dev)
        torch.zeros((), device=dev)
        torch.cuda.synchronize(dev)
    stamps["cuda_ready"] = time.time()

    from ..serve.worker import ServeWorker, worker_store_from_env

    rank = int(os.environ.get("RANK", "0"))
    gen = int(os.environ.get("TDX_RESTART_COUNT", "0"))
    model = build_model(args, dev)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    stamps["model_built"] = time.time()
    prewarm_dir = os.environ.get("TDX_PREWARM_DIR", "")
    precompiled = None
    if prewarm_dir:
        from ..serve.prewarm import load_precompiled

        precompiled = load_precompiled(prewarm_dir) or None
    engine = stamped_engine_class()(
        model,
        slots=args.slots,
        temperature=args.temperature,
        min_bucket=args.min_bucket,
        precompiled=precompiled,
        # wall clock: the front door stamps arrivals with time.time
        # from ANOTHER process — TTFT/SLO math needs one timebase
        clock=time.time,
    )
    warm_s = sum(engine.prewarm_timings.values())
    if prewarm_dir and precompiled is None:
        # first incarnation to arrive: pay the first calls once and write
        # the manifest for every later generation at any gang width
        from ..serve.prewarm import prewarm_engine_programs

        timings = prewarm_engine_programs(engine, save_dir=prewarm_dir)
        warm_s = sum(timings.values())
        print(f"[gen {gen}] rank {rank}: pre-warmed {len(timings)} program calls "
              f"({warm_s:.2f}s total)", flush=True)
    elif cache_dir:
        from ..serve.prewarm import prewarm_engine_programs

        timings = prewarm_engine_programs(engine)
        warm_s = sum(timings.values())
        print(f"[gen {gen}] rank {rank}: cache-warmed {len(timings)} program calls "
              f"({warm_s:.2f}s total)", flush=True)
    stamps["engine_built"] = time.time()

    server = None
    if args.debug_port:
        from .. import distributed as dist
        from ..utils.debug_http import DebugServer

        dist.init_process_group(backend="gloo", init_method="env://", device="cpu")
        server = DebugServer(port=args.debug_port + rank)
        server.register_serve_metrics("engine", engine.metrics)

    store = worker_store_from_env()
    worker = ServeWorker(
        store,
        engine,
        rank=rank,
        gen=gen,
        poll_interval_s=args.poll_interval_s,
    ).start()
    stamps["registered"] = time.time()
    print(f"[gen {gen}] rank {rank}: serving (leader={worker.is_leader}, "
          f"restored={worker.restored})", flush=True)
    reason = worker.serve_forever()
    stamps["first_token"] = engine.first_token
    print("serve_worker timings " + json.dumps(
        {"gen": gen, "rank": rank, "warm_s": warm_s, "restored": worker.restored,
         "peak_bytes": torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0,
         "recovery": engine.metrics.snapshot().get("recovery"), **stamps}), flush=True)
    if server is not None:
        from .. import distributed as dist

        server.shutdown()
        dist.destroy_process_group()
    print(f"[gen {gen}] rank {rank}: exiting ({reason})", flush=True)
    return reason


if __name__ == "__main__":
    main()
