"""tpurun — the launcher CLI (torchrun equivalent).

A copy of the reference's `elastic/run.py`, with its flags. Parity
surface: `torch/distributed/run.py:410,985`: spawn `--nproc-per-node`
workers with rendezvous env, monitor, restart up to `--max-restarts`.

Usage:
    python -m pytorch_distributed_example_tpu_torch.elastic.run \
        --nproc-per-node 2 --max-restarts 3 my_script.py --my-arg 1

Serving on one card, a gang of 2 that may grow to 3:

    python -m pytorch_distributed_example_tpu_torch.elastic.run \
        --standalone --nproc-per-node 2:3 --serve-drain-grace-s 30 \
        -m pytorch_distributed_example_tpu_torch.examples.serve_worker

One process a card is the usual layout; processes that share a card
meet over ``"cuda:gloo"`` (nccl refuses two ranks on one GPU).
"""

from __future__ import annotations

import argparse
import sys

from .agent import LocalElasticAgent, WorkerSpec, WorkerState


def _size_range(val: str):
    """torchrun size syntax: "N" (fixed) or "MIN:MAX" (elastic,
    torch/distributed/run.py:410). Returns (min, max)."""
    if ":" in val:
        lo, _, hi = val.partition(":")
        lo, hi = int(lo), int(hi)
    else:
        lo = hi = int(val)
    if not 1 <= lo <= hi:
        raise argparse.ArgumentTypeError(f"bad size range {val!r}")
    return lo, hi


def parse_args(argv=None):
    p = argparse.ArgumentParser(prog="tpurun")
    p.add_argument("--nproc-per-node", type=_size_range, default=(1, 1),
                   help="workers per node; MIN:MAX makes the local worker "
                        "group elastic (dynamic world size)")
    p.add_argument("--nnodes", type=_size_range, default=(1, 1),
                   help="number of nodes (torchrun --nnodes); MIN:MAX is "
                        "elastic — single-agent deployments map the node "
                        "range onto the local worker group")
    p.add_argument("--node-rank", type=int, default=0,
                   help="this node's rank; node 0 hosts the rendezvous store")
    p.add_argument("--max-restarts", type=int, default=3)
    p.add_argument("--monitor-interval", type=float, default=0.1)
    p.add_argument("--master-addr", type=str, default="127.0.0.1")
    p.add_argument("--master-port", type=int, default=0)
    p.add_argument("--rdzv-endpoint", type=str, default=None,
                   help="host[:port] of the rendezvous store (alias for "
                        "--master-addr/--master-port; port defaults to "
                        "29500)")
    p.add_argument("--standalone", action="store_true",
                   help="single-node ephemeral rendezvous (torchrun "
                        "--standalone): ignore any rdzv endpoint")
    p.add_argument("--no-store-failover", action="store_true",
                   help="node-elastic: disable the standby rendezvous "
                        "store (by default survivors promote a standby "
                        "and re-form when the store HOST dies)")
    p.add_argument("--advertise-addr", type=str, default=None,
                   help="this node's dialable address for the standby "
                        "store (defaults to a hostname lookup; loopback "
                        "when the rdzv endpoint is loopback)")
    p.add_argument("--serve-drain-grace-s", type=float, default=0.0,
                   help="seconds serve loops get to drain + checkpoint "
                        "before a restart/resize teardown SIGTERMs them "
                        "(serve worker deployments; 0 = no grace)")
    p.add_argument("--log-dir", type=str, default=None)
    p.add_argument("--no-python", action="store_true",
                   help="entrypoint is a raw command, not a python script")
    p.add_argument("-m", "--module", action="store_true",
                   help="entrypoint is a module name (python -m ...)")
    p.add_argument("entrypoint", nargs=argparse.REMAINDER)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    if not args.entrypoint:
        print("tpurun: missing entrypoint script", file=sys.stderr)
        return 2
    master_addr, master_port = args.master_addr, args.master_port
    if args.standalone:
        args.nnodes, args.node_rank = (1, 1), 0
        master_addr, master_port = "127.0.0.1", 0
    elif args.rdzv_endpoint:
        if ":" in args.rdzv_endpoint:
            host, _, port = args.rdzv_endpoint.rpartition(":")
            try:
                master_addr, master_port = host, int(port)
            except ValueError:
                print(
                    f"tpurun: invalid --rdzv-endpoint {args.rdzv_endpoint!r} "
                    "(expected host[:port])",
                    file=sys.stderr,
                )
                return 2
        else:
            master_addr, master_port = args.rdzv_endpoint, 29500
    min_proc, max_proc = args.nproc_per_node
    min_nodes, max_nodes = args.nnodes
    if min_nodes != max_nodes and min_proc != max_proc:
        print(
            "tpurun: give an elastic range on --nnodes OR "
            "--nproc-per-node, not both (the combined minimum would be "
            "ambiguous)",
            file=sys.stderr,
        )
        return 2
    min_nnodes = None
    if min_nodes != max_nodes:
        if master_port != 0:
            # real multi-agent deployment (explicit rendezvous port):
            # NODE-level elastic — each node runs its own agent; agents
            # heartbeat through the store, re-form on node loss, and
            # admit late-started agents at generation boundaries
            min_nnodes = min_nodes
        else:
            # standalone: a single local agent hosts the whole gang, so
            # the node range maps onto the worker-group range (the gang
            # scales between min*nproc and max*nproc workers)
            if args.node_rank != 0:
                print(
                    "tpurun: standalone --nnodes MIN:MAX requires a "
                    "single agent (node-rank 0); give --rdzv-endpoint "
                    "for true multi-node elasticity",
                    file=sys.stderr,
                )
                return 2
            min_proc, max_proc = min_nodes * max_proc, max_nodes * max_proc
            min_nodes = max_nodes = 1
    try:
        spec = WorkerSpec(
            entrypoint=args.entrypoint,
            nproc_per_node=max_proc,
            min_nproc=min_proc if min_proc != max_proc else None,
            nnodes=max_nodes,
            min_nnodes=min_nnodes,
            node_rank=args.node_rank,
            max_restarts=args.max_restarts,
            monitor_interval_s=args.monitor_interval,
            master_addr=master_addr,
            master_port=master_port,
            raw_cmd=args.no_python,
            module=args.module,
            serve_drain_grace_s=args.serve_drain_grace_s,
            store_failover=not args.no_store_failover,
            advertise_addr=args.advertise_addr,
        )
    except ValueError as e:  # e.g. proc range with --nnodes > 1
        print(f"tpurun: {e}", file=sys.stderr)
        return 2
    result = LocalElasticAgent(spec, log_dir=args.log_dir).run()
    if result.state is WorkerState.SUCCEEDED:
        return 0
    print(
        f"tpurun: workers failed after {result.restarts} restart(s): "
        f"{result.return_codes}",
        file=sys.stderr,
    )
    return 1


if __name__ == "__main__":
    sys.exit(main())
