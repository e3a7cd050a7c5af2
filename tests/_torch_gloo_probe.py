"""Which of torch.distributed's gloo ops take CUDA tensors: the evidence
for the staging table of `backends/process.py` (`GLOO_CUDA_STAGED`).

    python3 tests/_torch_gloo_probe.py             # every op, a line each
    python3 tests/_torch_gloo_probe.py OP [OP ...]

Needs a card. Each gang is two processes on cuda:0 over torch's
"cpu:gloo,cuda:gloo" backend, each op on a CUDA tensor whose values say
which rank it came from. The collectives run in one gang; send/recv runs
in a gang of its own, since gloo's send can abort the process on a CUDA
tensor. Each op prints `OP: ok`, `OP: wrong values`, `OP: raises ...` or
`OP: the gang died (exit codes ...)`. An op that raises or aborts ends
its gang, and the ops after it run again in a new one.
"""

import os
import socket
import subprocess
import sys

COLLECTIVES = ("all_reduce", "broadcast", "all_gather", "gather", "scatter",
               "all_to_all_single", "reduce", "reduce_scatter")
POINT_TO_POINT = ("send_recv",)
TIMEOUT_S = 120


def _run_op(op, rank, d, torch):
    """True when `op` gave the right values on this rank."""
    x = torch.full((4,), float(rank + 1), device="cuda")
    if op == "all_reduce":
        d.all_reduce(x)
        return x.tolist() == [3.0] * 4
    if op == "broadcast":
        d.broadcast(x, 1)
        return x.tolist() == [2.0] * 4
    if op == "all_gather":
        out = [torch.empty_like(x) for _ in range(2)]
        d.all_gather(out, x)
        return [t.tolist() for t in out] == [[1.0] * 4, [2.0] * 4]
    if op == "gather":
        out = [torch.empty_like(x) for _ in range(2)] if rank == 0 else None
        d.gather(x, out, dst=0)
        return rank != 0 or [t.tolist() for t in out] == [[1.0] * 4, [2.0] * 4]
    if op == "scatter":
        out = torch.empty_like(x)
        d.scatter(out, [x, x + 10] if rank == 0 else None, src=0)
        return out.tolist() == ([1.0] * 4 if rank == 0 else [11.0] * 4)
    if op == "all_to_all_single":
        out = torch.empty_like(x)
        d.all_to_all_single(out, x)
        return out.tolist() == [1.0, 1.0, 2.0, 2.0]
    if op == "reduce":
        d.reduce(x, dst=0)
        return rank != 0 or x.tolist() == [3.0] * 4
    if op == "reduce_scatter":
        out = torch.empty(2, device="cuda")
        d.reduce_scatter_tensor(out, x)
        return out.tolist() == [3.0, 3.0]
    if op == "send_recv":
        if rank == 0:
            d.send(x, 1)
            return True
        d.recv(x, 0)
        return x.tolist() == [1.0] * 4
    raise ValueError(f"unknown op {op!r}")


def _worker(rank, port, ops):
    import datetime

    import torch
    import torch.distributed as d

    torch.cuda.set_device(0)
    d.init_process_group("cpu:gloo,cuda:gloo", init_method=f"tcp://127.0.0.1:{port}",
                         rank=rank, world_size=2, timeout=datetime.timedelta(seconds=60))
    for op in ops:
        try:
            ok = _run_op(op, rank, d, torch)
            torch.cuda.synchronize()
        except Exception as e:
            print(f"{op}: raises {type(e).__name__}: {str(e)[:120]}", flush=True)
            raise  # the peer may wait in this op: the gang ends here
        print(f"{op}: {'ok' if ok else 'wrong values'}", flush=True)
    d.destroy_process_group()


def _gang(ops):
    """{op: verdict} of one two-process gang running `ops` in order."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--rank", str(r),
                               str(port), *ops],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
             for r in range(2)]
    outs = []
    try:
        for p in procs:
            try:
                outs.append(p.communicate(timeout=TIMEOUT_S)[0].decode(errors="replace"))
            except subprocess.TimeoutExpired:
                outs.append("")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    codes = [p.returncode for p in procs]
    verdicts = {}
    for op in ops:
        seen = [line.split(": ", 1)[1] for text in outs for line in text.splitlines()
                if line.startswith(f"{op}: ")]
        if len(seen) < 2:
            verdicts[op] = f"the gang died (exit codes {codes})"
        else:
            verdicts[op] = next((v for v in seen if v != "ok"), "ok")
    return verdicts


def _gangs(ops):
    """{op: verdict} of `ops` in order: a gang runs them up to the first
    that does not pass, and a new gang the ones after it."""
    out, todo = {}, list(ops)
    while todo:
        got = _gang(todo)
        n = next((i + 1 for i, op in enumerate(todo) if got[op] != "ok"), len(todo))
        out.update((op, got[op]) for op in todo[:n])
        todo = todo[n:]
    return out


def probe(ops=COLLECTIVES + POINT_TO_POINT):
    """{op: verdict}: the collectives in one gang, each point-to-point op
    in one of its own."""
    out = _gangs([op for op in ops if op in COLLECTIVES])
    for op in ops:
        if op not in COLLECTIVES:
            out.update(_gangs([op]))
    return out


if __name__ == "__main__":
    if sys.argv[1:2] == ["--rank"]:
        _worker(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4:])
        sys.exit(0)
    for op, verdict in probe(tuple(sys.argv[1:]) or COLLECTIVES + POINT_TO_POINT).items():
        print(f"{op}: {verdict}", flush=True)
