"""One rank of a multiproc gang test: joins a gloo gang on the CPU through
the port's `init_process_group(init_method="tcp://...")`, runs
`gang(rank, world, *args)` of the cases module named first, pickles its
dict of results and destroys the group. A module whose `own_group(*args)`
is true brings its gang up itself: `gang(rank, world, port, *args)` runs
without a group.

    python -m tests._torch_mp_worker MODULE RANK WORLD PORT OUT [ARGS...]

The cases modules import neither JAX nor the JAX package: the test that
launches the gang holds their results to the reference.
"""

import importlib
import pickle
import sys


def main(argv):
    module, rank, world, port, out = argv[0], int(argv[1]), int(argv[2]), int(argv[3]), argv[4]
    import pytorch_distributed_example_tpu_torch as tdx

    cases = importlib.import_module(module)
    if getattr(cases, "own_group", lambda *a: False)(*argv[5:]):
        res = cases.gang(rank, world, port, *argv[5:])
        with open(out, "wb") as f:
            pickle.dump(res, f)
        return

    tdx.init_process_group(backend="gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                           world_size=world, device="cpu", timeout=60)
    try:
        res = cases.gang(rank, world, *argv[5:])
    finally:
        tdx.destroy_process_group()
    with open(out, "wb") as f:
        pickle.dump(res, f)


if __name__ == "__main__":
    main(sys.argv[1:])
