"""R011 in the port's idiom: host effects under torch.func transforms,
torch.compile and activation checkpointing, next to device-pure bodies
that must stay clean."""

import functools

import torch
from torch.func import grad, grad_and_value, vjp, vmap
from torch.utils.checkpoint import checkpoint


def probe(x):
    return x.item()  # expect: R011


def rank_body(x):
    return probe(x) + 1.0  # expect: R011


def run_ranks(xs):
    return vmap(rank_body)(xs)


@torch.compile
def compiled_step(x):
    return x.tolist()  # expect: R011


@functools.partial(torch.compile, fullgraph=True)
def compiled_partial(x, store):
    return store.get("plan/agreed")  # expect: R011


def loss_synced(w, x):
    torch.cuda.synchronize()  # expect: R011
    return (w * x).sum()


grad_fn = grad(loss_synced)


def objective(w, x):
    return (w * x).cpu()  # expect: R011


def make_step(remat):
    obj = functools.partial(checkpoint, objective) if remat else objective
    return grad_and_value(obj)


def numpy_under_vjp(x):
    return x.numpy(force=True)  # expect: R011


def pull(x):
    return vjp(numpy_under_vjp, x)


def lambda_root(xs, faults):
    return vmap(lambda x: fire_point(x, faults))(xs)


def fire_point(x, faults):
    faults.fire("train.step")  # expect: R011
    return x


# --- clean: device-pure transformed bodies, host effects off the trace ---


def pure(x):
    return (x * 2.0).sum()


def run_pure(xs):
    return vmap(pure)(xs)


def layer(x):
    return torch.tanh(x) * x


def remat_layer(x):
    return checkpoint(layer, x, use_reentrant=False)


def report(xs):
    out = run_pure(xs)
    return out.cpu().tolist()
