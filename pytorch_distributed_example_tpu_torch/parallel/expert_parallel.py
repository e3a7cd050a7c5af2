"""Expert parallelism: top-k MoE routing, with all_to_all dispatch.

The port of the reference's `parallel/expert_parallel.py` (token-choice
top-k routing of the Switch/GShard family):

* the router scores every token (float32 softmax) and picks its top-k
  experts, ties to the lower expert index as `lax.top_k` breaks them;
* tokens take slots in per-expert capacity buffers, choice-major (every
  token's first choice before any second choice), in token order; a
  token past an expert's capacity is dropped for that choice;
* the experts run on their buffers, and each token sums its choices'
  outputs weighted by their gates (k=1: the softmax probability, Switch;
  k>1: the top-k probabilities renormalized, Mixtral);
* the Switch load-balance loss E * sum_e f_e * P_e is returned beside.

`moe_mlp(..., axis_name=None)` routes all of its tokens over all experts
(the model's MoE: the reference's trainer routes the global batch).
`make_ep_moe(mesh, "ep")` shards tokens and experts over the ``ep`` ranks
in driver mode: each rank routes its own tokens with its own capacity,
the buffers go to their experts' ranks and back by the differentiable
`nn.functional.all_to_all` (a fold over the rank dim), and the aux loss is
the ranks' mean, as the reference's `shard_map` form. Over a multiproc
mesh each process is one ep rank: it routes its own tokens, runs its own
experts, the buffers travel by the all_to_all of the ep group, and the
output is all-gathered, so the call and its result are driver mode's.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.nn.functional as F

from ..mesh import DeviceMesh
from ..nn import functional as nnf
from ..types import ReduceOp


def _gelu(x):
    return F.gelu(x, approximate="tanh")  # jax.nn.gelu's default


def capacity_for(tokens: int, n_experts: int, capacity_factor: float, k: int) -> int:
    """Slots per expert: int(capacity_factor * k * T / E), at least 1."""
    return max(1, int(capacity_factor * k * tokens / n_experts))


def _topk_routing(logits, n_experts: int, capacity: int, k: int = 1):
    """Token-choice top-k routing over logits (..., T, E), with any leading
    rank dims. Returns ((..., T, k) expert, gate, position, keep, aux (...)):
    position is the slot in the expert's buffer, assigned choice-major."""
    probs = torch.softmax(logits.float(), dim=-1)
    # a stable descending sort puts equal probabilities in index order,
    # as lax.top_k does
    _, order = torch.sort(probs, dim=-1, descending=True, stable=True)
    topi = order[..., :k]
    topv = probs.gather(-1, topi)
    gate = topv / topv.sum(-1, keepdim=True) if k > 1 else topv

    positions = []
    offsets = torch.zeros(probs.shape[:-2] + (1, n_experts), dtype=torch.int64,
                          device=probs.device)  # slots used by higher choices
    for j in range(k):
        onehot = F.one_hot(topi[..., j], n_experts)  # (..., T, E) int64
        pos_1b = offsets + torch.cumsum(onehot, dim=-2)
        positions.append((pos_1b * onehot).sum(-1) - 1)
        offsets = offsets + onehot.sum(-2, keepdim=True)
    position = torch.stack(positions, dim=-1)
    keep = position < capacity

    # Switch load-balance loss on the first choice
    frac_tokens = F.one_hot(topi[..., 0], n_experts).float().mean(-2)
    frac_probs = probs.mean(-2)
    aux = n_experts * (frac_tokens * frac_probs).sum(-1)
    return topi, gate, position, keep, aux


def dispatch(x, expert, position, keep, n_experts: int, capacity: int):
    """Tokens x (T, D) into per-expert buffers (E, C, D): each kept choice
    adds its token at (expert, slot); a dropped choice adds zeros at slot 0
    (the reference's `.at[...].add(mode="drop")` with its safe slot)."""
    T, D = x.shape
    k = expert.shape[-1]
    safe = torch.where(keep, position, torch.zeros_like(position))
    x_rep = x.repeat_interleave(k, dim=0)  # token-major: x[t] for each choice
    vals = torch.where(keep.reshape(-1, 1), x_rep, torch.zeros_like(x_rep))
    buf = x.new_zeros((n_experts, capacity, D))
    return buf.index_put((expert.reshape(-1), safe.reshape(-1)), vals, accumulate=True)


def combine(y, expert, position, gate, keep):
    """Expert outputs y (E, C, D) back to token order (T, D): the gate-
    weighted sum over each token's kept choices."""
    safe = torch.where(keep, position, torch.zeros_like(position))
    w = (gate * keep).to(y.dtype)
    return (y[expert, safe] * w.unsqueeze(-1)).sum(1)


def moe_mlp(x, w_up, w_down, router_w, axis_name: Optional[str] = None,
            capacity_factor: float = 1.25, act: Optional[Callable] = None, k: int = 1):
    """Top-k MoE MLP over tokens x (T, D) and every expert (E, D, F) /
    (E, F, D), router_w (D, E) in float32. Returns (y (T, D) in x's dtype,
    aux). The sharded form is `make_ep_moe`."""
    if axis_name is not None:
        raise ValueError("moe_mlp routes one rank's tokens over all experts; the ep-sharded "
                         "form is make_ep_moe(mesh, axis_name)")
    act = act or _gelu
    T, D = x.shape
    E = w_up.shape[0]
    logits = x.float() @ router_w.float()  # (T, E) float32
    capacity = capacity_for(T, E, capacity_factor, k)
    expert, gate, position, keep, aux = _topk_routing(logits, E, capacity, k)
    buf = dispatch(x, expert, position, keep, E, capacity)
    h = act(torch.einsum("ecd,edf->ecf", buf, w_up))
    y = torch.einsum("ecf,efd->ecd", h, w_down)
    return combine(y, expert, position, gate, keep).to(x.dtype), aux


def make_ep_moe(mesh: DeviceMesh, axis_name: str = "ep", capacity_factor: float = 1.25,
                k: int = 1, act: Optional[Callable] = None):
    """The ep-sharded MoE: fn(x (T, D), w_up (E, D, F),
    w_down (E, F, D), router_w (D, E)) -> (y (T, D), aux). Tokens and
    experts split over the ``ep`` ranks (contiguous blocks, rank-major);
    each rank routes its T/ep tokens over all E experts with capacity
    from its own count, its buffers of expert e go to rank e // (E/ep) by
    an all_to_all and the outputs come back by another; aux is the
    ranks' mean. Over a multiproc mesh this process's rank takes its
    tokens and experts out of the same global arguments, and the result,
    all-gathered, is the same global one."""
    act = act or _gelu
    if axis_name not in mesh.axis_names or len(mesh.shape) != 1:
        raise ValueError(f"make_ep_moe wants a 1-D mesh over {axis_name!r}, got {mesh}")
    ep, Wl = mesh.shape[0], mesh.local_shape[0]
    lo = mesh.axis_index(axis_name) or 0  # the first ep rank this process holds

    def mine(t):  # this process's ranks' blocks of a rank-major (ep, ...) tensor
        return t if Wl == ep else t[lo:lo + Wl]

    def fn(x, w_up, w_down, router_w):
        T, D = x.shape
        E = w_up.shape[0]
        if T % ep or E % ep:
            raise ValueError(f"{T} tokens and {E} experts must split over {ep} ranks")
        E_l, T_l = E // ep, T // ep
        xs = mine(x.reshape(ep, T_l, D))
        logits = xs.float() @ router_w.float()  # (Wl, T_l, E)
        C = capacity_for(T_l, E, capacity_factor, k)
        expert, gate, position, keep, aux = _topk_routing(logits, E, C, k)
        buf = torch.stack([dispatch(xs[r], expert[r], position[r], keep[r], E, C)
                           for r in range(Wl)])  # (Wl, E, C, D)
        # dispatch: rank r's buffers of expert group g go to rank g
        buf = nnf.all_to_all(buf.reshape(Wl, ep, E_l, C, D), axis_name, 0, 0)
        tokens = buf.transpose(1, 2).reshape(Wl, E_l, ep * C, D)  # by local expert
        h = act(torch.einsum("recd,redf->recf", tokens, mine(w_up.reshape(ep, E_l, D, -1))))
        y = torch.einsum("recf,refd->recd", h, mine(w_down.reshape(ep, E_l, -1, D)))
        y = y.reshape(Wl, E_l, ep, C, D).transpose(1, 2)  # (rank, src, E_l, C, D)
        # combine: the outputs go back to the tokens' ranks
        y = nnf.all_to_all(y, axis_name, 0, 0).reshape(Wl, E, C, D)
        out = torch.stack([combine(y[r], expert[r], position[r], gate[r], keep[r])
                           for r in range(Wl)])
        aux = nnf.all_reduce(aux, ReduceOp.AVG, axis_name, replica=True)
        if Wl != ep:  # every process's tokens, in rank order
            return nnf.all_gather(out.to(x.dtype), axis_name, 0, replica=True), aux
        return out.reshape(T, D).to(x.dtype), aux

    def run(*args):
        with mesh:
            return fn(*args)

    return run
