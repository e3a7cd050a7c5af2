"""Sharding rules: parameter name -> layout over a mesh.

The port of the reference's `parallel/sharding.py`. A rule table maps
parameter-name regexes to a spec: a tuple with one entry per tensor dim,
each a mesh-axis name (or a tuple of names) or None. The first match wins;
no match means replicated. The names are the port's own, the
`state_dict` keys (`layers.0.attn.q_proj.weight`), and its weights keep
torch's (out, in) layout. A spec turns into a `DTensor`'s placements
(`dtensor.spec_to_placements`); `shard_params` lays every parameter out
so, as the reference's `device_put` to a `NamedSharding` does.
"""

from __future__ import annotations

import re
from typing import Dict, Optional, Sequence, Tuple, Union

import torch

from ..dtensor import distribute_tensor, spec_to_placements
from ..mesh import DeviceMesh

AxisName = Optional[Union[str, Tuple[str, ...]]]
Spec = Tuple[AxisName, ...]
Rule = Tuple[str, Spec]


def _named(params) -> Dict[str, torch.Tensor]:
    if isinstance(params, torch.nn.Module):
        return dict(params.state_dict())
    return dict(params)


def spec_for(path: str, shape: Tuple[int, ...], rules: Sequence[Rule],
             mesh: Optional[DeviceMesh] = None) -> Spec:
    """First-match rule lookup -> spec, checked against the shape.

    An axis whose size does not divide its dim is dropped (that dim is
    replicated), as FSDP leaves small leftover parameters whole."""
    for pat, axes in rules:
        if not re.search(pat, path):
            continue
        if len(axes) > len(shape):
            continue
        padded = tuple(axes) + (None,) * (len(shape) - len(axes))
        if mesh is not None:
            sizes = dict(zip(mesh.axis_names, mesh.shape))
            checked = []
            for dim, ax in zip(shape, padded):
                if ax is None:
                    checked.append(None)
                    continue
                size = 1
                for a in (ax if isinstance(ax, tuple) else (ax,)):
                    if a not in sizes:
                        raise ValueError(
                            f"sharding rule {pat!r} names mesh axis {a!r} but the mesh only "
                            f"has axes {tuple(sizes)} (param path {path!r})")
                    size *= sizes[a]
                checked.append(ax if dim % size == 0 else None)
            padded = tuple(checked)
        while padded and padded[-1] is None:
            padded = padded[:-1]
        return padded
    return ()


def make_param_specs(params, rules: Sequence[Rule],
                     mesh: Optional[DeviceMesh] = None) -> Dict[str, Spec]:
    """name -> spec for every parameter (a module's state_dict or a
    mapping of name -> tensor)."""
    return {name: spec_for(name, tuple(t.shape), rules, mesh)
            for name, t in _named(params).items()}


def shard_params(params, mesh: DeviceMesh, rules: Sequence[Rule]):
    """Lay every parameter out over `mesh` by the rule table. Returns
    (name -> DTensor, name -> spec)."""
    specs = make_param_specs(params, rules, mesh)
    out = {}
    for name, t in _named(params).items():
        out[name] = distribute_tensor(t.detach(), mesh, spec_to_placements(specs[name], mesh))
    return out, specs


def fsdp_rules(axis: str = "fsdp") -> Sequence[Rule]:
    """The catch-all rule of `fsdp.fully_shard`: shard dim 0 of everything
    (`spec_for` leaves indivisible leaves replicated)."""
    return [(r".*", (axis,))]


def replicated_specs(params) -> Dict[str, Spec]:
    return {name: () for name in _named(params)}


def data_spec(mesh, batch_axes: Sequence[str] = ("dp",)) -> Spec:
    """Spec for a batch: its leading dim over the data axes the mesh has."""
    names = getattr(mesh, "axis_names", tuple(batch_axes))
    axes = tuple(a for a in batch_axes if a in names)
    if len(axes) == 1:
        return (axes[0],)
    return (axes,)
