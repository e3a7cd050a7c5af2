"""Carry the reference's flax params across to the port's state dicts.

`from_flax` (TransformerLM) and `convnet_from_flax` (ConvNet) take the TransformerLM param tree as numpy arrays (the
reference's `model.init(...)` with every leaf passed through
`np.asarray`; the top-level "params" collection is optional) and returns a
`state_dict` for `models.transformer.TransformerLM`:

    tok_embed/embedding            -> tok_embed.weight, as is
    layers_{i}/.../*_proj/kernel   -> layers.{i}.....*_proj.weight, (in, out) -> (out, in)
    lm_head/kernel                 -> lm_head.weight, transposed
    */attn_norm|mlp_norm/scale     -> ....weight
    final_norm/scale               -> final_norm.weight
    */mlp/router|experts_up|experts_down -> ....mlp.router|experts_up|experts_down,
                                      as is (the MoE keeps the reference's layout)

`to_flax` is its inverse: a state dict (tensors or `DTensor`s, gathered
with `full_tensor`) back to the flax-shaped tree of numpy arrays.

`convnet_from_flax` maps the ConvNet's tree onto `models.convnet.ConvNet`:

    Conv_0, Conv_1 /kernel -> conv1, conv2 .weight, HWIO -> OIHW
    Dense_0 /kernel        -> fc1.weight, its 320 rows permuted from the
                              reference's (h, w, c) flatten order to the
                              port's (c, h, w), then transposed
    Dense_1 /kernel        -> fc2.weight, transposed
    */bias                 -> ....bias, as is

The tests pass JAX gradients through the same functions, to compare them
with the port's `.grad`s.
"""

from __future__ import annotations

import re

import numpy as np
import torch


def _flatten(tree, prefix=()):
    for key, val in tree.items():
        if hasattr(val, "items"):
            yield from _flatten(val, prefix + (str(key),))
        else:
            yield prefix + (str(key),), val


def from_flax(params) -> dict:
    if "params" in params:
        params = params["params"]
    out = {}
    for path, leaf in _flatten(params):
        arr = np.asarray(leaf)
        names = [re.sub(r"^layers_(\d+)$", r"layers.\1", p) for p in path]
        *mods, leaf_name = names
        if leaf_name == "embedding" and mods == ["tok_embed"]:
            pass
        elif leaf_name == "kernel" and (mods[-1].endswith("_proj") or mods == ["lm_head"]):
            if arr.ndim != 2:
                raise ValueError(f"{'/'.join(path)}: expected a 2-D kernel, got {arr.shape}")
            arr = arr.T
        elif leaf_name == "scale" and mods[-1].endswith("_norm"):
            pass
        elif leaf_name in _MOE and mods and mods[-1] == "mlp":
            out[".".join(mods + [leaf_name])] = torch.tensor(arr)
            continue
        else:
            raise KeyError(f"no port counterpart for flax param {'/'.join(path)}")
        out[".".join(mods) + ".weight"] = torch.tensor(arr)
    return out


_MOE = ("router", "experts_up", "experts_down")


def to_flax(state) -> dict:
    """A TransformerLM state dict (tensors or DTensors) -> the reference's
    param tree as numpy arrays (without the "params" wrapper)."""
    out: dict = {}
    for name, value in state.items():
        t = value.full_tensor() if hasattr(value, "full_tensor") else value
        arr = t.detach().float().cpu().numpy() if t.dtype == torch.bfloat16 else \
            t.detach().cpu().numpy()
        parts = name.split(".")
        if parts[0] == "layers":
            parts = [f"layers_{parts[1]}"] + parts[2:]
        *mods, leaf = parts
        if leaf in _MOE:
            mods, flax_leaf = mods + [leaf], None
        elif mods == ["tok_embed"]:
            flax_leaf = "embedding"
        elif mods[-1].endswith("_norm"):
            flax_leaf = "scale"
        else:
            flax_leaf, arr = "kernel", arr.T
        node = out
        for m in mods[:-1] if flax_leaf is None else mods:
            node = node.setdefault(m, {})
        node[mods[-1] if flax_leaf is None else flax_leaf] = np.ascontiguousarray(arr)
    return out


_CONVNET = {"Conv_0": "conv1", "Conv_1": "conv2", "Dense_0": "fc1", "Dense_1": "fc2"}
_POOLED = (4, 4, 20)  # (h, w, c) of the activations Dense_0 reads


def convnet_from_flax(params) -> dict:
    if "params" in params:
        params = params["params"]
    out = {}
    for path, leaf in _flatten(params):
        arr = np.asarray(leaf)
        if len(path) != 2 or path[0] not in _CONVNET or path[1] not in ("kernel", "bias"):
            raise KeyError(f"no port counterpart for flax param {'/'.join(path)}")
        layer, kind = path
        if kind == "kernel" and layer.startswith("Conv"):
            arr = arr.transpose(3, 2, 0, 1)  # HWIO -> OIHW
        elif kind == "kernel" and layer == "Dense_0":
            h, w, c = _POOLED
            arr = arr.reshape(h, w, c, -1).transpose(2, 0, 1, 3).reshape(h * w * c, -1).T
        elif kind == "kernel":
            arr = arr.T
        out[f"{_CONVNET[layer]}.{'weight' if kind == 'kernel' else 'bias'}"] = torch.tensor(
            np.ascontiguousarray(arr))
    return out
