"""Carry the reference's flax params across to the port's state dicts.

`from_flax` takes the TransformerLM param tree as numpy arrays (the
reference's `model.init(...)` with every leaf passed through
`np.asarray`; the top-level "params" collection is optional) and returns a
`state_dict` for `models.transformer.TransformerLM`:

    tok_embed/embedding            -> tok_embed.weight, as is
    layers_{i}/.../*_proj/kernel   -> layers.{i}.....*_proj.weight, (in, out) -> (out, in)
    lm_head/kernel                 -> lm_head.weight, transposed
    */attn_norm|mlp_norm/scale     -> ....weight
    final_norm/scale               -> final_norm.weight

The tests pass JAX gradients through the same function, to compare them
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
        else:
            raise KeyError(f"no port counterpart for flax param {'/'.join(path)}")
        out[".".join(mods) + ".weight"] = torch.tensor(arr)
    return out
