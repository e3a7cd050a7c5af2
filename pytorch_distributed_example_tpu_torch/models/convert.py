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

`resnet_from_flax` / `resnet_to_flax` carry the ResNet's variables
(`params` and `batch_stats`): conv kernels HWIO <-> OIHW, the Dense kernel
transposed, BatchNorm `scale` <-> `weight` and `mean`/`var` <->
`running_mean`/`running_var`, `{Block}_{i}/Conv_{j}` <->
`blocks.{i}.conv{j}`. `bert_from_flax` / `bert_to_flax` carry BERT's:
Dense kernels transposed, `embedding` and LayerNorm `scale` <-> `weight`,
`layer_{i}` <-> `layers.{i}`. Their dicts come out in the flax tree's
flattened order (sorted key paths), the order in which the reference's
PowerSGD hook draws its initial Q; `*_hook_views(model)` give the port's
params in that order with the permutation of each to the reference's
layout, so that per-leaf comm hooks reduce the reference's matrices and
blocks.

`cache_from_flax` and `cache_to_flax` carry a KV cache tree (the
reference's "cache" collection, numpy leaves) to the port's layout and
back: `layers_{i}/attn/{k, v, index}` for the dense cache, `{k, v}` and
the int8 pool's `{k_scale, v_scale}` for the paged pool, whose port
tensors hold one more block, the sink (`serve/cache.py`), added as zeros
and dropped on the way back.
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


def _tensor(arr, device=None) -> torch.Tensor:
    arr = np.asarray(arr)
    if arr.dtype.name == "bfloat16":  # numpy has no bf16 of its own
        return torch.tensor(arr.astype(np.float32), device=device).to(torch.bfloat16)
    return torch.tensor(arr, device=device)


def _numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def cache_from_flax(tree, device=None) -> dict:
    """A reference KV cache tree (numpy leaves; the "cache" wrapper is
    optional) -> the port's nested dict of tensors on `device`."""
    if "cache" in tree:
        tree = tree["cache"]
    out = {}
    for layer, node in tree.items():
        attn = node["attn"]
        paged = "index" not in attn
        leaves = {}
        for name, arr in attn.items():
            t = _tensor(arr, device)
            if paged:  # append the sink block
                t = torch.cat([t, t.new_zeros((1,) + tuple(t.shape[1:]))])
            leaves[name] = t
        out[layer] = {"attn": leaves}
    return out


def cache_to_flax(tree) -> dict:
    """The port's KV cache -> the reference's tree of numpy arrays, the
    paged pool's sink block dropped (bf16 leaves come back as float32)."""
    out = {}
    for layer, node in tree.items():
        attn = node["attn"]
        paged = "index" not in attn
        out[layer] = {"attn": {name: _numpy(t[:-1] if paged else t)
                               for name, t in attn.items()}}
    return out


# ---------------------------------------------------------------------------
# ResNet and BERT: the flax trees <-> the port's dicts, in the flax tree's
# flattened order (jax flattens a dict's keys sorted, level by level, so the
# order is that of the sorted key paths)
# ---------------------------------------------------------------------------

_CONV_TO_FLAX = (2, 3, 1, 0)  # OIHW -> HWIO
_CONV_FROM_FLAX = (3, 2, 0, 1)  # HWIO -> OIHW
_DENSE = (1, 0)


def _flatten_sorted(tree):
    return sorted(_flatten(tree), key=lambda kv: kv[0])


def _permute(arr: np.ndarray, perm) -> np.ndarray:
    return arr if perm is None else np.ascontiguousarray(arr.transpose(perm))


def _resnet_block_kind(tree) -> str:
    kinds = {k.rsplit("_", 1)[0] for k in tree if k.startswith(("BasicBlock_", "Bottleneck_"))}
    if len(kinds) != 1:
        raise KeyError(f"expected BasicBlock_* or Bottleneck_* blocks, found {sorted(kinds)}")
    return kinds.pop()


def _resnet_port_name(path) -> tuple:
    """A flax ResNet path -> (port name, permutation to the port's layout
    or None). Works for `params` (scale/bias/kernel) and `batch_stats`
    (mean/var) leaves."""
    leaf = {"scale": "weight", "bias": "bias", "kernel": "weight", "mean": "running_mean",
            "var": "running_var"}
    *mods, name = path
    if name not in leaf:
        raise KeyError(f"no port counterpart for flax leaf {'/'.join(path)}")
    if mods == ["Dense_0"]:
        return f"fc.{name if name == 'bias' else 'weight'}", (_DENSE if name == "kernel" else None)
    perm = _CONV_FROM_FLAX if name == "kernel" else None
    if mods in (["conv_init"], ["bn_init"]):
        return f"{mods[0]}.{leaf[name]}", perm
    if len(mods) == 2 and re.match(r"^(BasicBlock|Bottleneck)_\d+$", mods[0]):
        i = int(mods[0].rsplit("_", 1)[1])
        sub = mods[1]
        m = re.match(r"^(Conv|BatchNorm)_(\d+)$", sub)
        if m:
            sub = ("conv" if m.group(1) == "Conv" else "bn") + m.group(2)
        elif sub not in ("conv_proj", "norm_proj"):
            raise KeyError(f"no port counterpart for flax leaf {'/'.join(path)}")
        return f"blocks.{i}.{sub}.{leaf[name]}", perm
    raise KeyError(f"no port counterpart for flax leaf {'/'.join(path)}")


def resnet_from_flax(variables, device=None):
    """The reference ResNet's variables ({"params", "batch_stats"}, numpy
    leaves) -> (params, stats): the port's `ResNet` state-dict entries,
    parameters and running buffers, each dict in the flax tree's
    flattened order. Conv kernels HWIO -> OIHW, the Dense kernel
    transposed, BatchNorm scale -> weight, mean/var -> running_mean/var."""
    out = []
    for col in ("params", "batch_stats"):
        d = {}
        for path, leaf in _flatten_sorted(variables[col]):
            name, perm = _resnet_port_name(path)
            d[name] = _tensor(_permute(np.asarray(leaf), perm), device)
        out.append(d)
    return tuple(out)


def _resnet_flax_path(name: str, block: str) -> tuple:
    """Inverse of `_resnet_port_name`: (flax path, permutation to flax)."""
    parts = name.split(".")
    leaf = {"weight": "scale", "bias": "bias", "running_mean": "mean", "running_var": "var"}
    if parts[0] == "fc":
        return ("Dense_0", "kernel" if parts[1] == "weight" else "bias"), \
            (_DENSE if parts[1] == "weight" else None)
    if parts[0] in ("conv_init", "bn_init"):
        mod, rest = [parts[0]], parts[1]
    elif parts[0] == "blocks":
        sub = parts[2]
        m = re.match(r"^(conv|bn)(\d+)$", sub)
        if m:
            sub = ("Conv_" if m.group(1) == "conv" else "BatchNorm_") + m.group(2)
        mod, rest = [f"{block}_{parts[1]}", sub], parts[3]
    else:
        raise KeyError(f"no flax counterpart for {name}")
    conv = mod[-1].startswith(("conv", "Conv"))
    return tuple(mod) + ("kernel" if conv else leaf[rest],), (_CONV_TO_FLAX if conv else None)


def resnet_to_flax(params, stats, block: str = "BasicBlock") -> dict:
    """Inverse of `resnet_from_flax`: {"params", "batch_stats"} of numpy
    arrays. `block` names the blocks' flax class."""
    out: dict = {"params": {}, "batch_stats": {}}
    for col, tree in (("params", params), ("batch_stats", stats)):
        for name, t in tree.items():
            path, perm = _resnet_flax_path(name, block)
            node = out[col]
            for m in path[:-1]:
                node = node.setdefault(m, {})
            node[path[-1]] = _permute(_numpy(t), perm)
    return out


def resnet_hook_views(model) -> dict:
    """{param name: permutation to the reference's layout}, in the order
    the reference's flax tree flattens them (`parallel/ddp.py`'s
    `hook_views`)."""
    block = "Bottleneck" if model.block_cls.__name__ == "Bottleneck" else "BasicBlock"
    paths = {n: _resnet_flax_path(n, block) for n, _ in model.named_parameters()}
    return {n: paths[n][1] for n in sorted(paths, key=lambda n: paths[n][0])}


def _bert_port_name(path) -> tuple:
    """A flax BertForSequenceClassification path -> (port name,
    permutation to the port's layout or None)."""
    *mods, name = path
    mods = [re.sub(r"^layer_(\d+)$", r"layers.\1", m) for m in mods]
    if name == "pos_emb":
        return ".".join(mods + ["pos_emb"]), None
    if name == "embedding":
        return ".".join(mods + ["weight"]), None
    if name == "kernel":
        return ".".join(mods + ["weight"]), _DENSE
    if name == "scale":
        return ".".join(mods + ["weight"]), None
    if name == "bias":
        return ".".join(mods + ["bias"]), None
    raise KeyError(f"no port counterpart for flax leaf {'/'.join(path)}")


def bert_from_flax(params, device=None) -> dict:
    """The reference BERT's params (numpy leaves; the "params" wrapper is
    optional) -> the port's state dict, in the flax tree's flattened order:
    Dense kernels transposed to (out, in), `embedding` and LayerNorm
    `scale` -> `weight`, `layer_{i}` -> `layers.{i}`."""
    if "params" in params:
        params = params["params"]
    out = {}
    for path, leaf in _flatten_sorted(params):
        name, perm = _bert_port_name(path)
        out[name] = _tensor(_permute(np.asarray(leaf), perm), device)
    return out


def _bert_flax_path(name: str) -> tuple:
    parts = re.sub(r"layers\.(\d+)", r"layer_\1", name).split(".")
    *mods, leaf = parts
    if leaf == "pos_emb":
        return tuple(mods + ["pos_emb"]), None
    if leaf == "bias":
        return tuple(mods + ["bias"]), None
    if mods[-1] in ("tok_emb", "type_emb"):
        return tuple(mods + ["embedding"]), None
    if mods[-1].startswith("ln_"):
        return tuple(mods + ["scale"]), None
    return tuple(mods + ["kernel"]), _DENSE


def bert_to_flax(state) -> dict:
    """Inverse of `bert_from_flax`: the reference's param tree of numpy
    arrays (without the "params" wrapper)."""
    out: dict = {}
    for name, t in state.items():
        path, perm = _bert_flax_path(name)
        node = out
        for m in path[:-1]:
            node = node.setdefault(m, {})
        node[path[-1]] = _permute(_numpy(t), perm)
    return out


def bert_hook_views(model) -> dict:
    """{param name: permutation to the reference's layout}, in the
    reference's flattened order."""
    paths = {n: _bert_flax_path(n) for n, _ in model.named_parameters()}
    return {n: paths[n][1] for n in sorted(paths, key=lambda n: paths[n][0])}
