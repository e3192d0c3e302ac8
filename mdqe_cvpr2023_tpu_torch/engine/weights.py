"""Load a JAX-package parameter tree into the port's model, and give the
port's gradients back under the same names.

The JAX tree mirrors the Detectron2 module names and its leaves already have
torch shapes (OIHW convolutions, (out, in) linears), so loading is a renaming:
join the path with ``.``, map ``input_proj.{i}.conv|gn`` to ``.0|.1``, and add
the Detectron2 prefixes. Any missing or unexpected key, or any shape
mismatch, raises.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch
from torch import nn

# tree roots -> Detectron2 module-path prefixes
PREFIX_MAP = {
    "backbone": "detr.backbone.0.backbone.",
    "input_proj": "detr.input_proj.",
    "transformer_enc": "detr.transformer_enc.",
    "transformer_dec": "detr.transformer_dec.",
}


def _flatten(node, path=()):
    if isinstance(node, dict):
        for k, v in node.items():
            yield from _flatten(v, path + (str(k),))
    elif isinstance(node, (list, tuple)):
        for i, v in enumerate(node):
            yield from _flatten(v, path + (str(i),))
    else:
        yield path, node


def jax_tree_to_state_dict(tree) -> Dict[str, np.ndarray]:
    """Nested dict/list of arrays (the JAX parameter tree) -> flat dict under
    the Detectron2 names."""
    out = {}
    for path, leaf in _flatten(tree):
        root, rest = path[0], list(path[1:])
        if root not in PREFIX_MAP:
            raise KeyError(f"unknown parameter root {'.'.join(path)}")
        if root == "input_proj":  # {i}.{conv|gn}.{leaf} -> {i}.{0|1}.{leaf}
            rest[1] = {"conv": "0", "gn": "1"}[rest[1]]
        out[PREFIX_MAP[root] + ".".join(rest)] = np.asarray(leaf)
    return out


@torch.no_grad()
def load_jax_params(model: nn.Module, tree) -> None:
    """Copy the JAX parameter tree (arrays, e.g. ``jax.tree.map(np.asarray,
    detr_init(...))``) into ``model``'s parameters and buffers."""
    src = jax_tree_to_state_dict(tree)
    dst = model.state_dict()
    missing = sorted(set(dst) - set(src))
    unexpected = sorted(set(src) - set(dst))
    if missing or unexpected:
        raise KeyError(f"missing {missing[:10]} ({len(missing)}), "
                       f"unexpected {unexpected[:10]} ({len(unexpected)})")
    for name, arr in src.items():
        if tuple(arr.shape) != tuple(dst[name].shape):
            raise ValueError(f"{name}: shape {arr.shape} != {tuple(dst[name].shape)}")
        dst[name].copy_(torch.from_numpy(np.array(arr)))


def grad_state_dict(model: nn.Module) -> Dict[str, np.ndarray]:
    """The gradients of ``model``'s parameters as a flat dict under the
    Detectron2 names (the ``state_dict`` keys), zeros for parameters without a
    gradient and for buffers: the JAX package's ``convert_torch_state_dict``
    turns it into a tree leaf-aligned with its parameter tree."""
    out = {}
    for name, p in model.named_parameters():
        g = p.grad
        out[name] = (np.zeros(p.shape, np.float32) if g is None
                     else np.array(g.detach().float().cpu()))  # a copy: steps clip in place
    for name, b in model.named_buffers():
        out[name] = np.zeros(b.shape, np.float32)
    return out
