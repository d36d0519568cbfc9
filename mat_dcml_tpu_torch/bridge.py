"""Move MAT weights between a flax parameter tree and a torch ``state_dict``.

The flax tree is taken as nested dicts of numpy arrays (optionally under a
top-level ``"params"`` key), with the names the JAX package's modules give
them: ``encoder/blocks_0/attn/key_p/kernel``, ``decoder/head/LayerNorm_0/scale``,
``decoder/log_std`` and so on.  The port's modules carry the same names, so
the mapping is mechanical:

- ``blocks_<i>`` is the ``ModuleList`` entry ``blocks.<i>``;
- a Dense ``kernel`` ``(in, out)`` is the transpose of ``Linear.weight``;
- a LayerNorm ``scale`` is ``LayerNorm.weight``; ``bias`` stays ``bias``;
- a layer stacked on a leading agent axis (MAT-Dec's per-agent actor,
  JAX ``nn.vmap``: a kernel ``(n_agent, in, out)``, a scale ``(n_agent,
  d)``) keeps its names and layout: ``kernel`` and ``scale`` are names
  only these layers' parameters carry in the port.

Both directions copy values exactly.

The actor-critic family's weights (``models/actor_critic.py``) keep flax's
own layout: :func:`ac_params_from_jax` flattens a ``{"actor": {"params":
...}, "critic": {"params": ...}}`` tree into ``{"actor/base/.../kernel":
array}`` (a Dense ``kernel`` stays ``(in, out)``), which
``ActorCriticPolicy.load_tree`` lays into its flat tensors; IPPO's and
HAPPO's trees carry a leading agent axis on every leaf, the policy's stack
axis.  :func:`ac_params_to_jax` is the inverse.
"""

from __future__ import annotations

import re
from typing import Dict

import numpy as np
import torch

_BLOCK = re.compile(r"^blocks_(\d+)$")


def _flatten(tree, prefix=()):
    for key, val in tree.items():
        path = prefix + (str(key),)
        if isinstance(val, dict) or hasattr(val, "items"):
            yield from _flatten(val, path)
        else:
            yield path, val


def params_from_jax(tree) -> Dict[str, torch.Tensor]:
    """flax parameter tree (numpy leaves) -> ``state_dict`` of CPU tensors."""
    if "params" in tree:
        tree = tree["params"]
    out = {}
    for path, leaf in _flatten(tree):
        arr = np.asarray(leaf)
        mods = []
        for name in path[:-1]:
            m = _BLOCK.match(name)
            mods.extend(("blocks", m.group(1)) if m else (name,))
        last = path[-1]
        if last == "kernel" and arr.ndim == 3:     # stacked on the agent axis
            name = "kernel"
        elif last == "kernel":
            if arr.ndim != 2:
                raise ValueError(f"{'/'.join(path)}: kernel of rank {arr.ndim}")
            name, arr = "weight", arr.T
        elif last == "scale":
            name = "scale" if arr.ndim == 2 else "weight"
        elif last in ("bias", "log_std"):
            name = last
        else:
            raise ValueError(f"unknown flax parameter {'/'.join(path)}")
        out[".".join(mods + [name])] = torch.from_numpy(np.array(arr, order="C"))
    return out


def params_to_jax(state_dict) -> dict:
    """``state_dict`` -> ``{"params": nested dicts of numpy arrays}``, the
    inverse of :func:`params_from_jax`."""
    tree: dict = {}
    for key, val in state_dict.items():
        arr = val.detach().cpu().numpy()
        parts = key.split(".")
        mods, last = parts[:-1], parts[-1]
        names = []
        j = 0
        while j < len(mods):
            if mods[j] == "blocks" and j + 1 < len(mods) and mods[j + 1].isdigit():
                names.append(f"blocks_{mods[j + 1]}")
                j += 2
            else:
                names.append(mods[j])
                j += 1
        if last == "weight":
            last, arr = ("kernel", arr.T) if arr.ndim == 2 else ("scale", arr)
        elif last not in ("bias", "log_std", "kernel", "scale"):
            raise ValueError(f"unknown state_dict entry {key}")
        node = tree
        for name in names:
            node = node.setdefault(name, {})
        node[last] = np.ascontiguousarray(arr)
    return {"params": tree}


def ac_params_from_jax(tree) -> Dict[str, torch.Tensor]:
    """A JAX actor-critic parameter tree (numpy leaves) -> ``{"actor/...",
    "critic/...": tensor}`` for ``ActorCriticPolicy.load_tree``."""
    out = {}
    for group in ("actor", "critic"):
        sub = tree[group]
        if "params" in sub:
            sub = sub["params"]
        for path, leaf in _flatten(sub, (group,)):
            out["/".join(path)] = torch.from_numpy(np.array(leaf, dtype=np.float32))
    return out


def ac_params_to_jax(leaves, stacked: bool = True) -> dict:
    """``{"actor/...": (S, ...) tensor}`` (``ActorCriticPolicy.tree()``) ->
    the JAX tree ``{"actor": {"params": ...}, "critic": {"params": ...}}``
    of numpy arrays; without ``stacked`` the stack axis (of size 1) is
    dropped, as a shared policy's tree has none."""
    tree: dict = {}
    for key, val in leaves.items():
        arr = val.detach().cpu().numpy()
        if not stacked:
            arr = arr[0]
        group, *names = key.split("/")
        node = tree.setdefault(group, {}).setdefault("params", {})
        for name in names[:-1]:
            node = node.setdefault(name, {})
        node[names[-1]] = np.ascontiguousarray(arr)
    return tree
