"""Training-state checkpoint and resume.

Counterpart of `raptor_tpu/utils/state_checkpoint.py`. The port's trainer
states are mutable dataclasses holding tensors, `torch.optim.Adam`s, a
`torch.Generator` and plain ints, nested in dicts, lists and tuples. A
checkpoint is one `.npz` of their leaves (tensors saved from the host, each
optimizer's per-parameter state, each generator's `get_state()`, the CUDA
generator's too) beside a JSON descriptor of the leaves' paths. Writes are
atomic (a temporary file, then `os.replace`). `restore_pytree` writes the
values into a template of the same structure, in place and on the template's
devices, so the optimizers keep their parameters; shapes are checked and a
mismatch raises `ValueError`.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, List, Optional, Tuple

import numpy as np
import torch

LEAF_TYPES = (torch.Tensor, torch.optim.Optimizer, torch.Generator, bool, int, float)


def leaves_with_path(tree: Any) -> List[Tuple[str, Any, Any, Any]]:
    """(path, parent, key, leaf) for every leaf of a state: tensors,
    optimizers, generators and Python numbers, found through dataclasses,
    dicts, lists and tuples; anything else (None, strings, configs) is
    static. Paths read like JAX's key strings: `.learner.actor['gru_1'][...]`."""
    out = []

    def walk(node, path, parent, key):
        if isinstance(node, LEAF_TYPES):
            out.append((path, parent, key, node))
        elif dataclasses.is_dataclass(node) and not isinstance(node, type):
            for f in dataclasses.fields(node):
                walk(getattr(node, f.name), f"{path}.{f.name}", node, f.name)
        elif isinstance(node, dict):
            for k, v in node.items():
                walk(v, f"{path}[{k!r}]", node, k)
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                walk(v, f"{path}[{i}]", node, i)

    walk(tree, "", None, None)
    return out


def optimizer_params(opt: torch.optim.Optimizer) -> list:
    return [p for group in opt.param_groups for p in group["params"]]


def load_optimizer_state(opt: torch.optim.Optimizer, state: dict) -> None:
    """Load per-parameter state {index: {name: tensor}} into `opt` (its own
    hyper-parameters stay); each moment must have its parameter's shape."""
    params = optimizer_params(opt)
    for i, st in state.items():
        for name, v in st.items():
            if name != "step" and tuple(v.shape) != tuple(params[i].shape):
                raise ValueError(f"optimizer state {i}.{name}: shape {tuple(v.shape)} != "
                                 f"parameter {tuple(params[i].shape)}")
    opt.load_state_dict({"state": state, "param_groups": opt.state_dict()["param_groups"]})


def write_leaf(parent, key, leaf, value) -> None:
    """Write a saved value into the leaf at parent[key] (in place where the
    leaf is mutable)."""
    if isinstance(leaf, torch.Tensor):
        value = torch.as_tensor(value)
        if tuple(value.shape) != tuple(leaf.shape):
            raise ValueError(f"shape {tuple(value.shape)} != template {tuple(leaf.shape)}")
        with torch.no_grad():
            leaf.copy_(value)
    elif isinstance(leaf, torch.optim.Optimizer):
        load_optimizer_state(leaf, value)
    elif isinstance(leaf, torch.Generator):
        leaf.set_state(value)
    elif isinstance(parent, tuple):
        if value != leaf:
            raise ValueError(f"cannot restore {value!r} into a tuple holding {leaf!r}")
    else:
        value = type(leaf)(value)
        if dataclasses.is_dataclass(parent):
            setattr(parent, key, value)
        else:
            parent[key] = value


def save_pytree(path: str, tree: Any) -> None:
    """Snapshot a state to <path>.npz + <path>.treedef.json, each written to
    a temporary file first and renamed."""
    leaves = leaves_with_path(tree)
    arrays = {}
    for i, (_, _, _, leaf) in enumerate(leaves):
        if isinstance(leaf, torch.Tensor):
            arrays[f"leaf_{i}"] = leaf.detach().cpu().numpy()
        elif isinstance(leaf, torch.optim.Optimizer):
            for p, st in leaf.state_dict()["state"].items():
                for name, v in st.items():
                    arrays[f"leaf_{i}/{p}/{name}"] = torch.as_tensor(v).detach().cpu().numpy()
        elif isinstance(leaf, torch.Generator):
            arrays[f"leaf_{i}"] = leaf.get_state().numpy()
        else:
            arrays[f"leaf_{i}"] = np.asarray(leaf)
    tmp = path + ".tmp.npz"
    np.savez(tmp, **arrays)
    os.replace(tmp, path + ".npz")
    with open(path + ".treedef.json.tmp", "w") as f:
        json.dump({"paths": [p for p, _, _, _ in leaves]}, f)
    os.replace(path + ".treedef.json.tmp", path + ".treedef.json")


def restore_pytree(path: str, template: Any) -> Any:
    """Restore into `template`, a state of the saved structure (for example a
    freshly initialised one), in place and on its devices; returns it. Raises
    `ValueError` where the structure or a shape differs."""
    leaves = leaves_with_path(template)
    with open(path + ".treedef.json") as f:
        desc = json.load(f)
    paths = [p for p, _, _, _ in leaves]
    if paths != desc["paths"]:
        raise ValueError(f"checkpoint {path} holds another structure than the template: "
                         f"{len(desc['paths'])} leaves saved, {len(paths)} in the template")
    with np.load(path + ".npz") as data:
        opt_state = {}
        for name in data.files:
            if name.count("/") == 2:
                i, p, k = name.split("/")
                opt_state.setdefault(i, {}).setdefault(int(p), {})[k] = torch.from_numpy(data[name])
        for i, (p, parent, key, leaf) in enumerate(leaves):
            if isinstance(leaf, torch.optim.Optimizer):
                value = opt_state.get(f"leaf_{i}", {})
            elif isinstance(leaf, (torch.Tensor, torch.Generator)):
                value = torch.from_numpy(data[f"leaf_{i}"])
            else:
                value = data[f"leaf_{i}"].item()
            try:
                write_leaf(parent, key, leaf, value)
            except ValueError as e:
                raise ValueError(f"leaf {i} ({p}): {e}") from None
    return template


def latest_checkpoint(directory: str, prefix: str = "state_") -> Optional[Tuple[str, int]]:
    """The newest state checkpoint `<prefix><step>` in a directory, as (path
    without suffix, step)."""
    if not os.path.isdir(directory):
        return None
    best = None
    for name in os.listdir(directory):
        if name.startswith(prefix) and name.endswith(".npz") and not name.endswith(".tmp.npz"):
            try:
                step = int(name[len(prefix):].split(".")[0])
            except ValueError:
                continue
            if best is None or step > best[1]:
                best = (os.path.join(directory, name[: -len(".npz")]), step)
    return best
