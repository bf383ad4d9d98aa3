"""Distributed checkpoint save/load with cross-mesh resharding — port of
`paddle_tpu/distributed/checkpoint.py`.

The on-disk layout is the reference's: `<path>/data.npz` holds every leaf
as one full logical array under its path name (`params/blocks/qkv_w`,
`opt/m/wte`, `opt/step`); a leaf whose dtype numpy has no name for
(bfloat16, the float8 types) is stored as a bit view of the same width
(`uint16` for bfloat16) with its dtype name under `dtypes` in
`<path>/dist_attr.json`, which also holds each leaf's layout in the
reference's list form (one entry a dimension: the mesh axis it splits
over, or null) and the saving mesh's axes and shape.  A trainer's shards
are gathered into the full arrays before `save_state_dict`
(`HybridParallelTrainer.gathered_state`) and cut for the loading mesh
after `load_state_dict` (`HybridParallelTrainer.load_state`): that pair
is the reference's converter.

The reference also pickles its pytree's structure (`treedef.pkl`, a JAX
`PyTreeDef`), which the port cannot write: the port rebuilds the tree from
the leaf names, nested dicts keyed by the parts of each name, and ignores
a `treedef.pkl` it finds.  So a checkpoint the JAX package wrote loads
into the port; one the port wrote does not load into the JAX package,
whose loader needs that file.
"""
from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional

import numpy as np
import torch

# torch dtypes numpy cannot hold, stored as same-width integer bits
_BIT_VIEWS = {torch.bfloat16: (torch.int16, np.uint16)}


def _flatten(tree, prefix=""):
    out = {}
    for k in sorted(tree):
        v = tree[k]
        name = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(_flatten(v, name + "/"))
        else:
            out[name] = v
    return out


def _to_numpy(leaf):
    """(array, the dtype name to record or None)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype in _BIT_VIEWS:
            int_dtype, np_dtype = _BIT_VIEWS[t.dtype]
            name = str(t.dtype).replace("torch.", "")
            return t.contiguous().view(int_dtype).numpy().view(np_dtype), \
                name
        return t.numpy(), None
    return np.asarray(leaf), None


def _spec_meta(spec):
    if spec is None:
        return None
    return [list(e) if isinstance(e, tuple) else e for e in spec]


def save_state_dict(state: Dict[str, Any], path: str,
                    specs: Optional[Dict[str, Any]] = None,
                    mesh: Optional[Dict[str, Any]] = None) -> None:
    """Save `state`, nested dicts of full tensors (or numbers), to `path`
    in the reference's layout.  `specs`: the same tree's layouts (a tuple a
    leaf: the mesh axis each dimension splits over, or None), written
    with the saving `mesh` ({"axes": [...], "shape": [...]}) to
    `dist_attr.json`; leaves it does not name get null."""
    os.makedirs(path, exist_ok=True)
    flat_specs = _flatten(specs) if specs is not None else {}
    arrays, meta = {}, {"leaves": {}, "mesh": mesh, "dtypes": {}}
    for name, leaf in _flatten(state).items():
        arrays[name], dtype = _to_numpy(leaf)
        if dtype is not None:
            meta["dtypes"][name] = dtype
        meta["leaves"][name] = _spec_meta(flat_specs.get(name))
    np.savez(os.path.join(path, "data.npz"), **arrays)
    with open(os.path.join(path, "dist_attr.json"), "w") as f:
        json.dump(meta, f, indent=1)


def _restore(a: np.ndarray, dtype: Optional[str]) -> torch.Tensor:
    if dtype is None:
        return torch.from_numpy(np.array(a))
    want = getattr(torch, dtype, None)
    if not isinstance(want, torch.dtype) or \
            want.itemsize != a.dtype.itemsize:
        raise TypeError(f"checkpoint dtype {dtype!r} has no torch dtype of "
                        f"{a.dtype.itemsize} bytes")
    bits = np.array(a).view(np.dtype(f"i{a.dtype.itemsize}"))
    return torch.from_numpy(bits).view(want)


def load_state_dict(path: str) -> Dict[str, Any]:
    """The tree `path` holds, nested dicts of full CPU tensors keyed by the
    parts of each leaf's name, each leaf in its saved dtype (a 0-d tensor
    for a scalar such as `opt/step`).  Resharding onto a mesh is the
    trainer's (`HybridParallelTrainer.load_state`).  A checkpoint without
    `dist_attr.json` raises FileNotFoundError: without its dtypes a
    bfloat16 leaf's bits would load as integers."""
    saved_dtypes = saved_dist_attr(path).get("dtypes", {})
    tree: Dict[str, Any] = {}
    with np.load(os.path.join(path, "data.npz")) as data:
        for name in data.files:
            *parents, leaf = name.split("/")
            node = tree
            for p in parents:
                node = node.setdefault(p, {})
            node[leaf] = _restore(data[name], saved_dtypes.get(name))
    return tree


def saved_dist_attr(path: str) -> Dict[str, Any]:
    with open(os.path.join(path, "dist_attr.json")) as f:
        return json.load(f)
