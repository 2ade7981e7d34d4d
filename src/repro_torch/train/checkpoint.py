"""Step-atomic checkpoints (``repro/train/checkpoint.py``), in the
reference's file layout, so that each package reads the other's.

A checkpoint is ``step_XXXXXXXX.npz`` in ``ckpt_dir``: one array per leaf
of the state, keyed by its path joined with ``/`` (``params/blocks/attn/wq``,
``opt/m/...``, ``opt/step``), each stack of layers (``blocks``; whisper's
``enc`` and ``dec``) on a leading layer axis as JAX stacks them, or a list
of layers (``params/blocks/0/rec/w_x``) where the reference keeps one
(recurrentgemma), and a JSON ``__meta__`` holding
the step and the caller's extra metadata. It is written to ``.npz.tmp``
and then renamed, so a crash mid-write never corrupts the latest
checkpoint.
:func:`reshard_checkpoint` places a host-loaded state's leaves on a mesh
(``launch/mesh.py``) under the caller's sharding rules.
"""
from __future__ import annotations

import json
import os
import re

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models import common as C

_SEP = "/"


def _flatten(tree, prefix=""):
    if isinstance(tree, C.ParamTree):
        tree = C.stack_tree(tree.tree(), tree.stacked_blocks)
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = ((str(i), v) for i, v in enumerate(tree))
    else:
        return {prefix.rstrip(_SEP): tree}
    out = {}
    for k, v in items:
        out.update(_flatten(v, f"{prefix}{k}{_SEP}"))
    return out


def _unflatten(flat: dict):
    root: dict = {}
    for key, val in flat.items():
        parts = key.split(_SEP)
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = val

    def listify(node):
        if not isinstance(node, dict):
            return node
        keys = list(node)
        if keys and all(re.fullmatch(r"\d+", k) for k in keys):
            return [listify(node[str(i)]) for i in range(len(keys))]
        return {k: listify(v) for k, v in node.items()}

    return listify(root)


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def save_checkpoint(ckpt_dir: str, step: int, state: dict,
                    extra_meta: dict | None = None) -> str:
    """Atomically persist a tree of tensors (a ``ParamTree`` is written in
    the reference's layout). Returns the final path."""
    os.makedirs(ckpt_dir, exist_ok=True)
    arrays = {k: _to_numpy(v) for k, v in _flatten(state).items()}
    meta = {"step": step, **(extra_meta or {})}
    path = os.path.join(ckpt_dir, f"step_{step:08d}.npz")
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, __meta__=json.dumps(meta), **arrays)
    os.replace(tmp, path)
    return path


def latest_step(ckpt_dir: str) -> int | None:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [int(m.group(1)) for f in os.listdir(ckpt_dir)
             if (m := re.fullmatch(r"step_(\d+)\.npz", f))]
    return max(steps) if steps else None


def load_checkpoint(ckpt_dir: str, step: int | None = None,
                    device: str | torch.device | None = None) -> tuple[dict, dict]:
    """Load (state, meta): the state's leaves as tensors on ``device``
    (default: the CUDA device), in the reference's layout (each stack of
    layers stacked, or a list; ``ModelDef.params_from_numpy`` makes the port's
    parameters of ``state["params"]``)."""
    dev = resolve_device(device)
    step = step if step is not None else latest_step(ckpt_dir)
    if step is None:
        raise FileNotFoundError(f"no checkpoints in {ckpt_dir}")
    path = os.path.join(ckpt_dir, f"step_{step:08d}.npz")
    with np.load(path, allow_pickle=False) as z:
        meta = json.loads(str(z["__meta__"]))
        flat = {key: torch.from_numpy(np.array(z[key])).to(dev)
                for key in z.files if key != "__meta__"}
    return _unflatten(flat), meta


def reshard_checkpoint(state: dict, mesh, sharding_rules) -> dict:
    """Re-place every leaf of a host-loaded state under ``mesh``.

    ``sharding_rules(path, leaf)`` gives a
    :class:`~repro_torch.distributed.sharding.NamedSharding` (the leaf
    becomes a ``ShardedTensor``, each piece an owned copy on its mesh
    device) or None (a plain tensor copied onto the mesh's first device).
    Checkpoints store unsharded arrays, so moving from one mesh to another
    is only a placement decision here: the elastic-scaling primitive.
    """
    first = mesh.devices.flat[0]
    out = {}
    for path, leaf in _flatten(state).items():
        sh = sharding_rules(path, leaf)
        out[path] = (sh.place(leaf) if sh is not None
                     else torch.as_tensor(leaf).to(first, copy=True))
    return _unflatten(out)
