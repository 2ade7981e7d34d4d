"""Sharding rules: DP / FSDP / TP / EP / SP over a mesh
(``repro/distributed/sharding.py``).

Parameters get 2-D shardings (Megatron-style TP on the contraction-adjacent
dim + ZeRO-3/FSDP on the other), experts shard on the model axis (EP), decode
KV caches shard sequence on the model axis (SP) so 32k-context caches fit.
Dims that do not divide evenly by the mesh axis are left unsharded.

The rules are *path-pattern based* over the flattened param tree, with the
reference's path strings (``blocks/attn/wq`` for a stack of layers,
``blocks/0/rec/w_x`` for a list of layers): :func:`flatten_paths` gives
them for a port :class:`~repro_torch.models.common.ParamTree` in the
reference's layout. :func:`param_spec` and the rules are the reference's,
unchanged.

PyTorch has no GSPMD, so :class:`NamedSharding` and
:class:`PartitionSpec` are a small pair of the port's own:
``shard_shape(shape)`` gives one device's piece, and ``place(tensor)``
(the twin of ``jax.device_put`` with a sharding) cuts a tensor into a
:class:`ShardedTensor` whose pieces sit on their mesh devices, a
replicated axis copied to each of its devices; ``gather(device)`` puts
the whole tensor back together bit for bit. Activation shardings are the
``maybe_shard`` hook (:func:`install_activation_hook`): it resolves each
logical name's spec as the reference's hook does and leaves values
alone, as ``with_sharding_constraint`` changes no value.
"""
from __future__ import annotations

import math
import re

import numpy as np
import torch

from repro_torch.launch.mesh import Mesh, data_axes
from repro_torch.models import common as C


class PartitionSpec(tuple):
    """One entry a tensor dim: None (replicated), an axis name, or a tuple
    of axis names (major first); missing trailing entries are None."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


class NamedSharding:
    """A :class:`PartitionSpec` on a mesh (``mesh.shape`` and
    ``mesh.devices``)."""

    def __init__(self, mesh: Mesh, spec: PartitionSpec):
        self.mesh, self.spec = mesh, PartitionSpec(*spec)

    def __repr__(self) -> str:
        return f"NamedSharding({self.mesh!r}, {self.spec!r})"

    def _dim_axes(self, ndim: int) -> list[tuple[str, ...]]:
        if len(self.spec) > ndim:
            raise ValueError(f"{self.spec} has more entries than a rank-{ndim} tensor")
        axes = [() if a is None else (a if isinstance(a, tuple) else (a,))
                for a in (*self.spec, *(None,) * (ndim - len(self.spec)))]
        used = [n for names in axes for n in names]
        if len(set(used)) != len(used) or not set(used) <= set(self.mesh.shape):
            raise ValueError(f"{self.spec} on a mesh with axes {tuple(self.mesh.shape)}")
        return axes

    def shard_shape(self, shape) -> tuple:
        """The shape of one device's piece of a tensor of ``shape``."""
        sizes = self.mesh.shape
        out = []
        for dim, names in zip(shape, self._dim_axes(len(shape))):
            count = math.prod(sizes[n] for n in names)
            if dim % count:
                raise ValueError(f"dim {dim} of {tuple(shape)} does not divide over "
                                 f"{names} ({count})")
            out.append(dim // count)
        return tuple(out)

    def _slices(self, shape, pos) -> tuple:
        """The piece of a ``shape`` tensor at mesh position ``pos``."""
        names = self.mesh.axis_names
        piece = self.shard_shape(shape)
        out = []
        for size, dim_names in zip(piece, self._dim_axes(len(shape))):
            i = 0
            for n in dim_names:
                k = names.index(n)
                i = i * self.mesh.devices.shape[k] + pos[k]
            out.append(slice(i * size, (i + 1) * size))
        return tuple(out)

    def place(self, tensor) -> "ShardedTensor":
        """``tensor`` (a tensor or a host array) cut into pieces on the
        mesh's devices: each device's piece is a copy of its own (never an
        alias of ``tensor``): a tensor staged whole once a distinct device,
        a host array copied out a piece at a time."""
        if not isinstance(tensor, torch.Tensor):
            tensor = np.asarray(tensor)
        staged: dict = {}
        pieces = np.empty(self.mesh.devices.shape, dtype=object)
        for pos in np.ndindex(pieces.shape):
            dev = self.mesh.devices[pos]
            cut = self._slices(tensor.shape, pos)
            if isinstance(tensor, np.ndarray):      # each piece copied out once
                pieces[pos] = owned_tensor(tensor[cut], dev)
                continue
            if dev not in staged:
                staged[dev] = tensor.to(dev)
            pieces[pos] = staged[dev][cut].clone(memory_format=torch.contiguous_format)
        return ShardedTensor(pieces, self, tuple(tensor.shape), pieces.flat[0].dtype)


def owned_tensor(x, device) -> torch.Tensor:
    """``x`` (a tensor or a host array) on ``device``, copied once: it
    shares no memory with ``x``. A host array is never shared, not even
    for a moment: a read-only memory map makes PyTorch warn, and the
    warning, once a process, would hide a later real alias."""
    if isinstance(x, np.ndarray):
        return torch.tensor(x, device=device)
    return torch.as_tensor(x).to(device, copy=True)


class ShardedTensor:
    """A tensor placed by :meth:`NamedSharding.place`: ``pieces`` an
    object array of the mesh's shape, each a tensor on its mesh device."""

    def __init__(self, pieces: np.ndarray, sharding: NamedSharding, shape: tuple,
                 dtype: torch.dtype):
        self.pieces, self.sharding, self.shape, self.dtype = pieces, sharding, shape, dtype

    def _replicated_axes(self) -> tuple[int, ...]:
        used = {n for names in self.sharding._dim_axes(len(self.shape)) for n in names}
        return tuple(k for k, n in enumerate(self.sharding.mesh.axis_names) if n not in used)

    def gather(self, device=None) -> torch.Tensor:
        """The whole tensor on ``device`` (default: the first mesh
        device's), from the pieces at index 0 of every replicated axis."""
        dev = torch.device(device) if device is not None else self.pieces.flat[0].device
        out = torch.empty(self.shape, dtype=self.dtype, device=dev)
        rep = self._replicated_axes()
        for pos in np.ndindex(self.pieces.shape):
            if all(pos[k] == 0 for k in rep):
                out[self.sharding._slices(self.shape, pos)] = self.pieces[pos].to(dev)
        return out


# (path regex, spec per trailing dims) — first match wins. "fsdp" resolves to
# the mesh's data axes, "model" to the TP axis. Specs are for the LOGICAL
# (unstacked) rank; stacked layer params (leading L dim) get None prepended
# automatically.
_PARAM_RULES: list[tuple[str, tuple]] = [
    (r"(^|/)embed$",                ("model", "fsdp")),     # (V, d)
    (r"(^|/)lm_head$",              ("fsdp", "model")),     # (d, V)
    (r"(^|/)patch_proj$",           (None, "fsdp")),
    (r"(^|/)pos_(enc|dec)$",        (None, None)),
    (r"/attn/w[qkv]$",              ("fsdp", "model")),
    (r"/attn/wo$",                  ("model", "fsdp")),
    (r"/(self|cross)_attn/w[qkv]$", ("fsdp", "model")),
    (r"/(self|cross)_attn/wo$",     ("model", "fsdp")),
    (r"/moe/router$",               ("fsdp", None)),
    (r"/moe/w_(gate|up)$",          ("model", "fsdp", None)),   # (E, d, ff)
    (r"/moe/w_down$",               ("model", None, "fsdp")),   # (E, ff, d)
    (r"/mlp/w_(gate|up)$",          ("fsdp", "model")),
    (r"/mlp/w_down$",               ("model", "fsdp")),
    (r"/mlp/b_up$",                 ("model",)),
    (r"/mlp/b_down$",               (None,)),
    # rwkv6 time-mix (d,d) and output
    (r"/tm/w_[rkvg]$",              ("fsdp", "model")),
    (r"/tm/w_o$",                   ("model", "fsdp")),
    (r"/tm/w_lora_[ab]$",           (None, None)),
    # rwkv6 channel-mix
    (r"/cm/w_k$",                   ("fsdp", "model")),
    (r"/cm/w_v$",                   ("model", "fsdp")),
    (r"/cm/w_r$",                   ("fsdp", "model")),
    # recurrentgemma RG-LRU block
    (r"/rec/w_(x|gate)$",           ("fsdp", "model")),
    (r"/rec/w_out$",                ("model", "fsdp")),
    (r"/rec/w_(input|rec)_gate$",   (None, "model")),
    (r"/rec/b_(input|rec)_gate$",   ("model",)),
    (r"/rec/conv_w$",               (None, "model")),
    (r"/rec/conv_b$",               ("model",)),
    (r"/rec/lambda$",               ("model",)),
]


def _resolve(axis, mesh):
    if axis == "fsdp":
        ax = data_axes(mesh)
        return ax if len(ax) > 1 else (ax[0] if ax else None)
    return axis


def _fits(dim: int, axis, mesh) -> bool:
    if axis is None:
        return True
    names = axis if isinstance(axis, tuple) else (axis,)
    size = 1
    for n in names:
        size *= mesh.shape[n]
    return dim % size == 0 and dim >= size


def _spec_for_shape(shape, spec, mesh):
    """Adapt a rule spec to an actual shape: prepend None for stacked dims,
    drop axes that don't divide."""
    spec = tuple(spec)
    if len(shape) == len(spec) + 1:          # stacked layers
        spec = (None, *spec)
    elif len(shape) != len(spec):
        return P()                           # rank mismatch: replicate
    out = []
    for dim, axis in zip(shape, spec):
        axis = _resolve(axis, mesh)
        out.append(axis if _fits(dim, axis, mesh) else None)
    return P(*out)


def param_spec(path: str, shape, mesh) -> PartitionSpec:
    """PartitionSpec for one param (mesh only consulted for axis sizes)."""
    for pattern, spec in _PARAM_RULES:
        if re.search(pattern, path):
            return _spec_for_shape(shape, spec, mesh)
    return P()                               # norms, scalars, mus: replicate


def param_sharding(path: str, arr, mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, param_spec(path, arr.shape, mesh))


def _param_groups(params: C.ParamTree) -> list[tuple[str, tuple, list]]:
    """(reference path string, reference shape, the port's tensors) of
    each leaf of ``params`` in the reference's layout, stacking nothing."""
    stacked = params.stacked_blocks
    return [("/".join(map(str, path)),
             (len(ts), *ts[0].shape) if C.stacked_path(path, stacked) else tuple(ts[0].shape),
             ts)
            for path, ts in C.leaf_groups(params.tree(), stacked)]


def flatten_paths(tree, prefix: str = "") -> dict:
    """Path string -> leaf. A :class:`ParamTree` is taken in the
    reference's layout (each stack of layers one tensor, stacked here)."""
    if isinstance(tree, C.ParamTree):
        tree = C.stack_tree(tree.tree(), tree.stacked_blocks)
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(flatten_paths(v, f"{prefix}{k}/"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(flatten_paths(v, f"{prefix}{i}/"))
    else:
        out[prefix.rstrip("/")] = tree
    return out


def shard_params_tree(params, mesh: Mesh):
    """NamedSharding tree matching ``params``: the same structure for a
    nested dict/list; for a :class:`ParamTree`, a nested dict in the
    reference's layout (each stack of layers one leaf)."""
    if isinstance(params, C.ParamTree):
        return C.nest((tuple(int(k) if k.isdigit() else k for k in p.split("/")),
                       NamedSharding(mesh, param_spec(p, shape, mesh)))
                      for p, shape, _ in _param_groups(params))

    def rebuild(tree, prefix=""):
        if isinstance(tree, dict):
            return {k: rebuild(v, f"{prefix}{k}/") for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(rebuild(v, f"{prefix}{i}/") for i, v in enumerate(tree))
        return param_sharding(prefix.rstrip("/"), tree, mesh)

    return rebuild(params)


# ---------------------------------------------------------------------------
# batch / cache shardings
# ---------------------------------------------------------------------------

def _dp(mesh):
    dp = data_axes(mesh)
    return dp if len(dp) > 1 else (dp[0] if dp else None)


def batch_sharding(batch_specs: dict, mesh: Mesh) -> dict:
    """tokens/labels (B, S) -> batch on data axes; frontend embeds likewise."""
    dp = _dp(mesh)

    def one(spec):
        axes = [dp if _fits(spec.shape[0], dp, mesh) else None]
        axes += [None] * (len(spec.shape) - 1)
        return NamedSharding(mesh, P(*axes))

    return C.tree_map(one, batch_specs)


def cache_sharding(cache_specs, mesh: Mesh):
    """KV caches: batch on data axes, sequence on model (SP) so 32k-context
    caches fit HBM; recurrent states: width on model."""
    dp = _dp(mesh)

    def one(spec):
        shape = spec.shape
        if len(shape) == 5:      # (L, B, S, G, hd) stacked KV
            axes = [None,
                    dp if _fits(shape[1], dp, mesh) else None,
                    "model" if _fits(shape[2], "model", mesh) else None,
                    None, None]
        elif len(shape) == 4:    # (B, S, G, hd) per-layer KV
            axes = [dp if _fits(shape[0], dp, mesh) else None,
                    "model" if _fits(shape[1], "model", mesh) else None,
                    None, None]
        elif len(shape) == 3:    # (L, B, d) token-shift / (B, W, rnn) conv
            axes = [None,
                    dp if _fits(shape[1], dp, mesh) else None,
                    "model" if _fits(shape[2], "model", mesh) else None]
        elif len(shape) == 2:    # (B, rnn) state
            axes = [dp if _fits(shape[0], dp, mesh) else None,
                    "model" if _fits(shape[1], "model", mesh) else None]
        elif len(shape) == 1:
            axes = [None]
        else:                    # (L, B, H, K, V) wkv state — shard H
            axes = [None] * len(shape)
            if len(shape) >= 3:
                axes[1] = dp if _fits(shape[1], dp, mesh) else None
                axes[2] = "model" if _fits(shape[2], "model", mesh) else None
        return NamedSharding(mesh, P(*axes))

    return C.tree_map(one, cache_specs)


# ---------------------------------------------------------------------------
# activation annotations (the maybe_shard hook)
# ---------------------------------------------------------------------------

def activation_spec(shape, logical: str, mesh) -> PartitionSpec | None:
    """The spec the reference's hook constrains an activation of ``shape``
    named ``logical`` to (axes that do not divide dropped), or None for a
    name it leaves alone."""
    dp_ax = _dp(mesh)
    spec = {
        "act_btd": (dp_ax, None, None),
        "act_ff": (dp_ax, None, "model"),
        "act_heads": (dp_ax, None, "model", None),
        "moe_dispatch": (dp_ax, "model", None, None),   # (B, E, C, d)
        "moe_hidden": (dp_ax, "model", None, None),     # (B, E, C, ff)
        "kv_seq": (dp_ax, "model", None, None),         # (B, S, H, hd)
        "decode_scores": (dp_ax, None, None, "model"),  # (B, H, 1, S)
    }.get(logical)
    if spec is None:
        return None
    return P(*(ax if _fits(dim, ax, mesh) else None
               for dim, ax in zip(shape, spec + (None,) * len(shape))))


def install_activation_hook(mesh: Mesh):
    """Install the ``maybe_shard`` hook for ``mesh``: the identity on
    values, recording each (logical name, shape) it sees with its spec in
    ``hook.seen``. Returns the hook."""
    def hook(x, logical):
        spec = activation_spec(x.shape, logical, mesh)
        if spec is not None:
            hook.seen[(logical, tuple(x.shape))] = spec
        return x

    hook.seen = {}
    C.set_shard_hook(hook)
    return hook


def clear_activation_hook() -> None:
    C.set_shard_hook(None)
