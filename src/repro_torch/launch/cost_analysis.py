"""Cost model of one step of the port on the H100: FLOPs, bytes,
collective bytes and the roofline terms (the twin of
``repro/launch/hlo_analysis.py``).

PyTorch has no compiled program to ask, no HLO and no
``cost_analysis()``, so the costs come from a trace of the step itself:
:class:`CostCounter` is a ``TorchDispatchMode`` that sees every aten
operation the step runs, on ``meta`` tensors (shapes, no storage, no
device) or on real ones, and counts

* ``flops``: matmul-class FLOPs (``mm``, ``bmm``, ``addmm``, attention and
  convolution kernels) by the rules of ``torch.utils.flop_counter``;
* ``other_ops``: the element operations of everything else, kept apart: an
  elementwise operation one a result element, a reduction one an input
  element, a sort ``n log2 n``; copies, gathers and tensor creation none;
* ``bytes``: each operation's tensor operands read once and its results
  written once (a gather reads what it returns; an expanded operand its
  distinct elements). This is the port's eager,
  unfused traffic: an upper bound of what the step must move, not XLA's
  fused "bytes accessed". Views (``view``, ``reshape``, ``expand``,
  ``slice``, ``transpose``, ...) and empty allocations move 0 bytes;
* an estimate of the peak bytes of tensors the trace made and still holds
  (each result counted from its operation until it is freed; the step's
  arguments are not in it).

Collectives are modelled, not traced: the reference's per-cell numbers come
from XLA's SPMD partitioner, which PyTorch has no twin of, and are not
reproduced. They follow the port's own placements
(``distributed/sharding.py``) by these rules, each in the reference's
convention of result-buffer bytes a device and its five kinds
(:data:`COLLECTIVES`):

=============== ============================================================
kind            when, and the bytes a device
=============== ============================================================
all-gather      FSDP: every parameter leaf whose spec shards a dim on a
                data axis, once a forward pass; a train step gathers it
                again for the backward, and once more for remat's
                recompute. Bytes: the leaf over its ``model`` shards.
reduce-scatter  FSDP, train: each such leaf's gradient over ``data``.
                Bytes: the leaf over its ``model`` shards and ``data``.
all-reduce      TP: a matmul that contracts a ``model``-sharded dim of a
                parameter (forward, recompute and backward alike, as the
                trace runs them), and a lookup into a ``model``-sharded
                table: its result over the data axes that divide its rows.
                DP, train: each gradient of a leaf not sharded on a data
                axis, over the leaf's ``model`` shards. Multi-pod, train:
                each FSDP gradient's ``data`` piece once more over ``pod``.
all-to-all      SP: a prefill's KV cache, projected heads-sharded and kept
                sequence-sharded on ``model`` (``cache_sharding``). Bytes:
                its piece. EP: every ``moe_dispatch`` point, twice
                (dispatch and combine), once more each for its transpose in
                the backward when it needs grad. Bytes: the dispatch
                buffer over its spec's shards.
collective-     none: pipeline stages are not part of these steps.
permute
=============== ============================================================

No other activation changes its ``model`` sharding in these steps: heads
(``act_heads``), features (``act_ff``) and sequence (``kv_seq``,
``decode_scores``) are each made by their own projection or cache read, a
local slice of a replicated activation, and leave through a TP
all-reduce. The ``moe_dispatch`` points are counted by the counter's own
hook (:meth:`CostCounter.shard_hook`): ``sharding.install_activation_hook``
keeps one entry a (name, shape), so it cannot count.

Bytes a device: the element operations' traffic splits over the chips as
the work does, but a matmul's parameter operand is read whole by every
data-parallel replica after its FSDP all-gather: it counts as its bytes
over its ``model`` shards on every chip (:meth:`Costs.bytes_per_device`).

Hardware: one NVIDIA H100 SXM5 (constants below, each with its source).
A 16-wide mesh axis spans two 8-GPU NVLink domains, so its collectives
cross the slower inter-node network: the collective term is a lower bound
there.
"""
from __future__ import annotations

import dataclasses
import math
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

# --- NVIDIA H100 SXM5 constants (per GPU) -----------------------------------
PEAK_FLOPS_BF16 = 989e12     # FLOP/s, dense bf16 tensor core (H100 SXM5 datasheet)
PEAK_FLOPS_FP32 = 67e12      # FLOP/s, float32 outside the tensor cores (same datasheet)
HBM_BW = 3.35e12             # bytes/s, HBM3 (same datasheet)
HBM_BYTES = 80e9             # 80 GB HBM3 (same datasheet)
LINK_BW = 450e9              # bytes/s a direction: NVLink 4, 900 GB/s total (same datasheet)

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")


@dataclasses.dataclass
class Roofline:
    compute_s: float
    memory_s: float
    collective_s: float
    flops: float
    bytes_accessed: float
    coll_bytes: float
    chips: int

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def bound_s(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)


def roofline_terms(flops: float, bytes_accessed: float, coll_bytes: float,
                   chips: int, other_ops: float = 0.0) -> Roofline:
    """The three-term roofline: whole-job ``flops`` (matmul-class, on the
    tensor cores) and ``bytes_accessed`` over ``chips`` H100s at their peak
    rates; ``coll_bytes`` summed over the chips, each chip's links carrying
    its own share at LINK_BW. ``other_ops`` (element operations) add their
    time at the float32 rate outside the tensor cores: the eager port runs
    them in kernels of their own, apart from its matmuls, so the two times
    add."""
    return Roofline(
        compute_s=(flops / (chips * PEAK_FLOPS_BF16)
                   + other_ops / (chips * PEAK_FLOPS_FP32)),
        memory_s=bytes_accessed / (chips * HBM_BW),
        collective_s=coll_bytes / (chips * LINK_BW),
        flops=flops, bytes_accessed=bytes_accessed, coll_bytes=coll_bytes,
        chips=chips)


# --- operation classes --------------------------------------------------------

def _names(*names: str) -> frozenset:
    return frozenset(names)


# results made without reading or computing anything
_ALLOCS = _names("empty", "empty_strided", "empty_like", "new_empty", "new_empty_strided",
                 "_local_scalar_dense", "set_")
# views PyTorch does not flag as views (matmul reshapes its result with it)
_VIEWS = _names("_unsafe_view")
# data movement: bytes, no element operations
_MOVES = _names("_to_copy", "copy", "copy_", "clone", "contiguous", "cat", "stack",
                "zeros", "zeros_like", "ones", "ones_like", "full", "full_like",
                "new_zeros", "new_ones", "new_full", "fill", "fill_", "zero_", "arange",
                "scalar_tensor", "repeat", "constant_pad_nd", "flip", "roll",
                "slice_scatter", "select_scatter", "as_strided_scatter", "tril", "triu",
                "index_put", "index_put_", "_index_put_impl_", "scatter", "scatter_",
                "lift_fresh_copy", "_unsafe_index_put")
# in-place operations that overwrite their first operand without reading it
_OVERWRITES = _names("copy_", "fill_", "zero_", "index_put_", "_index_put_impl_", "set_")
# reads what they return (and their indices), not the whole source
_GATHERS = _names("index", "_unsafe_index", "index_select", "gather", "embedding")
# one element operation an input element
_REDUCTIONS = _names("sum", "mean", "amax", "amin", "max", "min", "argmax", "argmin",
                     "prod", "var", "var_mean", "std", "std_mean", "norm",
                     "linalg_vector_norm", "logsumexp", "_softmax", "_log_softmax",
                     "_softmax_backward_data", "_log_softmax_backward_data", "cumsum",
                     "cumprod", "any", "all", "topk", "nll_loss_forward",
                     "nll_loss_backward", "native_layer_norm", "native_layer_norm_backward",
                     "count_nonzero")
_SORTS = _names("sort")
_MATMULS = {"mm": (0, 1), "addmm": (1, 2), "bmm": (0, 1), "baddbmm": (1, 2)}


def _nbytes(t: torch.Tensor) -> int:
    """Bytes of the distinct elements of ``t``: an expanded dim (stride 0)
    holds one, as a kernel reading it reads one."""
    if t.numel() == 0:
        return 0
    return math.prod(s for s, st in zip(t.shape, t.stride()) if st != 0) * t.element_size()


def _tensors(tree, out=None) -> list:
    """The distinct tensors of an operation's arguments or results."""
    out = [] if out is None else out
    if isinstance(tree, torch.Tensor):
        if not any(tree is t for t in out):
            out.append(tree)
    elif isinstance(tree, (list, tuple)):
        for x in tree:
            _tensors(x, out)
    elif isinstance(tree, dict):
        for x in tree.values():
            _tensors(x, out)
    return out


@dataclasses.dataclass
class Costs:
    """Counts: ``flops``, ``other_ops`` and ``bytes`` of the
    whole job; ``param_bytes`` the part of ``bytes`` that matmuls read of
    parameters, ``param_bytes_device`` what one chip reads of them (each
    over its ``model`` shards); ``coll`` bytes a device by kind."""
    flops: float = 0.0
    other_ops: float = 0.0
    bytes: float = 0.0
    param_bytes: float = 0.0
    param_bytes_device: float = 0.0
    coll: dict = dataclasses.field(default_factory=lambda: dict.fromkeys(COLLECTIVES, 0.0))

    def add(self, other: "Costs", times: float = 1.0) -> None:
        for f in ("flops", "other_ops", "bytes", "param_bytes", "param_bytes_device"):
            setattr(self, f, getattr(self, f) + times * getattr(other, f))
        for k in COLLECTIVES:
            self.coll[k] += times * other.coll[k]

    def bytes_per_device(self, chips: int) -> float:
        return (self.bytes - self.param_bytes) / chips + self.param_bytes_device



class CostCounter(TorchDispatchMode):
    """Counts the costs of every aten operation run under it (module
    docstring) in ``total``. Counters nest: an operation run under two is
    counted by both.

    With a ``mesh`` it also models the TP all-reduces, the parameter reads
    a device makes and the EP all-to-alls: :meth:`tag_param` marks a
    parameter and its ``model``-sharded dims (followed through casts, views
    and transposes), and :meth:`shard_hook` is the ``maybe_shard`` hook to
    install (``models.common.set_shard_hook``). A copy of a parameter made
    before the counter started is marked with :meth:`tag_like`."""

    def __init__(self, mesh=None):
        super().__init__()
        self.mesh = mesh
        self.total = Costs()
        self._dims: dict[int, tuple] = {}      # id -> (weakref, model mask per dim)
        self.live = 0
        self.peak = 0

    def _charge(self, flops=0.0, other=0.0, nbytes=0.0, coll=None, params=None) -> None:
        c = self.total
        c.flops += flops
        c.other_ops += other
        c.bytes += nbytes
        if coll is not None:
            c.coll[coll[0]] += coll[1]
        if params is not None:
            c.param_bytes += params[0]
            c.param_bytes_device += params[1]

    # -- collectives ------------------------------------------------------------
    def _axis_size(self, names) -> int:
        return math.prod(self.mesh.shape[n] for n in names)

    def _dp_shards(self, rows: int) -> int:
        dp = [a for a in ("pod", "data") if a in self.mesh.shape]
        size = self._axis_size(dp)
        return size if dp and rows % size == 0 and rows >= size else 1

    def tag_param(self, tensor: torch.Tensor, spec) -> None:
        """Mark ``tensor`` as a parameter placed by ``spec`` (one entry a
        dim), with the dims it shards on ``model``."""
        mask = tuple(a == "model" or (isinstance(a, tuple) and "model" in a)
                     for a in (*spec, *(None,) * (tensor.dim() - len(spec))))
        self._dims[id(tensor)] = (weakref.ref(tensor), mask)

    def tag_like(self, tensor: torch.Tensor, param: torch.Tensor) -> None:
        """Mark ``tensor``, a copy of the tagged ``param`` of its shape
        made outside the counter, as ``param`` is marked."""
        mask = self._mask(param)
        if mask is not None:
            self._dims[id(tensor)] = (weakref.ref(tensor), mask)

    def _mask(self, t) -> tuple | None:
        if not isinstance(t, torch.Tensor):
            return None
        hit = self._dims.get(id(t))
        return hit[1] if hit is not None and hit[0]() is t else None

    def _follow(self, name: str, args, out) -> None:
        """Carry a tagged operand's mask to the result of a cast, view or
        transpose of it."""
        src = self._mask(args[0]) if args else None
        if src is None or not isinstance(out, torch.Tensor):
            return
        shape_in, shape_out = tuple(args[0].shape), tuple(out.shape)
        mask = None
        if name in ("t", "numpy_T") and len(src) == 2:
            mask = src[::-1]
        elif name == "transpose":
            d0, d1 = (d % len(src) for d in args[1:3])
            m = list(src)
            m[d0], m[d1] = m[d1], m[d0]
            mask = tuple(m)
        elif name == "permute":
            mask = tuple(src[d % len(src)] for d in args[1])
        elif shape_in == shape_out:
            mask = src
        elif name in ("expand", "view", "_unsafe_view", "reshape", "unsqueeze",
                      "squeeze", "alias"):
            # a sharded dim survives where the result has a dim of its size
            # starting at the same element offset
            def offsets(shape):
                acc, out_ = [], 1
                for d in reversed(shape):
                    acc.append(out_)
                    out_ *= d
                return acc[::-1]
            off_in, off_out = offsets(shape_in), offsets(shape_out)
            keys = {(shape_in[i], off_in[i]) for i, m in enumerate(src) if m}
            lead = len(shape_out) - len(shape_in) if name == "expand" else 0
            mask = tuple((shape_out[j], off_out[j]) in keys if name != "expand"
                         else (j >= lead and src[j - lead])
                         for j in range(len(shape_out)))
        if mask is not None:
            self._dims[id(out)] = (weakref.ref(out), mask)

    def _tp_all_reduce(self, name: str, args, out) -> None:
        if name in _MATMULS:
            a, b = (args[i] for i in _MATMULS[name])
            ma, mb = self._mask(a), self._mask(b)
            hit = (ma is not None and ma[-1]) or (mb is not None and mb[-2])
            for t, mt in ((a, ma), (b, mb)):
                if mt is not None:
                    shards = self.mesh.shape["model"] if any(mt) else 1
                    self._charge(params=(_nbytes(t), _nbytes(t) / shards))
        else:                       # a lookup into a table sharded on its rows
            ma = self._mask(args[0])
            hit = ma is not None and ma[0]
        if hit:
            self._charge(coll=("all-reduce", _nbytes(out) / self._dp_shards(out.shape[0])))

    def shard_hook(self, x: torch.Tensor, logical: str) -> torch.Tensor:
        """The ``maybe_shard`` hook: counts the EP all-to-alls of the
        module docstring, leaves ``x`` alone."""
        if logical != "moe_dispatch":
            return x
        from repro_torch.distributed.sharding import activation_spec
        spec = activation_spec(x.shape, logical, self.mesh)
        shards = math.prod(self._axis_size(a if isinstance(a, tuple) else (a,))
                           for a in spec if a is not None)
        moves = 2                       # dispatch and combine
        if (torch.is_grad_enabled() and x.requires_grad
                and torch._C._current_graph_task_id() == -1):
            moves *= 2                  # and their transposes in the backward
        self._charge(coll=("all-to-all", moves * _nbytes(x) / shards))
        return x

    # -- the dispatch ---------------------------------------------------------
    def _freed(self, nbytes: int) -> None:
        self.live -= nbytes

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        name = func._overloadpacket.__name__
        view = func.is_view or name in _VIEWS
        ins = _tensors((args, kwargs))
        written = _tensors(out)
        made = [t for t in written if not any(t is i for i in ins)]
        read = ins[1:] if name in _OVERWRITES else ins
        if func._overloadpacket in flop_registry:
            flops = flop_registry[func._overloadpacket](*args, **kwargs, out_val=out)
            self._charge(flops=flops, nbytes=sum(map(_nbytes, read + written)))
            if self.mesh is not None and name in _MATMULS:
                self._tp_all_reduce(name, args, out)
        elif view or name in _ALLOCS:       # nothing moved
            if self.mesh is not None:
                self._follow(name, args, out)
        else:
            if name in _GATHERS:
                nbytes = 2 * sum(map(_nbytes, written)) + sum(
                    _nbytes(t) for t in ins[1:] if not t.is_floating_point())
                if self.mesh is not None:
                    self._tp_all_reduce(name, args, out)
            else:
                nbytes = sum(map(_nbytes, read + written))
            if name in _MOVES or name in _GATHERS:
                other = 0
            elif name in _SORTS:
                width = ins[0].shape[-1] if ins[0].dim() else 1
                other = ins[0].numel() * max(1, math.ceil(math.log2(max(width, 1))))
            elif name in _REDUCTIONS:
                other = ins[0].numel() if ins else 0
            else:
                other = sum(t.numel() for t in written)
            self._charge(other=other, nbytes=nbytes)
            if self.mesh is not None and name in _MOVES:
                self._follow(name, args, out)
        if not view:
            for t in made:
                n = _nbytes(t)
                self.live += n
                weakref.finalize(t, self._freed, n)
            self.peak = max(self.peak, self.live)
        return out
