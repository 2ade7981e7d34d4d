"""Runtime checks under ``REPRO_SANITIZE=1`` (a copy of
``repro/analysis/sanitize.py`` for torch tensors).

* Slot canaries: :class:`~repro_torch.data.pipeline.AsyncChunkReader`
  poisons a host slot (:func:`poison`) the moment the consumer hands it
  back, then re-checks every tensor ``stage()`` took from it against the
  host :func:`snapshot` made at stage time (:func:`verify_staged`). A
  "copy" that aliases the slot (``torch.from_numpy`` of a slot view) now
  shows the canary and raises :class:`SanitizerError` at the recycle, the
  earliest instant the alias could change under the consumer.
* :class:`MmapGuard`: ``storage/format.py::open_saved`` wraps the LRD, LSD
  and encoded memory maps; any dereference after ``SavedIndex.close()``
  raises :class:`UseAfterCloseError` instead of reading a dead map.
* :class:`ThreadAffinity`: first-touch thread ownership of single-owner
  structures (``SlotQueue``);
* lockdep: :func:`wrap_lock` feeds a process-global lock-acquisition-order
  graph that raises :class:`LockOrderError` before an ABBA acquisition can
  block, and :func:`lockdep_task` asserts that a thread-pool work item
  (``dist-ooc``'s shard fan-out) starts and ends holding no tracked lock.

Every check collapses to a no-op when the variable is unset.
"""
from __future__ import annotations

import os
import threading
import traceback

import numpy as np
import torch

ENV_VAR = "REPRO_SANITIZE"

#: Canary for integer slots. Detection never relies on the value being
#: impossible in real data (staged copies are compared against snapshots);
#: it only has to differ from what the slot held when it was staged.
CANARY_INT = 0xAB


def sanitize_enabled() -> bool:
    """True when ``REPRO_SANITIZE`` is set to anything but '' / '0'."""
    return os.environ.get(ENV_VAR, "") not in ("", "0")


class SanitizerError(RuntimeError):
    """A runtime sanitizer check failed."""


class UseAfterCloseError(SanitizerError):
    """A memory-mapped view was dereferenced after its index was closed."""


class ThreadOwnershipError(SanitizerError):
    """A single-owner structure (``SlotQueue``) was touched from a thread
    other than the one it is bound to."""


class LockOrderError(SanitizerError):
    """Two locks were acquired in opposite orders on different paths: a
    latent ABBA deadlock. Raised *before* blocking, at the acquisition that
    would close the cycle, with both acquisition stacks."""


class HeldLockError(SanitizerError):
    """A thread-pool work item started or finished while holding a lock:
    pool threads must never carry locks across work-item boundaries."""


def poison(buf: np.ndarray) -> None:
    """Overwrite ``buf`` in place with a canary (NaN for floats): a tensor
    that still aliases it now reads the canary, and float work on the alias
    turns to NaN instead of quietly wrong answers."""
    if buf.dtype.kind == "f":
        buf[...] = np.nan
    elif buf.dtype.kind in ("i", "u"):
        buf[...] = np.asarray(CANARY_INT, dtype=buf.dtype)
    else:       # bool, bytes: a deterministic flip suffices
        buf[...] = buf.dtype.type(0)


def snapshot(view: np.ndarray) -> np.ndarray:
    """Host copy of ``view`` taken at ``stage()`` time, for the later check."""
    return np.array(view, copy=True)


def _words(a: np.ndarray) -> np.ndarray:
    """``a``'s bits as unsigned words of its item size."""
    a = np.ascontiguousarray(a)
    return a.view(np.dtype(f"u{a.itemsize}") if a.itemsize in (1, 2, 4, 8) else np.uint8)


def verify_staged(staged: torch.Tensor, snap: np.ndarray, *, slot_id: int,
                  event=None) -> None:
    """Raise if a staged tensor no longer matches its host snapshot, bit for
    bit (a copy keeps every bit, NaN payloads too).

    Run after :func:`poison` on the slot the copy came from: a real copy is
    unaffected, an alias shows the canary. ``event`` is the CUDA event
    recorded behind the copy (the reader's ``_copied`` events): the tensor
    is read only once it has completed, so the check never races the
    side-stream copy."""
    if event is not None:
        event.synchronize()
    host = staged.detach().cpu().numpy()
    if host.shape != snap.shape or not np.array_equal(_words(host), _words(snap)):
        raise SanitizerError(
            f"staged tensor aliases reader slot {slot_id}: after the slot was "
            "poisoned the 'copy' changed under us. A torch.from_numpy / "
            "torch.as_tensor view (or a non_blocking copy recycled before its "
            "event) escaped the reader's explicit copy; use reader.stage() "
            "(data/pipeline.py::_owned_copy).")


class MmapGuard:
    """Array-like proxy over a memory map that fails loudly after release.

    Wraps ``SavedIndex.lrd`` / ``.lsd`` / ``.enc`` under ``REPRO_SANITIZE=1``.
    Reads (slicing, ``shape``, ``np.asarray``) delegate to the map until
    :meth:`release` (called from ``SavedIndex.close()``); afterwards every
    dereference raises :class:`UseAfterCloseError`. ``torch.from_numpy``
    takes no array-like: pass it a slice (an ndarray) or ``np.asarray(guard)``.
    """

    def __init__(self, arr: np.ndarray, label: str):
        self._arr = arr
        self._label = label
        self._released = False

    def _live(self) -> np.ndarray:
        if self._released:
            raise UseAfterCloseError(
                f"{self._label}: memory-mapped view dereferenced after close(). "
                "Copy what you need (np.array(..., copy=True) / to_layout()) "
                "before closing the index: a tensor that aliases a closed map "
                "reads freed pages.")
        return self._arr

    def release(self) -> None:
        """Invalidate the guard and close the underlying memory map."""
        arr, self._arr, self._released = self._arr, None, True
        mm = getattr(arr, "_mmap", None)
        if mm is not None:
            try:
                mm.close()
            except BufferError:
                # exported buffers keep the map alive until they are freed
                pass

    @property
    def shape(self):
        return self._live().shape

    @property
    def dtype(self):
        return self._live().dtype

    @property
    def ndim(self):
        return self._live().ndim

    @property
    def size(self):
        return self._live().size

    def __len__(self):
        return len(self._live())

    def __getitem__(self, idx):
        return self._live()[idx]

    def __array__(self, dtype=None, copy=None):
        arr = self._live()
        if copy:
            return np.array(arr, dtype=dtype, copy=True)
        return np.asarray(arr, dtype=dtype)

    def __repr__(self):
        state = "released" if self._released else "live"
        return f"MmapGuard({self._label}, {state})"


def guard_mmap(arr, label: str):
    """Wrap ``arr`` in a :class:`MmapGuard` when sanitizing, else return it."""
    if arr is not None and sanitize_enabled():
        return MmapGuard(arr, label)
    return arr


def _stack(skip: int = 2) -> str:
    return "".join(traceback.format_stack()[:-skip])


class _LockDep:
    """Process-global lock-acquisition-order graph.

    An edge A->B is recorded (with the stack that created it) the first
    time B is acquired while A is held; acquiring B with A held when a path
    B->...->A exists means another code path takes the same locks in the
    opposite order, and :class:`LockOrderError` is raised before the
    acquisition can block. Keys are the wrapper-supplied names, so two
    instances sharing a name class (per-shard locks) are one node: the
    conservative direction for deadlock detection.
    """

    def __init__(self):
        self._mutex = threading.Lock()       # guards the edge graph
        self._edges: dict = {}               # (a, b) -> recording stack
        self._held = threading.local()

    def held(self) -> list:
        if not hasattr(self._held, "names"):
            self._held.names = []
        return self._held.names

    def reset(self) -> None:
        """Clear the edge graph and the calling thread's held list (test
        isolation)."""
        with self._mutex:
            self._edges.clear()
        if hasattr(self._held, "names"):
            self._held.names = []

    def _find_path(self, src: str, dst: str):
        """Stack of the first edge on a src->...->dst path, or None."""
        seen, frontier = {src}, [(src, None)]
        while frontier:
            node, first_stack = frontier.pop()
            for (a, b), stack in self._edges.items():
                if a != node or b in seen:
                    continue
                edge_stack = first_stack or stack
                if b == dst:
                    return edge_stack
                seen.add(b)
                frontier.append((b, edge_stack))
        return None

    def note_acquire(self, name: str) -> None:
        held = self.held()
        if held:
            with self._mutex:
                for prior in held:
                    if prior == name:
                        continue    # reentrant / same name class
                    reverse = self._find_path(name, prior)
                    if reverse is not None:
                        raise LockOrderError(
                            f"lock-order cycle: acquiring '{name}' while "
                            f"holding '{prior}', but '{name}' -> '{prior}' "
                            "was already established: the ABBA deadlock "
                            "shape. Acquisition stack establishing the "
                            f"opposite order:\n{reverse}\nCurrent "
                            f"acquisition stack:\n{_stack()}")
                    self._edges.setdefault((prior, name), _stack())
        held.append(name)

    def note_release(self, name: str) -> None:
        held = self.held()
        for i in range(len(held) - 1, -1, -1):   # the latest acquisition
            if held[i] == name:
                del held[i]
                break


#: Process-global lockdep state (shared so cycles across subsystems are
#: visible). Tests call ``LOCKDEP.reset()`` between cases.
LOCKDEP = _LockDep()


class LockdepLock:
    """Transparent proxy over a ``threading.Lock`` / ``RLock`` /
    ``Condition`` that feeds the acquisition-order graph; every other
    attribute delegates to the wrapped object."""

    def __init__(self, lock, name: str):
        self._lock = lock
        self._name = name

    def acquire(self, *args, **kwargs):
        LOCKDEP.note_acquire(self._name)   # raises before blocking
        ok = self._lock.acquire(*args, **kwargs)
        if not ok:                          # a non-blocking attempt failed
            LOCKDEP.note_release(self._name)
        return ok

    def release(self):
        self._lock.release()
        LOCKDEP.note_release(self._name)

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()
        return False

    def __getattr__(self, attr):
        return getattr(self._lock, attr)

    def __repr__(self):
        return f"LockdepLock({self._name}, {self._lock!r})"


def wrap_lock(lock, name: str):
    """Wrap a lock or condition for lockdep when sanitizing, else return it
    unchanged (no overhead in production)."""
    if sanitize_enabled():
        return LockdepLock(lock, name)
    return lock


def lockdep_task(fn, name: str = "pool-task"):
    """Wrap a thread-pool work item: entering or leaving it while holding
    any lockdep-tracked lock raises :class:`HeldLockError` (pool threads are
    recycled, so a carried lock deadlocks a *later*, unrelated item).
    Returns ``fn`` itself when not sanitizing."""
    if not sanitize_enabled():
        return fn

    def wrapped(*args, **kwargs):
        held = list(LOCKDEP.held())
        if held:
            raise HeldLockError(
                f"work item '{name}' entered while holding {held}: pool "
                f"work must start lock-free.\n{_stack()}")
        result = fn(*args, **kwargs)
        leaked = list(LOCKDEP.held())
        if leaked:
            raise HeldLockError(
                f"work item '{name}' returned while still holding {leaked}: "
                f"a recycled pool thread would deadlock the next item.\n"
                f"{_stack()}")
        return result

    return wrapped


class ThreadAffinity:
    """First-touch thread ownership: under ``REPRO_SANITIZE=1`` each
    :meth:`check` binds the structure to the first touching thread and
    raises :class:`ThreadOwnershipError` (with the binding stack and the
    foreign stack) on a touch from another thread. A no-op otherwise."""

    def __init__(self, label: str):
        self._label = label
        self._owner = None
        self._bind_stack = None
        self._bind_op = None

    def check(self, op: str) -> None:
        if not sanitize_enabled():
            return
        me = threading.current_thread()
        if self._owner is None:
            self._owner, self._bind_op = me, op
            self._bind_stack = _stack()
            return
        if me is not self._owner:
            raise ThreadOwnershipError(
                f"{self._label}.{op} called from thread '{me.name}' but the "
                f"structure is bound to '{self._owner.name}' (first touch: "
                f"{self._bind_op}). It is lock-free by contract: exactly one "
                "thread may drive it; hand off through a queue instead. "
                f"Binding stack:\n{self._bind_stack}\nForeign touch stack:\n{_stack()}")

    def rebind(self) -> None:
        """Release ownership (intentional handoff between threads)."""
        self._owner = None
        self._bind_stack = None
        self._bind_op = None
