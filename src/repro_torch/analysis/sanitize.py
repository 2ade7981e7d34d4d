"""Thread-ownership check for single-owner structures, under
``REPRO_SANITIZE=1`` (a copy of ``ThreadAffinity`` from
``repro/analysis/sanitize.py``).
"""
from __future__ import annotations

import os
import threading
import traceback

ENV_VAR = "REPRO_SANITIZE"


def sanitize_enabled() -> bool:
    """True when ``REPRO_SANITIZE`` is set to anything but '' / '0'."""
    return os.environ.get(ENV_VAR, "") not in ("", "0")


class ThreadOwnershipError(RuntimeError):
    """A single-owner structure (``SlotQueue``) was touched from a thread
    other than the one it is bound to."""


def _stack(skip: int = 2) -> str:
    return "".join(traceback.format_stack()[:-skip])


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
