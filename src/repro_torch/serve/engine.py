"""Slot-based batch serving of a language model (``repro/serve/engine.py``,
the LM half: ``SlotQueue``, ``ServeConfig``, ``greedy_sample``,
``ServeEngine``).

A fixed pool of ``batch_slots`` slots is served one wave at a time: the
wave's prompts are prefilled together (right-padded to the longest), then
decoded one token per step until ``max_new_tokens`` or every row's
``eos_token``. The kNN server of the reference (``KnnServeEngine``) is not
ported yet (``ROADMAP.md``).

Known behaviour kept from the reference: the model state after a ragged
wave's prefill has also run over the pad tokens, so for a recurrent model a
shorter prompt's tokens after the first differ from its solo run
(``ROADMAP.md`` section 3). Equal-length waves are unaffected.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from repro_torch.analysis.sanitize import ThreadAffinity
from repro_torch.device import resolve_device
from repro_torch.models import ModelDef
from repro_torch.models.arch import ArchConfig


class SlotQueue:
    """Request bookkeeping: monotonically increasing request ids, a FIFO of
    pending payloads, a result map.

    Results are *claimed*: ``poll``/``run`` hand each answer out exactly
    once and drop it from the engine, so a long serving session does not
    accumulate its answer history.

    The queue is lock-free **by contract**: exactly one thread drives it.
    Under ``REPRO_SANITIZE=1`` the contract is enforced: the queue binds to
    the first touching thread and a foreign touch raises
    ``ThreadOwnershipError``. Use :meth:`rebind_owner` for a handoff.
    """

    def __init__(self):
        self._queue: list[dict] = []
        self._results: dict[int, Any] = {}
        self._next_id = 0
        self._affinity = ThreadAffinity(type(self).__name__)

    def rebind_owner(self) -> None:
        """Hand the queue to another thread (the next touch binds it)."""
        self._affinity.rebind()

    def _enqueue(self, payload: dict) -> int:
        self._affinity.check("_enqueue")
        rid = self._next_id
        self._next_id += 1
        payload["id"] = rid
        self._queue.append(payload)
        return rid

    def _take_wave(self, slots: int) -> list[dict]:
        self._affinity.check("_take_wave")
        wave, self._queue = self._queue[:slots], self._queue[slots:]
        return wave

    def _complete(self, rid: int, result) -> None:
        self._affinity.check("_complete")
        self._results[rid] = result

    def _collect(self) -> dict[int, Any]:
        self._affinity.check("_collect")
        out, self._results = self._results, {}
        return out

    def pending(self) -> int:
        """Requests submitted but not yet answered."""
        return len(self._queue)

    def poll(self, rid: int):
        """Claim the result for ``rid``: returns it once, then None (also
        None while the request is still queued)."""
        self._affinity.check("poll")
        return self._results.pop(rid, None)


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    max_seq: int = 4096
    batch_slots: int = 8
    max_new_tokens: int = 64
    eos_token: int = -1            # -1: disabled
    temperature: float = 0.0       # 0 => greedy; the engine serves only greedy


def greedy_sample(logits: torch.Tensor, generator: torch.Generator | None = None,
                  temperature: float = 0.0) -> torch.Tensor:
    """Argmax over the last axis (ties: the lowest index); with
    ``temperature > 0``, a categorical draw from ``softmax(logits / T)``
    with ``generator``, which is then required."""
    if temperature and temperature > 0.0:
        if generator is None:
            raise ValueError("sampling at temperature > 0 needs a torch.Generator")
        probs = torch.softmax(logits.to(torch.float32) / temperature, dim=-1)
        flat = probs.reshape(-1, probs.shape[-1])
        return torch.multinomial(flat, 1, generator=generator).reshape(logits.shape[:-1])
    return torch.argmax(logits, dim=-1)


def _device_of(params) -> torch.device:
    return next(iter(params.parameters())).device


class ServeEngine(SlotQueue):
    """Slot-based batch server over a ModelDef, on the device of ``params``."""

    def __init__(self, model: ModelDef, cfg: ArchConfig, params, scfg: ServeConfig):
        super().__init__()
        if scfg.temperature > 0.0:
            # the reference's run() calls its sampler without a PRNG key,
            # so it raises for temperature > 0 (ROADMAP.md section 3)
            raise ValueError(f"ServeConfig.temperature={scfg.temperature}: the "
                             "engine serves greedy decoding only (temperature 0)")
        self.model = model
        self.cfg = cfg
        self.params = params
        self.scfg = scfg
        self.device = resolve_device(_device_of(params))

    def submit(self, prompt: np.ndarray) -> int:
        """Queue a 1-D prompt of token ids; returns its request id. (The
        reference's ``extras``, the VLM and audio inputs, wait for those
        model families.)"""
        return self._enqueue({"prompt": np.asarray(prompt)})

    def _prefill_batch(self, requests: list[dict]):
        """Batched prefill over ragged prompts: shorter prompts are
        right-padded with token 0 to the batch max, and ``batch["lens"]``
        carries each real length so the model projects logits at position
        ``lens[i] - 1``, not at a pad slot."""
        b = len(requests)
        lens = np.array([r["prompt"].shape[0] for r in requests], np.int32)
        maxlen = int(lens.max())
        toks = np.zeros((b, maxlen), np.int32)
        for i, r in enumerate(requests):
            toks[i, :r["prompt"].shape[0]] = r["prompt"]
        batch = {"tokens": torch.from_numpy(toks).to(self.device)}
        if lens.min() != maxlen:
            batch["lens"] = torch.from_numpy(lens).to(self.device)
        cache = self.model.init_cache(self.cfg, b, self.scfg.max_seq, self.device)
        return self.model.prefill(self.params, batch, self.cfg, cache)

    def run(self) -> dict[int, list[int]]:
        """Drain the queue in waves of ``batch_slots``; returns {id: tokens}."""
        scfg = self.scfg
        while self._queue:
            wave = self._take_wave(scfg.batch_slots)
            logits, cache = self._prefill_batch(wave)
            # prefill projects each row's last real token, so logits[:, -1]
            # is the sampling column for every row
            tok = greedy_sample(logits[:, -1])
            out = [[t] for t in tok.tolist()]
            live = np.ones(len(wave), bool)
            for _ in range(scfg.max_new_tokens - 1):
                logits, cache = self.model.decode_step(
                    self.params, tok[:, None].to(torch.int32), self.cfg, cache)
                tok = greedy_sample(logits[:, 0])
                t_list = tok.tolist()
                for i in range(len(wave)):
                    if live[i]:
                        out[i].append(t_list[i])
                        if scfg.eos_token >= 0 and t_list[i] == scfg.eos_token:
                            live[i] = False
                if not live.any():
                    break
            for r, o in zip(wave, out):
                self._complete(r["id"], o)
        return self._collect()
