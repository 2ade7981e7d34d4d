"""Slot-based serving loops (port of ``repro/serve/engine.py``).

Two engines share one execution model: a fixed pool of ``batch_slots``
slots served one wave at a time, with the submit/poll bookkeeping of
:class:`SlotQueue`.

* :class:`ServeEngine` -- batched LM decode: the wave's prompts are
  prefilled together (right-padded to the longest), then decoded one token
  per step until ``max_new_tokens`` or every row's ``eos_token``.
* :class:`KnnServeEngine` -- batched exact kNN over a
  :class:`repro_torch.core.engine.QueryEngine`: queued queries are served
  in waves of ``batch_slots``, each padded to the slot count so every wave
  hits the engine's plan cache.

Known behaviour kept from the reference: the model state after a ragged
wave's prefill has also run over the pad tokens, so for a recurrent model a
shorter prompt's tokens after the first differ from its solo run
(``ROADMAP.md`` section 3). Equal-length waves are unaffected.
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

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
        self._served = 0
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
        self._served += 1

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

    def submit(self, prompt: np.ndarray, extras: dict | None = None) -> int:
        """Queue a 1-D prompt of token ids, with ``extras`` the request's
        other model inputs, each without the batch axis (a vlm's
        ``patch_embeds`` (P, d_patch), an audio model's ``frames``
        (num_frames, d_model)); returns its request id. A wave takes the
        extras' keys from its first request and stacks each over the wave
        on the engine's device."""
        return self._enqueue({"prompt": np.asarray(prompt), "extras": extras or {}})

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
        for k in requests[0]["extras"]:
            batch[k] = torch.stack([torch.as_tensor(r["extras"][k], device=self.device)
                                    for r in requests])
        cache = self.model.init_cache(self.cfg, b, self.scfg.max_seq, self.device)
        return self.model.prefill(self.params, batch, self.cfg, cache)

    @torch.no_grad()
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


# ---------------------------------------------------------------------------
# kNN query serving
# ---------------------------------------------------------------------------

class QueueFull(RuntimeError):
    """Admission control rejected a ``submit``: the pending queue is at
    ``KnnServeConfig.max_queue``. The backpressure signal: serve a wave
    (``step``) or drain before submitting again."""


def _opt_int(name: str, val, lo: int = 1) -> None:
    if val is not None and (not isinstance(val, int) or isinstance(val, bool)
                            or val < lo):
        raise ValueError(f"{name}={val!r}; expected None or an int >= {lo}")


@dataclasses.dataclass(frozen=True)
class KnnServeConfig:
    batch_slots: int = 32          # queries per wave (the slot pool)
    k: int | None = None           # None -> the backend's configured k
    wave: bool = False             # serve waves through the fused wave plan
    max_queue: int | None = None   # admission bound; None = unbounded
    pack: str = "fifo"             # wave packing: "fifo" | "difficulty"

    def __post_init__(self):
        if (not isinstance(self.batch_slots, int) or isinstance(self.batch_slots, bool)
                or self.batch_slots < 1):
            raise ValueError(f"batch_slots={self.batch_slots!r}; expected an int >= 1")
        _opt_int("k", self.k)
        if not isinstance(self.wave, bool):
            raise ValueError(f"wave={self.wave!r}; expected a bool")
        _opt_int("max_queue", self.max_queue)
        if self.pack not in ("fifo", "difficulty"):
            raise ValueError(f"pack={self.pack!r}; expected 'fifo' or 'difficulty'")


class KnnAnswer(NamedTuple):
    dists: np.ndarray              # (k,) squared ED, ascending
    ids: np.ndarray                # (k,) series ids
    path: int                      # access path taken (-1 when unknown)


class KnnFailure(NamedTuple):
    """A claimable per-request failure (``poll``/``drain`` hand it out like
    an answer): the request was invalid or the engine rejected it, and the
    rest of its wave was served normally."""
    error: str                     # "ExceptionType: message"


class KnnServeEngine(SlotQueue):
    """Continuous-batching front end for a :class:`QueryEngine`.

    ``submit`` queues one query series and returns a request id; ``step``
    serves one wave of up to ``batch_slots`` *compatible* queued queries
    through the engine (padded to the slot count, so a serving session
    builds one plan per (k, slot count)); ``drain`` steps until the queue
    is empty and returns every completed answer.

    Mixed traffic: requests are grouped into compatible sub-waves by their
    ``(k, overrides)`` signature; the head request's signature selects each
    wave, so interleaved k=1/k=10 submits are served in submission order,
    one signature per step. A request that still fails alone (wrong series
    length, bad override) completes as a claimable :class:`KnnFailure` and
    never blocks the traffic behind it.

    :class:`KnnServeConfig`: ``wave=True`` serves each wave through the
    engine's wave plan (shared descent, BSF matrix and disk fetches);
    ``max_queue`` bounds the pending queue, rejecting further submits with
    :class:`QueueFull`; ``pack="difficulty"`` fills each wave with the
    compatible peers closest in predicted cost to the oldest request
    (``QueryEngine.estimate_difficulty``), so cheap queries are not
    latency-coupled to expensive wave-mates, while the oldest request
    always ships first (no starvation).
    """

    def __init__(self, engine, cfg: KnnServeConfig | None = None):
        super().__init__()
        self.engine = engine
        self.cfg = cfg or KnnServeConfig()
        self._rejected = 0
        self._failed = 0
        self._waves = 0
        self._scored = 0
        self._score_sum = 0.0

    def submit(self, query, k: int | None = None, **overrides: Any) -> int:
        q = np.asarray(query)
        if q.ndim != 1:
            raise ValueError(f"submit() takes one query series, got {q.shape}")
        if self.cfg.max_queue is not None and len(self._queue) >= self.cfg.max_queue:
            self._rejected += 1
            raise QueueFull(f"pending queue at max_queue={self.cfg.max_queue}; "
                            "step() or drain() first")
        return self._enqueue({"q": q, "k": k, "ov": overrides, "score": None})

    @staticmethod
    def _sig(r: dict) -> tuple:
        """Compatibility signature: requests sharing it can ride one wave
        (one plan, one SearchConfig)."""
        return (r["k"], tuple(sorted(r["ov"].items())))

    def _score(self, reqs: list[dict]) -> None:
        """Attach a predicted-cost score to each unscored request (kept on
        the payload: a request is scored at most once)."""
        todo = [r for r in reqs if r["score"] is None]
        if not todo:
            return
        try:
            scores = self.engine.estimate_difficulty(np.stack([r["q"] for r in todo]))
        except Exception:   # ragged or invalid queries surface at serve time
            scores = None
        if scores is None:
            for r in todo:
                r["score"] = 0.0
            return
        for r, sc in zip(todo, np.asarray(scores)):
            r["score"] = float(sc)
            self._score_sum += float(sc)
            self._scored += 1

    def _next_wave(self) -> list[dict]:
        """Up to ``batch_slots`` compatible requests. The head (oldest)
        request's signature selects the sub-wave; with ``pack="difficulty"``
        it is joined by the compatible peers closest to its predicted cost
        instead of in FIFO order."""
        if not self._queue:
            return []
        head = self._queue[0]
        sig = self._sig(head)
        compat = [r for r in self._queue if self._sig(r) == sig]
        if self.cfg.pack == "difficulty" and len(compat) > self.cfg.batch_slots:
            self._score(compat)
            peers = sorted(compat[1:], key=lambda r: abs(r["score"] - head["score"]))
            wave = [head] + peers[:self.cfg.batch_slots - 1]
        else:
            wave = compat[:self.cfg.batch_slots]
        taken = {id(r) for r in wave}
        self._queue = [r for r in self._queue if id(r) not in taken]
        return wave

    def step(self) -> int:
        """Serve one compatible sub-wave; returns the number of requests
        completed (failures included, each as a claimable
        :class:`KnnFailure`). Every selected request leaves the queue with
        a result, so this never livelocks."""
        wave = self._next_wave()
        if not wave:
            return 0
        try:
            self._serve(wave)
        except Exception:
            # head-of-line isolation: one bad request must not poison its
            # wave-mates; serve each member alone, completing the ones that
            # still fail as failures
            for r in wave:
                try:
                    self._serve([r])
                except Exception as e:
                    self._failed += 1
                    self._complete(r["id"], KnnFailure(f"{type(e).__name__}: {e}"))
        self._waves += 1
        return len(wave)

    def _serve(self, wave: list[dict]) -> None:
        slots = self.cfg.batch_slots
        k = wave[0]["k"] if wave[0]["k"] is not None else self.cfg.k
        q = np.stack([r["q"] for r in wave])
        if len(wave) < slots:  # pad the partial wave to the slot pool
            q = np.concatenate([q, np.zeros((slots - len(wave), q.shape[1]), q.dtype)])
        res = self.engine.knn(q, k=k, valid_rows=len(wave), wave=self.cfg.wave,
                              **wave[0]["ov"])
        dists, ids = res.dists.cpu().numpy(), res.ids.cpu().numpy()
        paths = res.path.cpu().numpy()
        for i, r in enumerate(wave):
            self._complete(r["id"], KnnAnswer(dists=dists[i], ids=ids[i],
                                              path=int(paths[i])))

    def drain(self) -> dict[int, KnnAnswer | KnnFailure]:
        """Serve until the queue is empty; returns (and claims) every
        unclaimed completed answer (failed requests as KnnFailure)."""
        while self.step():
            pass
        return self._collect()

    def telemetry(self):
        """The engine's :class:`repro_torch.core.engine.Telemetry` with its
        ``serving`` section filled in."""
        t = self.engine.telemetry()
        t.serving = {"pending": self.pending(),
                     "served": self._served,
                     "unclaimed": len(self._results),
                     "batch_slots": self.cfg.batch_slots,
                     "waves": self._waves,
                     "wave_mode": self.cfg.wave,
                     "pack": self.cfg.pack,
                     "max_queue": self.cfg.max_queue,
                     "rejected": self._rejected,
                     "failed": self._failed,
                     "difficulty_scored": self._scored,
                     "difficulty_mean": self._score_sum / max(self._scored, 1)}
        return t
