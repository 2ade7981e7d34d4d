"""The load: a closed loop of clients that submit queries to a
``KnnServeEngine`` and wait.

Each of the traffic mix's ``clients`` sends its next query once its
previous answer is back, as a retrieval pipeline that waits on its answers
does. Queries come from the cell's pool in the pool's order, wrapping
around.

One thread drives the engine, as its contract asks. Every request is
recorded with the phases it was submitted and answered in, its pool entry,
its k, its latency (submit to the answer on the host) and the answer.
"""
from __future__ import annotations

import time

import numpy as np


class Load:
    def __init__(self, serve, pool: np.ndarray, ks: np.ndarray, traffic: dict,
                 clock=time.perf_counter):
        self.serve = serve
        self.pool = pool
        self.ks = ks
        self.clients = traffic["clients"]
        self.clock = clock
        self.cursor = 0
        self.phase = "window"
        self.closed = False
        self.outstanding: dict[int, tuple[int, float, str]] = {}
        # (phase submitted, phase answered, pool entry, k, latency s, answer)
        self.records: list[tuple[str, str, int, int, float, object]] = []

    def _submit(self, t: float) -> None:
        p = self.cursor % len(self.pool)
        self.cursor += 1
        rid = self.serve.submit(self.pool[p], k=int(self.ks[p]))
        self.outstanding[rid] = (p, t, self.phase)

    def start(self) -> None:
        now = self.clock()
        for _ in range(self.clients):
            self._submit(now)

    def step(self) -> int:
        """Serve one wave; record what came back, and let each client whose
        answer came back send its next query. Returns answers claimed."""
        self.serve.step()
        now = self.clock()
        got = 0
        for rid in list(self.outstanding):
            ans = self.serve.poll(rid)
            if ans is None:
                continue
            p, t, phase = self.outstanding.pop(rid)
            self.records.append((phase, self.phase, p, int(self.ks[p]), now - t, ans))
            got += 1
            if not self.closed:
                self._submit(now)
        return got

    def run_until(self, deadline: float) -> float:
        """Serve until the first wave that ends at or past ``deadline``;
        returns when that wave ended."""
        while True:
            self.step()
            now = self.clock()
            if now >= deadline:
                return now

    def drain(self) -> None:
        """Stop submitting; serve every outstanding request."""
        self.closed = True
        while self.outstanding:
            if self.step() == 0 and not self.serve.pending():
                break

    def answered_in(self, phase: str) -> int:
        """Answers that came back during ``phase``."""
        return sum(1 for r in self.records if r[1] == phase)

    def latencies(self, phase: str) -> list[float]:
        """Latencies of the requests submitted during ``phase``."""
        return [r[4] for r in self.records if r[0] == phase]

    @property
    def attempted(self) -> int:
        return self.cursor
