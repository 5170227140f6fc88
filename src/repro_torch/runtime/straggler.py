"""Straggler detection: the port of ``repro/runtime/straggler.py``.

Per-step wall-clock tracking over a rolling window, flagging a step slower
than ``p95_factor`` times the window's median once the window holds 10
steps, and a pluggable policy callback. The clock is injectable, so a test
holds it."""
from __future__ import annotations

import collections
import time
from typing import Callable, Optional

from repro_torch.utils import get_logger

log = get_logger("repro_torch.straggler")


class StragglerWatchdog:
    def __init__(self, *, window: int = 50, p95_factor: float = 2.0,
                 on_straggle: Optional[Callable[[int, float, float],
                                                None]] = None,
                 clock: Callable[[], float] = time.perf_counter):
        self.times = collections.deque(maxlen=window)
        self.p95_factor = p95_factor
        self.on_straggle = on_straggle
        self.clock = clock
        self._t0 = None
        self.flagged = []

    def start(self) -> None:
        self._t0 = self.clock()

    def stop(self, step: int) -> float:
        dt = self.clock() - self._t0
        if len(self.times) >= 10:
            srt = sorted(self.times)
            p50 = srt[len(srt) // 2]
            if dt > self.p95_factor * p50:
                self.flagged.append((step, dt, p50))
                log.warning("straggler step=%d dt=%.3fs p50=%.3fs", step, dt,
                            p50)
                if self.on_straggle:
                    self.on_straggle(step, dt, p50)
        self.times.append(dt)
        return dt
