"""Fault-tolerant step loop: run → fail → restore → resume, the port of
``repro/runtime/supervisor.py``.

The Supervisor drives a train step over a step-keyed loader and restarts
from the last published checkpoint on any exception, up to
``max_failures``; a ``FailureInjector`` makes the path testable.

The reference's state is immutable, so a failure leaves its last state
intact. The port's step updates the model's parameters and the
optimizer's state in place, so a failure raised partway through an update
leaves them half-updated; every start and restart therefore writes the
latest checkpoint back into the live state in place (every leaf, one at a
time through host memory), or, when there is none, makes the state afresh
with ``init_state`` (which re-draws the parameters, or carries them in
again). It never resumes from what the live state holds. Saves go through
the ``CheckpointManager``'s host snapshot, taken before ``save`` returns,
so later in-place updates cannot touch a save in flight. With the step-keyed
loader and deterministic kernels, a restarted run ends on the same bits as
an uninterrupted one.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.checkpoint.manager import (ARRAYS_FILE, CheckpointManager,
                                            _flatten, read_meta)
from repro_torch.runtime.straggler import StragglerWatchdog
from repro_torch.utils import get_logger

log = get_logger("repro_torch.supervisor")


class FailureInjector:
    """Raises RuntimeError at the configured global steps (once each)."""

    def __init__(self, fail_at_steps=()):
        self.fail_at = set(fail_at_steps)

    def maybe_fail(self, step: int) -> None:
        if step in self.fail_at:
            self.fail_at.discard(step)
            raise RuntimeError(f"injected failure at step {step}")


@torch.no_grad()
def restore_in_place(ckpt: CheckpointManager, state: dict) -> Optional[int]:
    """The latest checkpoint of ``ckpt`` written into ``state``'s tensors
    in place (each cast to its leaf's type and device), one leaf at a time;
    returns its step, or None when there is none. A leaf the checkpoint
    lacks raises ``KeyError``, a shape that differs ``ValueError``."""
    ckpt.wait()
    step = ckpt.latest_step()
    if step is None:
        return None
    path = ckpt._step_dir(step)
    with np.load(os.path.join(path, ARRAYS_FILE)) as data:
        for key, live in _flatten(state).items():
            if key not in data.files:
                raise KeyError(f"checkpoint missing {key!r}")
            arr = data[key]
            if tuple(arr.shape) != tuple(live.shape):
                raise ValueError(f"checkpoint {key!r} has shape {arr.shape}, "
                                 f"the state {tuple(live.shape)}")
            live.copy_(torch.from_numpy(arr))
    return int(read_meta(path)["step"])


@dataclasses.dataclass
class Supervisor:
    ckpt: CheckpointManager
    train_step: Callable            # (state, batch) -> (state, metrics)
    loader: Callable                # step -> batch
    init_state: Callable            # () -> fresh state (parameters in place)
    ckpt_every: int = 50
    max_failures: int = 8
    injector: Optional[FailureInjector] = None
    # (ckpt, live state) -> (state, the checkpoint's step or None): how the
    # latest checkpoint comes back (default: into the live state in place;
    # over a mesh ``runtime.elastic.restore_sharded`` into each rank's shards)
    restore: Optional[Callable] = None
    # (ckpt, step, state): how a checkpoint is written (default
    # ``ckpt.save``; over a mesh ``runtime.elastic.save_sharded``)
    save: Optional[Callable] = None

    def _start(self, state: Optional[dict]):
        """(state, first step): the latest checkpoint restored into the live
        state (made with ``init_state`` when there is none yet), or a
        fresh state from step 0."""
        if state is None or self.ckpt.latest_step() is None:
            state = self.init_state()
        if self.restore is None:
            step = restore_in_place(self.ckpt, state)
        else:
            state, step = self.restore(self.ckpt, state)
        if step is None:
            log.info("fresh start")
            return state, 0
        log.info("resumed from step %d", step)
        return state, step + 1

    def run(self, total_steps: int, *, on_metrics=None) -> dict:
        failures = 0
        watchdog = StragglerWatchdog()
        state = None
        while True:
            try:
                state, start = self._start(state)
                for step in range(start, total_steps):
                    if self.injector:
                        self.injector.maybe_fail(step)
                    watchdog.start()
                    batch = self.loader(step)
                    state, metrics = self.train_step(state, batch)
                    if on_metrics is not None:
                        on_metrics(step, metrics)
                    watchdog.stop(step)
                    if ((step + 1) % self.ckpt_every == 0
                            or step == total_steps - 1):
                        if self.save is None:
                            self.ckpt.save(step, state)
                        else:
                            self.save(self.ckpt, step, state)
                self.ckpt.wait()
                return state
            except KeyboardInterrupt:
                raise
            except Exception as e:  # noqa: BLE001 — restartable failure domain
                failures += 1
                log.warning("step loop failed (%s); restart %d/%d",
                            e, failures, self.max_failures)
                if failures > self.max_failures:
                    raise
