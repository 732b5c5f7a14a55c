"""Training loop with checkpoint / restart and deterministic resume (port
of ``repro.train.trainer``).

The data pipeline is step-keyed: ``batch_fn(step)`` is a function of the
step alone, so a run resumed from the checkpoint of step k replays exactly
the batches an uninterrupted run sees, and lands on its parameters bit for
bit. Metrics are read to the host only at ``log_every`` steps.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Optional

from repro_torch.ckpt.checkpoint import (AsyncCheckpointer,
                                         latest_checkpoint,
                                         restore_checkpoint, save_checkpoint)


@dataclasses.dataclass
class TrainerConfig:
    total_steps: int = 100
    ckpt_every: int = 20
    ckpt_dir: Optional[str] = None
    log_every: int = 10
    async_ckpt: bool = True


class Trainer:
    def __init__(self, step_fn: Callable, batch_fn: Callable[[int], Any],
                 init_state: Any, cfg: TrainerConfig):
        """step_fn(state, batch) -> (state, metrics); batch_fn(step) ->
        batch."""
        self.step_fn = step_fn
        self.batch_fn = batch_fn
        self.state = init_state
        self.cfg = cfg
        self.start_step = 0
        self.metrics_log: list = []
        self.ckpt = (AsyncCheckpointer(cfg.ckpt_dir)
                     if cfg.ckpt_dir and cfg.async_ckpt else None)

    def maybe_restore(self):
        if not self.cfg.ckpt_dir:
            return
        found = latest_checkpoint(self.cfg.ckpt_dir)
        if found:
            step, path = found
            self.state, _ = restore_checkpoint(path, self.state)
            self.start_step = step
            print(f"[trainer] resumed from {path} (step {step})")

    def _save(self, step: int):
        if not self.cfg.ckpt_dir:
            return
        if self.ckpt:
            self.ckpt.save(step, self.state)
        else:
            save_checkpoint(self.cfg.ckpt_dir, step, self.state)

    def run(self, guard: Optional[Callable[[int], None]] = None) -> Any:
        t0 = time.time()
        for step in range(self.start_step, self.cfg.total_steps):
            if guard is not None:
                guard(step)
            batch = self.batch_fn(step)
            self.state, metrics = self.step_fn(self.state, batch)
            if (step + 1) % self.cfg.log_every == 0:
                m = {k: float(v) for k, v in metrics.items()}
                m["step"] = step + 1
                m["sec"] = time.time() - t0
                self.metrics_log.append(m)
                print(f"[trainer] step {step + 1}: " +
                      " ".join(f"{k}={v:.4g}" for k, v in m.items()
                               if k != "step"))
            if (step + 1) % self.cfg.ckpt_every == 0:
                self._save(step + 1)
        if self.ckpt:
            self.ckpt.wait()
        return self.state
