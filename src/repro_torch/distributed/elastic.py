"""Elastic scaling + failure handling for long-running jobs (the JAX
package's ``distributed/elastic.py``).

* **Checkpoint/restart** — training saves every N steps (atomic, pruned);
  on restart the launcher restores the latest step and the data pipeline
  resumes deterministically from it (data.py is stateless-per-step).  The
  state to restore into is built on the meta device (the JAX
  ``jax.eval_shape``), so a resume draws no parameters it then discards.
* **Re-placement** — ``build_device`` is called on every (re)start, and the
  checkpoint is restored onto the device it returns; the launcher then
  places the whole tensors on its mesh (``launch.train``).
* **Straggler detection** — the launcher reports each step time; a streak
  of ``patience`` steps slower than ``straggler_factor`` x the median says
  that a re-placement should be triggered.
"""
from __future__ import annotations

import dataclasses
import os
import tempfile
from typing import Callable, Optional

import torch

from repro_torch.training import checkpoint as ckpt


@dataclasses.dataclass
class ElasticConfig:
    ckpt_dir: str = os.path.join(tempfile.gettempdir(), "repro_ckpt")
    save_every: int = 50
    keep: int = 3
    straggler_factor: float = 2.0
    patience: int = 5


class ElasticRunner:
    """Wraps a train loop with checkpoint/restart and straggler detection."""

    def __init__(self, cfg: ElasticConfig, build_device: Callable[[], torch.device],
                 build_step: Callable[[torch.device], Callable]):
        self.cfg = cfg
        self.build_device = build_device
        self.build_step = build_step
        self._slow_streak = 0

    def resume_or_init(self, init_fn: Callable[[torch.device], dict]):
        """Returns (device, step_fn, state, start): ``init_fn(device)`` on a
        fresh start, else the latest checkpoint restored onto the device
        with ``init_fn(meta)`` as its tree; ``start`` is its step."""
        device = self.build_device()
        step_fn = self.build_step(device)
        last = ckpt.latest_step(self.cfg.ckpt_dir)
        if last is None:
            return device, step_fn, init_fn(device), 0
        like = init_fn(torch.device("meta"))
        start, state, _ = ckpt.restore_checkpoint(self.cfg.ckpt_dir, last, like=like,
                                                  device=device)
        return device, step_fn, state, start

    def maybe_save(self, step: int, state) -> Optional[str]:
        if step % self.cfg.save_every == 0 and step > 0:
            return ckpt.save_checkpoint(self.cfg.ckpt_dir, step, state,
                                        keep=self.cfg.keep)
        return None

    def observe_step_time(self, dt: float, median_dt: float) -> bool:
        """Returns True when a re-placement should be triggered (straggler)."""
        if median_dt > 0 and dt > self.cfg.straggler_factor * median_dt:
            self._slow_streak += 1
        else:
            self._slow_streak = 0
        return self._slow_streak >= self.cfg.patience
