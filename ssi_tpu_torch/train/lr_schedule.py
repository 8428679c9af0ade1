"""Learning-rate schedules as ``step -> lr`` functions: port of
``ssi_tpu/train/lr_schedule.py``.

The update producing global step N+1 uses ``schedule(N)``, fresh start or
resume alike. The arithmetic runs in float32 torch scalars, as the JAX
schedules run in float32 inside the jitted step, and each schedule returns a
Python float. ``setup_lr_schedule`` builds one from the training config.
"""

from __future__ import annotations

import logging
import math
from typing import Any, Callable

import torch

LOGGER = logging.getLogger(__name__)

Schedule = Callable[[int], float]


def _f32(x) -> torch.Tensor:
    return torch.tensor(float(x), dtype=torch.float32)


def constant_schedule(base_lr: float) -> Schedule:
    def schedule(step: int) -> float:
        del step
        return base_lr

    return schedule


def cosine_schedule_with_warmup(
    base_lr: float,
    num_warmup_steps: int,
    num_training_steps: int,
    num_cycles: float = 0.5,
) -> Schedule:
    """Linear warmup then cosine decay (torchtune get_cosine_schedule_with_warmup)."""

    def schedule(step: int) -> float:
        step = _f32(step)
        warmup_factor = step / max(1, num_warmup_steps)
        progress = (step - num_warmup_steps) / max(1, num_training_steps - num_warmup_steps)
        cosine_factor = torch.clamp(0.5 * (1.0 + torch.cos(math.pi * num_cycles * 2.0 * progress)), min=0.0)
        return float(base_lr * torch.where(step < num_warmup_steps, warmup_factor, cosine_factor))

    return schedule


def wsd_schedule(
    base_lr: float,
    num_warmup_steps: int,
    num_training_steps: int,
    decay_fraction: float = 0.1,
    min_lr_ratio: float = 0.0,
) -> Schedule:
    """Warmup-Stable-Decay: linear warmup, flat plateau, linear decay tail."""
    decay_steps = max(1, int(num_training_steps * decay_fraction))
    decay_start = num_training_steps - decay_steps

    def schedule(step: int) -> float:
        step = _f32(step)
        warmup_factor = step / max(1, num_warmup_steps)
        decay_progress = torch.clamp((step - decay_start) / decay_steps, 0.0, 1.0)
        decay_factor = 1.0 - (1.0 - min_lr_ratio) * decay_progress
        return float(base_lr * torch.where(step < num_warmup_steps, warmup_factor, decay_factor))

    return schedule


def setup_lr_schedule(cfg: Any, num_training_steps: int) -> Schedule:
    """Build the schedule from config (ref: ssi/lr_schedule.py:12-33 semantics).

    ``cfg.lr_scheduler is None`` -> constant lr (the reference's "no scheduler").
    ``lr_scheduler.type``: ``cosine`` (default) | ``wsd``.
    """
    base_lr = float(cfg.optimizer.lr)
    if cfg.get("lr_scheduler") is None:
        LOGGER.info("No learning rate scheduler configured. Using constant learning rate.")
        return constant_schedule(base_lr)
    kind = cfg.lr_scheduler.get("type", "cosine")
    if kind == "wsd":
        return wsd_schedule(
            base_lr,
            num_warmup_steps=int(cfg.lr_scheduler.num_warmup_steps),
            num_training_steps=int(num_training_steps),
            decay_fraction=float(cfg.lr_scheduler.get("decay_fraction", 0.1)),
            min_lr_ratio=float(cfg.lr_scheduler.get("min_lr_ratio", 0.0)),
        )
    if kind != "cosine":
        raise ValueError(f"Unknown lr_scheduler.type: {kind!r} (expected cosine | wsd)")
    return cosine_schedule_with_warmup(
        base_lr,
        num_warmup_steps=int(cfg.lr_scheduler.num_warmup_steps),
        num_training_steps=int(num_training_steps),
        num_cycles=float(cfg.lr_scheduler.get("num_cycles", 0.5)),
    )
