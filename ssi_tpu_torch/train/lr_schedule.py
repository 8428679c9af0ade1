"""Learning-rate schedules as ``step -> lr`` functions: port of
``ssi_tpu/train/lr_schedule.py``.

The update producing global step N+1 uses ``schedule(N)``, fresh start or
resume alike. The arithmetic runs in float32 torch scalars, as the JAX
schedules run in float32 inside the jitted step, and each schedule returns a
Python float. ``setup_lr_schedule`` (from the training config) waits for the
config port.
"""

from __future__ import annotations

import math
from typing import Callable

import torch

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
