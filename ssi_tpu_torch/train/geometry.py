"""Training geometry: derived constants from dataset size and accumulation —
the port's copy of ``ssi_tpu/train/geometry.py`` (``tests/test_torch_train_data.py``
holds it equal).

Same arithmetic as the reference (ref: ssi/trainer.py:64-125); pure and
test-covered so resume position math is provably consistent.
"""

from __future__ import annotations

from dataclasses import dataclass
import logging
import math
from typing import Any

LOGGER = logging.getLogger(__name__)


@dataclass(frozen=True)
class TrainingGeometry:
    """Derived constants that depend on dataset size and gradient accumulation.

    Args:
        batch_size: Per-process micro-batch size.
        batches_per_epoch: Micro-batches per epoch (``len(loader)``).
        steps_per_epoch: Optimizer steps per epoch.
        usable_batches: Micro-batches consumed per epoch (remainder discarded).
        n_epochs: Epochs needed to reach ``max_steps``.
        gradient_accumulation_steps: Micro-batches per optimizer step.
        world_size: Number of data-parallel processes.
    """

    batch_size: int
    batches_per_epoch: int
    steps_per_epoch: int
    usable_batches: int
    n_epochs: int
    gradient_accumulation_steps: int
    world_size: int

    @classmethod
    def from_config(cls, cfg: Any, dataloader: Any, world_size: int) -> "TrainingGeometry":
        batch_size = cfg.data.train.dataloader.batch_size
        batches_per_epoch = len(dataloader)
        gradient_accumulation_steps = cfg.gradient_accumulation_steps

        remainder_batches = batches_per_epoch % gradient_accumulation_steps
        if remainder_batches > 0:
            LOGGER.warning(
                f"batches_per_epoch ({batches_per_epoch}) is not divisible by "
                f"gradient_accumulation_steps ({gradient_accumulation_steps}): "
                f"{remainder_batches} remainder batches will be discarded at each epoch boundary."
            )

        steps_per_epoch = batches_per_epoch // gradient_accumulation_steps
        if steps_per_epoch <= 0:
            raise ValueError(
                f"batches_per_epoch ({batches_per_epoch}) < gradient_accumulation_steps ({gradient_accumulation_steps})"
            )

        usable_batches = steps_per_epoch * gradient_accumulation_steps
        n_epochs = math.ceil(cfg.max_steps / steps_per_epoch)

        return cls(
            batch_size=batch_size,
            batches_per_epoch=batches_per_epoch,
            steps_per_epoch=steps_per_epoch,
            usable_batches=usable_batches,
            n_epochs=n_epochs,
            gradient_accumulation_steps=gradient_accumulation_steps,
            world_size=world_size,
        )
