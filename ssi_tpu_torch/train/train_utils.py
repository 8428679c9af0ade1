"""Pure training utilities: config validation, resume schema, token accounting —
the port's copy of ``ssi_tpu/train/train_utils.py`` (``tests/test_torch_trainer.py``
holds it equal).

Behavioural rebuild of ref: ssi/train_utils.py:37-165 (numpy in place of torch).
The resume-state schema and hparam guard are contract-bound to the reference's
versioned checkpoint format (SURVEY §3.5); everything else is host-side glue.
"""

from __future__ import annotations

import logging
from typing import Any

import numpy as np

from ssi_tpu_torch.constants import (
    CHECKPOINT_VERSION,
    CHECKPOINT_VERSION_KEY,
    CONSUMED_SAMPLES_KEY,
    CUMULATIVE_METRICS_KEY,
    GLOBAL_STEP_KEY,
    LR_SCHEDULER_KEY,
    OPTIMIZER_KEY,
    RNG_KEY,
    SEED,
    SEED_KEY,
    SUPPORTED_DTYPES,
    TRAINING_HPARAMS_KEY,
)
from ssi_tpu_torch.models.configs import ConfigLlama3_2

LOGGER = logging.getLogger(__name__)

# Resume-state field -> schema key it is read from (schema v1, constants.py).
_RESUME_FIELDS = {
    "global_step": GLOBAL_STEP_KEY,
    "optimizer_state": OPTIMIZER_KEY,
    "lr_scheduler_state": LR_SCHEDULER_KEY,
    "rng_state": RNG_KEY,
    "training_hparams": TRAINING_HPARAMS_KEY,
    "consumed_samples": CONSUMED_SAMPLES_KEY,
    "cumulative_metrics": CUMULATIVE_METRICS_KEY,
}

# Hparams whose value pins the step->data-position mapping; changing any of
# them across a resume would silently shift which samples each step sees.
_POSITION_PINNING_HPARAMS = ("batch_size", "gradient_accumulation_steps", "world_size", "steps_per_epoch")

_REQUIRED_POSITIVE_FIELDS = ("gradient_accumulation_steps", "max_steps", "log_interval", "eval_steps", "save_steps")


def resolve_n_dsus(cfg: Any) -> None:
    """Copy ``data.n_dsus`` into ``speech.n_dsus`` unless set explicitly
    (ref: ssi/train_utils.py:37-59)."""
    if cfg.speech.n_dsus is not None:
        return  # an explicit speech.n_dsus= CLI value wins over the data group
    data_n_dsus = cfg.data.get("n_dsus") if cfg.get("data") is not None else None
    if data_n_dsus is None:
        raise ValueError(
            "Cannot determine speech.n_dsus: pass it on the CLI "
            "(speech.n_dsus=<codebook size>) or select a data config that carries n_dsus."
        )
    cfg.speech.n_dsus = data_n_dsus
    LOGGER.info(f"speech.n_dsus <- {data_n_dsus} (taken from the selected data config)")


def validate_train_cfg(cfg: Any) -> None:
    """Structural validation before any setup (ref: ssi/train_utils.py:62-81)."""
    from ssi_tpu_torch.config import missing_keys

    if cfg.speech.n_dsus is None:
        raise ValueError("speech.n_dsus unresolved — run resolve_n_dsus(cfg) before validating.")

    if cfg.dtype not in SUPPORTED_DTYPES:
        raise ValueError(f"dtype {cfg.dtype!r} is not supported; choose one of {SUPPORTED_DTYPES}")

    missing = missing_keys(cfg)
    if missing:
        raise ValueError(f"Config has unresolved mandatory ('???') keys: {missing}")

    for field in _REQUIRED_POSITIVE_FIELDS:
        if cfg.get(field, 0) <= 0:
            raise ValueError(f"{field} must be > 0 (got {cfg.get(field)!r})")

    if cfg.save_steps % cfg.eval_steps != 0:
        # checkpoints are cut at eval boundaries, so save must align with eval
        raise ValueError(f"save_steps={cfg.save_steps} is not a multiple of eval_steps={cfg.eval_steps}")


def resume_training_state(ckpt_dict: dict[str, Any]) -> dict[str, Any]:
    """Extract and validate resume state from the versioned training-state dict
    (ref: ssi/train_utils.py:84-107)."""
    if CHECKPOINT_VERSION_KEY not in ckpt_dict:
        raise ValueError(
            "Training state lacks a 'checkpoint_version' field and so predates the "
            "versioned schema; such checkpoints cannot be resumed — train from scratch."
        )
    found_version = ckpt_dict[CHECKPOINT_VERSION_KEY]
    if found_version != CHECKPOINT_VERSION:
        raise ValueError(
            f"Checkpoint version mismatch (found {found_version}, this build reads {CHECKPOINT_VERSION})."
        )
    if ckpt_dict[SEED_KEY] != SEED:
        raise ValueError(f"Seed mismatch: build constant {SEED} vs checkpoint {ckpt_dict[SEED_KEY]}")
    return {field: ckpt_dict[key] for field, key in _RESUME_FIELDS.items()}


def validate_resume_hparams(
    ckpt_hparams: dict[str, Any],
    current_hparams: dict[str, Any],
    force_resume: bool = False,
) -> None:
    """Refuse resumes that break the step-to-data-position mapping
    (ref: ssi/train_utils.py:110-126)."""
    for key in _POSITION_PINNING_HPARAMS:
        if key not in ckpt_hparams or ckpt_hparams[key] == current_hparams[key]:
            continue
        msg = (
            f"Training hparam mismatch on resume: {key!r} was {ckpt_hparams[key]} at save "
            f"time but is {current_hparams[key]} now — the step->data-position mapping no "
            f"longer holds."
        )
        if not force_resume:
            raise ValueError(msg)
        LOGGER.warning(msg + " Continuing anyway (force_resume).")


def get_token_type_ranges(llama_config: ConfigLlama3_2) -> dict[str, tuple[int, int]]:
    """Inclusive vocab-ID ranges per token type (ref: ssi/train_utils.py:129-147).

    Extended-vocab layout: [text | dsu | modality? | special_text].
    """
    base = llama_config.base_vocab_size_txt
    ranges: dict[str, tuple[int, int]] = {
        "text": (0, base - 1),
        "dsu": (base, base + llama_config.n_dsus - 1),
    }
    offset = base + llama_config.n_dsus
    if llama_config.modality_tokens:
        ranges["modality"] = (offset, offset + 1)
        offset += 2
    # the pad token (<|finetune_right_pad_id|>) lives inside special_text
    ranges["special_text"] = (offset, offset + llama_config.n_special_txt - 1)

    offset += llama_config.n_special_txt
    if offset != llama_config.vocab_size:
        raise ValueError(f"Token-type ranges sum to {offset} but vocab_size is {llama_config.vocab_size}")
    if "total" in ranges:
        raise AssertionError('"total" key reserved')
    return ranges


def count_token_types(tokens: np.ndarray, ranges: dict[str, tuple[int, int]], pad_idx: int) -> dict[str, int]:
    """Host-side token-type counts (ref: ssi/train_utils.py:150-165).

    Padding positions are excluded from every range (see
    :func:`ssi_tpu_torch.train.step.count_token_types_device`) so counts are
    padding-policy-invariant.
    """
    tokens = np.asarray(tokens)
    real = tokens != pad_idx
    counts = {
        token_type: int(((tokens >= lo) & (tokens <= hi) & real).sum()) for token_type, (lo, hi) in ranges.items()
    }
    counts["total"] = int(real.sum())
    return counts
