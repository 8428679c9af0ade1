"""HF-format checkpoint reading — the read half of
``ssi_tpu/checkpoint/__init__.py``, copied with the same checks and error
texts: ``discover_safetensor_files``, ``validate_checkpoint_dir``,
``check_outdir_not_in_ckptdir`` and ``Checkpointer``'s construction,
``load_hf_state_dict`` and ``load_params``. Shards are read by
``safetensors_io`` (zero-copy torch views of the mapped files).

Saving (``step_N/`` dirs, the schema-v1 training state) is not ported yet
(ROADMAP.md queue A, item A7); a ``training_state_checkpoint`` raises
``NotImplementedError``.
"""

from __future__ import annotations

import json
import logging
from pathlib import Path
from typing import Any

import torch

from ssi_tpu_torch.checkpoint.convert import hf_to_internal
from ssi_tpu_torch.checkpoint.safetensors_io import safe_open
from ssi_tpu_torch.constants import LLAMA_3_2_CONFIG_RELPATH
from ssi_tpu_torch.models.configs import ConfigLlama3_2, ModelCheckpointExpectations

LOGGER = logging.getLogger(__name__)

SAFETENSOR_INDEX_FNAME = "model.safetensors.index.json"


# ---------------------------------------------------------------------------
# Discovery and validation (ref: ssi/checkpoint.py:53-186)
# ---------------------------------------------------------------------------


def discover_safetensor_files(checkpoint_dir: Path) -> list[str]:
    """Auto-discover safetensors shard files; raise on empty or ambiguous naming."""
    if not checkpoint_dir.exists():
        raise FileNotFoundError(f"Checkpoint directory does not exist: {checkpoint_dir}")
    st_files = sorted(f.name for f in checkpoint_dir.glob("*.safetensors"))
    if not st_files:
        contents = sorted(f.name for f in checkpoint_dir.iterdir())
        raise ValueError(f"No safetensors files found in {checkpoint_dir}. Directory contents: {contents}")
    model_files = [f for f in st_files if f.startswith("model-")]
    ft_files = [f for f in st_files if f.startswith("ft-model-")]
    if model_files and ft_files:
        raise ValueError(
            f"Ambiguous checkpoint files in {checkpoint_dir}: found both base shards {model_files} and "
            f"fine-tuned shards {ft_files}. Specify checkpoint_files explicitly to disambiguate."
        )
    LOGGER.info(f"Auto-discovered checkpoint file(s): {st_files}")
    return st_files


def validate_checkpoint_dir(
    checkpoint_dir: Path,
    config: dict[str, Any],
    expectations: ModelCheckpointExpectations | None = None,
    checkpoint_files: list[str] | None = None,
) -> None:
    """Non-destructive structural checks before any weights are loaded.

    ``checkpoint_files``: the shard set that will actually be loaded. When the
    caller passed an explicit list (the documented escape hatch for a dir
    holding BOTH base and fine-tuned shards), the shard-count expectation is
    checked against that list, not against every ``*.safetensors`` in the dir.
    """
    if not config:
        raise ValueError(f"config.json in {checkpoint_dir} is empty or could not be parsed.")

    index_path = checkpoint_dir / SAFETENSOR_INDEX_FNAME
    if index_path.exists():
        index_data = json.loads(index_path.read_text())
        expected_shards = set(index_data.get("weight_map", {}).values())
        actual_shards = {f.name for f in checkpoint_dir.glob("*.safetensors")}
        missing = expected_shards - actual_shards
        if missing:
            raise ValueError(
                f"Shard mismatch in {checkpoint_dir}: index file lists shards {sorted(expected_shards)} "
                f"but directory is missing {sorted(missing)}."
            )

    if expectations is None:
        return

    if checkpoint_files is not None:
        n_shards = len(checkpoint_files)
    else:
        n_shards = len(sorted(checkpoint_dir.glob("*.safetensors")))
    if n_shards != expectations.n_shards:
        raise ValueError(
            f"Expected {expectations.n_shards} model shard(s) for {expectations.model_name} but found "
            f"{n_shards} in {checkpoint_dir}. Check that checkpoint_dir points to the correct model."
        )
    checks = [
        ("num_hidden_layers", expectations.num_layers),
        ("hidden_size", expectations.hidden_size),
        ("vocab_size", expectations.vocab_size),
    ]
    for key, expected in checks:
        actual = config.get(key)
        if actual is not None and actual != expected:
            raise ValueError(
                f"config.json reports {key}={actual} but {expectations.model_name} expects {expected}. "
                f"Wrong model, or extended with different n_dsus / modality token settings?"
            )
    LOGGER.info(f"Checkpoint validation passed for {expectations.model_name} ({n_shards} shard(s))")


def check_outdir_not_in_ckptdir(ckpt_dir: Path, out_dir: Path) -> None:
    try:
        out_dir.resolve().relative_to(ckpt_dir.resolve())
    except ValueError:
        return
    raise ValueError(f"output_dir ({out_dir}) must not be inside checkpoint_dir ({ckpt_dir})")


# ---------------------------------------------------------------------------
# Checkpointer
# ---------------------------------------------------------------------------


class Checkpointer:
    """Reads HF-format checkpoints into the port's stacked Llama 3.2 parameters.

    Args:
        checkpoint_dir: Directory with the source HF checkpoint.
        checkpoint_files: Shard file names, or ``None`` to auto-discover.
        config_json: Path to ``config.json`` (defaults to ``checkpoint_dir/config.json``).
        output_dir: Root directory for saved checkpoints (created; saving is A7).
        training_state_checkpoint: resume state; not ported yet (A7).
        safe_serialization: Only safetensors is supported.
        model_expectations: Optional structural expectations for validation.
    """

    def __init__(
        self,
        checkpoint_dir: Path | str,
        checkpoint_files: list[str] | None = None,
        *,
        config_json: Path | str | None = None,
        output_dir: Path | str,
        training_state_checkpoint: Path | str | None = None,
        safe_serialization: bool = True,
        model_expectations: ModelCheckpointExpectations | None = None,
    ) -> None:
        if not safe_serialization:
            raise ValueError("Only safetensors serialization is supported (safe_serialization=True).")
        if training_state_checkpoint is not None:
            raise NotImplementedError(
                "training_state_checkpoint (resume) is not ported to ssi_tpu_torch yet "
                "(ROADMAP.md queue A, item A7: Checkpointer save and resume)"
            )
        self.checkpoint_dir = Path(checkpoint_dir)
        self.output_dir = Path(output_dir)
        check_outdir_not_in_ckptdir(ckpt_dir=self.checkpoint_dir, out_dir=self.output_dir)
        self.output_dir.mkdir(parents=True, exist_ok=True)

        if config_json is None:
            config_json = self.checkpoint_dir / LLAMA_3_2_CONFIG_RELPATH.name
        config_json = Path(config_json)
        if not config_json.exists():
            raise FileNotFoundError(f"No config.json found at {config_json} — expected an HF-format model directory.")
        self._config = json.loads(config_json.read_text())

        explicit = checkpoint_files is not None
        if checkpoint_files is None:
            checkpoint_files = discover_safetensor_files(self.checkpoint_dir)
        validate_checkpoint_dir(
            self.checkpoint_dir, self._config, model_expectations,
            checkpoint_files=checkpoint_files if explicit else None,
        )
        self._checkpoint_paths = sorted(self.checkpoint_dir / f for f in checkpoint_files)
        for p in self._checkpoint_paths:
            if not p.is_file():
                raise FileNotFoundError(f"Checkpoint file not found: {p}")

        self._weight_map: dict[str, str] | None = None

        LOGGER.info(f"Loading from checkpoint(s): {[str(p) for p in self._checkpoint_paths]}")
        LOGGER.info("No training state checkpoint passed. Will initialize optimizer state from scratch.")

    @property
    def hf_config(self) -> dict[str, Any]:
        return dict(self._config)

    @property
    def checkpoint_bytes(self) -> int:
        """Bytes of the shard files a load reads."""
        return sum(p.stat().st_size for p in self._checkpoint_paths)

    # -- load ------------------------------------------------------------------

    def load_hf_state_dict(self) -> dict[str, torch.Tensor]:
        """Load and merge shards into a flat HF state dict of CPU tensors (views of the mapped files)."""
        self._weight_map = {}
        merged: dict[str, torch.Tensor] = {}
        for cpt_idx, cpt_path in enumerate(self._checkpoint_paths):
            with safe_open(str(cpt_path)) as f:
                for key in f.keys():
                    merged[key] = f.get_tensor(key)
                    self._weight_map[key] = f"{cpt_idx + 1:04}"
        return merged

    def load_params(
        self, cfg: ConfigLlama3_2, dtype: torch.dtype = torch.bfloat16, device: torch.device | str = "cuda"
    ) -> dict[str, Any]:
        """Load the checkpoint into the stacked parameter tree on ``device``
        (the card unless the caller names the CPU), cast to ``dtype``.

        The host holds at most one copy besides the mapped files: the stacked
        layers, which move to the device leaf by leaf and are dropped as they go.
        """
        hf_state = self.load_hf_state_dict()
        host = hf_to_internal(hf_state, cfg)
        del hf_state
        def place(x: torch.Tensor) -> torch.Tensor:
            return x.to(dtype=dtype).contiguous().to(device)

        params: dict[str, Any] = {}
        for name in list(host):
            if name == "layers":
                layers = host["layers"]
                params["layers"] = {k: place(layers.pop(k)) for k in list(layers)}
            else:
                params[name] = place(host.pop(name))
        emb = params["embed"]
        if emb.shape[0] != cfg.vocab_size:
            raise ValueError(
                f"Embedding rows ({emb.shape[0]}) do not match expected vocab size ({cfg.vocab_size}). "
                f"Was the model extended with different n_dsus / modality settings?"
            )
        return params
