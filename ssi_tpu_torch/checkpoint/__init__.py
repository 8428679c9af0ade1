"""HF-format checkpoint read and write plus the versioned training state — the
port's copy of ``ssi_tpu/checkpoint/__init__.py``, with the same checks,
error texts and file layout:

- ``discover_safetensor_files`` / ``validate_checkpoint_dir`` /
  ``check_outdir_not_in_ckptdir``;
- ``Checkpointer`` — loads HF safetensors shards into the stacked parameter
  tree (``safetensors_io``: zero-copy torch views of the mapped files) and
  writes self-contained ``step_N/`` HF model dirs (shards + index + copied
  config/tokenizer files);
- ``save_training_state`` / ``load_training_state`` — the schema-v1 resume
  state (version, global_step, seed, optimizer, lr_scheduler, RNG states,
  hparams, consumed_samples, cumulative_metrics, timestamp, package
  version) in the JAX package's msgpack bytes, written and read by the
  first-party ``msgpack_io`` (streamed leaf by leaf to a ``.tmp`` file, then
  an atomic ``os.replace``).

The RNG state is Python's and numpy's global generators only, as in the JAX
package: no torch generator draws on the training path (the optimizer's
stochastic rounding draws its noise from a hash of the step count and the
element's index).
"""

from __future__ import annotations

from datetime import datetime, timezone
import json
import logging
import os
from pathlib import Path
import random
import shutil
from typing import Any

import numpy as np
import torch

from ssi_tpu_torch import __version__
from ssi_tpu_torch.checkpoint import msgpack_io
from ssi_tpu_torch.checkpoint.convert import hf_to_internal, internal_to_hf
from ssi_tpu_torch.checkpoint.safetensors_io import safe_open, save_file
from ssi_tpu_torch.constants import (
    CHECKPOINT_VERSION,
    CHECKPOINT_VERSION_KEY,
    CONSUMED_SAMPLES_KEY,
    CUMULATIVE_METRICS_KEY,
    GLOBAL_STEP_KEY,
    LLAMA_3_2_CONFIG_RELPATH,
    LR_SCHEDULER_KEY,
    OPTIMIZER_KEY,
    RNG_KEY,
    SEED_KEY,
    TRAINING_HPARAMS_KEY,
)
from ssi_tpu_torch.models.configs import ConfigLlama3_2, ModelCheckpointExpectations

LOGGER = logging.getLogger(__name__)

SAFETENSOR_INDEX_FNAME = "model.safetensors.index.json"
SHARD_FNAME = "ft-model-{cpt_idx}-of-{num_shards}"
TRAINING_STATE_FNAME = "training_state.msgpack"
# file suffixes never copied into step_N dirs (weights and derived artifacts;
# .pth covers original/consolidated.00.pth in stock Meta downloads — 2.4 GB
# that would otherwise be duplicated into EVERY step dir)
SUFFIXES_TO_NOT_COPY = (".safetensors", ".bin", ".pt", ".pth", ".msgpack", ".index.json", ".lock", ".tmp")


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


def copy_files(src_dir: Path, dst_dir: Path, ignore_suffixes: tuple[str, ...] | list[str]) -> None:
    """Copy non-weight files (config, tokenizer, etc.) so step dirs are self-contained.

    The suffix filter applies recursively: e.g. ``original/consolidated.00.pth``
    (2.4 GB of Meta-format base weights) must not ride along into extended/step dirs.
    """

    def ignored(_dir: str, names: list[str]) -> list[str]:
        return [n for n in names if n.startswith(".") or any(n.endswith(s) for s in ignore_suffixes)]

    dst_dir.mkdir(parents=True, exist_ok=True)
    for item in src_dir.iterdir():
        if item.name.startswith("."):
            continue
        if any(item.name.endswith(suffix) for suffix in ignore_suffixes):
            continue
        if item.is_dir():
            if item.name.startswith("step_"):
                continue
            shutil.copytree(item, dst_dir / item.name, dirs_exist_ok=True, ignore=ignored)
        else:
            shutil.copy2(item, dst_dir / item.name)


# ---------------------------------------------------------------------------
# RNG state capture (ref: ssi/checkpoint.py:188-206, minus torch)
# ---------------------------------------------------------------------------


def save_rng_states() -> dict[str, Any]:
    """Capture python + NumPy global RNG states (data-order randomness is host-side)."""
    np_state = np.random.get_state()
    return {
        "python": random.getstate(),
        "numpy_global": (np_state[0], np.asarray(np_state[1]), int(np_state[2]), int(np_state[3]), float(np_state[4])),
    }


def restore_rng_states(rng_state: dict[str, Any]) -> None:
    random.setstate(_to_python_random_state(rng_state["python"]))
    name, keys, pos, has_gauss, cached = rng_state["numpy_global"]
    np.random.set_state((name, np.asarray(keys, dtype=np.uint32), int(pos), int(has_gauss), float(cached)))


def _to_python_random_state(state: Any) -> tuple:
    """Rebuild the nested-tuple structure ``random.setstate`` requires after msgpack."""
    version, internal, gauss = state
    return (int(version), tuple(int(x) for x in internal), gauss if gauss is None else float(gauss))


# ---------------------------------------------------------------------------
# Checkpointer
# ---------------------------------------------------------------------------


class Checkpointer:
    """Reads/writes HF-format checkpoints for the port's stacked Llama 3.2 parameters.

    Args:
        checkpoint_dir: Directory with the source HF checkpoint.
        checkpoint_files: Shard file names, or ``None`` to auto-discover.
        config_json: Path to ``config.json`` (defaults to ``checkpoint_dir/config.json``).
        output_dir: Root directory for saved checkpoints and training state.
        training_state_checkpoint: Path to a training-state file for resume, or None.
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
        self.checkpoint_dir = Path(checkpoint_dir)
        self.output_dir = Path(output_dir)
        self.training_state_checkpoint = (
            Path(training_state_checkpoint) if training_state_checkpoint is not None else None
        )
        check_outdir_not_in_ckptdir(ckpt_dir=self.checkpoint_dir, out_dir=self.output_dir)
        if self.training_state_checkpoint is not None and not self.training_state_checkpoint.is_file():
            raise FileNotFoundError(f"Training state checkpoint {self.training_state_checkpoint} not found.")
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
        if self.training_state_checkpoint is not None:
            LOGGER.info(f"Resuming optimizer and training state from: {self.training_state_checkpoint}")
        else:
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
        self, cfg: ConfigLlama3_2, dtype: torch.dtype = torch.bfloat16, device: torch.device | str = "cuda",
        mesh: Any = None,
    ) -> dict[str, Any]:
        """Load the checkpoint into the stacked parameter tree on ``device``
        (the card unless the caller names the CPU), cast to ``dtype``.

        The host holds at most one copy besides the mapped files: the stacked
        layers, which move to the device leaf by leaf and are dropped as they go.
        With a tensor-parallel ``mesh`` (serving) each leaf is cut to this
        rank's slice (``parallel.param_shardings``) on the host before it is cast
        and moved, so a rank's device holds only its slices.
        """
        hf_state = self.load_hf_state_dict()
        host = hf_to_internal(hf_state, cfg)
        del hf_state
        if host["embed"].shape[0] != cfg.vocab_size:
            raise ValueError(
                f"Embedding rows ({host['embed'].shape[0]}) do not match expected vocab size ({cfg.vocab_size}). "
                f"Was the model extended with different n_dsus / modality settings?"
            )
        specs = None
        if mesh is not None:
            from ssi_tpu_torch.parallel import param_shardings, tp_shard

            specs = param_shardings(mesh, host, num_kv_heads=cfg.num_kv_heads)

        def place(x: torch.Tensor, spec: Any) -> torch.Tensor:
            if spec is not None:
                x = tp_shard(x, spec, mesh)
            return x.to(dtype=dtype).contiguous().to(device)

        params: dict[str, Any] = {}
        for name in list(host):
            if name == "layers":
                layers = host["layers"]
                params["layers"] = {k: place(layers.pop(k), specs and specs["layers"][k]) for k in list(layers)}
            else:
                params[name] = place(host.pop(name), specs and specs[name])
        return params

    def load_training_state(self) -> dict[str, Any] | None:
        if self.training_state_checkpoint is None:
            return None
        return msgpack_io.load(self.training_state_checkpoint)

    # -- save ------------------------------------------------------------------

    def save_full_model(self, params: dict[str, Any], cfg: ConfigLlama3_2, output_dir: Path) -> None:
        """Write sharded HF-format safetensors + index (ref: ssi/checkpoint.py:339-410).

        ``params`` may live on the card or the host: each HF tensor is made
        contiguous where it lives (the transposes run on the card) and copied
        to the host once, as the writer reaches it.
        """
        if self._weight_map is None:
            raise ValueError("Weight map is not initialized. Please load a checkpoint before saving.")
        hf_state = internal_to_hf(params, cfg)

        split: dict[str, dict[str, Any]] = {}
        total_size = 0
        for key, weight in hf_state.items():
            cpt_idx = self._weight_map[key]
            split.setdefault(cpt_idx, {})[key] = weight
            total_size += weight.numel() * weight.element_size()

        num_shards = len(split)
        name_map: dict[str, str] = {}
        output_dir.mkdir(parents=True, exist_ok=True)
        for cpt_idx, shard in split.items():
            shard_name = SHARD_FNAME.format(cpt_idx=str(cpt_idx).zfill(5), num_shards=str(num_shards).zfill(5))
            name_map[cpt_idx] = shard_name
            output_path = output_dir / (shard_name + ".safetensors")
            save_file(shard, output_path, metadata={"format": "pt"})
            LOGGER.info(
                f"Model checkpoint of size {os.path.getsize(output_path) / 1024**3:.2f} GiB saved to {output_path}"
            )

        weight_map = {k: name_map[idx] + ".safetensors" for k, idx in self._weight_map.items()}
        index_path = output_dir / SAFETENSOR_INDEX_FNAME
        index_path.write_text(json.dumps({"metadata": {"total_size": total_size}, "weight_map": weight_map}, indent=2))
        LOGGER.info(f"The full model checkpoint has been saved to {output_dir}")

    def save_model_checkpoint(
        self,
        params: dict[str, Any],
        cfg: ConfigLlama3_2,
        global_step: int,
        *,
        output_dir: Path | None = None,
        ignore_suffixes: list[str] | None = None,
    ) -> Path:
        """Save weights to a self-contained ``step_N/`` dir usable by HF tooling."""
        if output_dir is None:
            output_dir = self.output_dir / f"step_{global_step}"
        if ignore_suffixes is None:
            ignore_suffixes = [*SUFFIXES_TO_NOT_COPY, "torchtune_config.yaml", "train_config.yaml"]
        self.save_full_model(params, cfg, output_dir)
        copy_files(self.checkpoint_dir, output_dir, ignore_suffixes=ignore_suffixes)
        return output_dir

    def save_training_state(
        self,
        *,
        optimizer_state: Any,
        lr_scheduler_state: dict[str, Any] | None,
        global_step: int,
        seed: int,
        training_hparams: dict[str, Any],
        consumed_samples: int,
        cumulative_metrics: dict[str, Any],
        rng_state: dict[str, Any] | None = None,
    ) -> Path:
        """Save schema-v1 resume state; always overwrites (ref: ssi/checkpoint.py:435-468).

        ``rng_state``: pre-captured host RNG states (pass when serialization happens
        on a background thread so the capture reflects the training thread).
        Array leaves stream to the file one at a time (device tensors are
        copied to the host as they are reached).
        """
        state_dict = {
            CHECKPOINT_VERSION_KEY: CHECKPOINT_VERSION,
            GLOBAL_STEP_KEY: global_step,
            SEED_KEY: seed,
            OPTIMIZER_KEY: optimizer_state,
            LR_SCHEDULER_KEY: lr_scheduler_state,
            RNG_KEY: rng_state if rng_state is not None else save_rng_states(),
            TRAINING_HPARAMS_KEY: training_hparams,
            CONSUMED_SAMPLES_KEY: consumed_samples,
            CUMULATIVE_METRICS_KEY: cumulative_metrics,
            "timestamp": datetime.now(timezone.utc).isoformat(),
            "ssi_version": __version__,
        }
        output_path = self.output_dir / TRAINING_STATE_FNAME
        # Atomic replace: this file is the ONLY resume state and is overwritten in
        # place every save — a crash mid-write must not destroy the previous one.
        tmp_path = output_path.with_suffix(".msgpack.tmp")
        with open(tmp_path, "wb") as f:
            msgpack_io.pack_to_file(state_dict, f)
        os.replace(tmp_path, output_path)
        LOGGER.info(f"Training state ({os.path.getsize(output_path) / 1024**3:.2f} GiB) saved to {output_path}")
        return output_path


def resolve_checkpointer_output_dir(cfg: Any, logger: Any) -> Path:
    """Build ``{cfg.output_dir}/{run_name}-id_{run_id}/checkpoints`` (ref: ssi/checkpoint.py:471)."""
    run_name = getattr(logger, "run_name", None)
    run_id = getattr(logger, "run_id", None)
    if run_name is None or run_id is None:
        raise RuntimeError("Metric logger run not initialized")
    return Path(cfg.output_dir, f"{run_name}-id_{run_id}", "checkpoints")
