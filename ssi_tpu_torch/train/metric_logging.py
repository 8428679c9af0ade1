"""Metric logging and job logging for the port's entry points — the port's
copy of ``ssi_tpu/train/metric_logging.py``: ``JsonlLogger``,
``WandBLogger`` and ``setup_metric_logger`` (W&B when the ``wandb`` package
imports and is enabled, else JSONL on disk), ``configure_job_logging``,
``configure_hydra_logging``, ``_dict_config_from_yaml`` and
``attach_run_file_logging``. The logging YAML is read by the port's own
YAML reader (``ssi_tpu_torch.config.yaml_subset``) instead of pyyaml, and
the config snapshot written by the port's config writer.

Run identity (``run_name`` / ``run_id``) is generated locally when W&B is absent so
``resolve_checkpointer_output_dir`` works identically (ref: ssi/checkpoint.py:471).
"""

from __future__ import annotations

import json
import logging
from pathlib import Path
import time
from typing import Any
import uuid

from ssi_tpu_torch.config import yaml_subset
from ssi_tpu_torch.constants import TRAIN_CONFIG_FILENAME

LOGGER = logging.getLogger(__name__)


def _generate_run_name() -> str:
    return time.strftime("run-%Y%m%d-%H%M%S")


def _generate_run_id() -> str:
    return uuid.uuid4().hex[:8]


class JsonlLogger:
    """Local JSONL metric sink with W&B-compatible surface."""

    def __init__(self, log_dir: Path | str | None = None, **_: Any) -> None:
        self.run_name = _generate_run_name()
        self.run_id = _generate_run_id()
        self._log_dir = Path(log_dir) if log_dir is not None else None
        self._fh = None
        self.history: list[dict[str, Any]] = []

    def _ensure_open(self):
        if self._fh is None and self._log_dir is not None:
            self._log_dir.mkdir(parents=True, exist_ok=True)
            self._fh = open(self._log_dir / "metrics.jsonl", "a")
        return self._fh

    def set_log_dir(self, log_dir: Path | str) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None
        self._log_dir = Path(log_dir)

    def log_config(self, cfg: Any, checkpoint_dir: Path | str | None = None) -> None:
        """Snapshot the resolved config to the checkpoint dir (ref: ssi/metric_logging.py:33-37)."""
        from ssi_tpu_torch.config import save as save_cfg

        if checkpoint_dir is not None:
            path = Path(checkpoint_dir) / TRAIN_CONFIG_FILENAME
            save_cfg(cfg, path, resolve=True)
            LOGGER.info(f"Resolved config snapshot saved to {path}")

    def log_dict(self, metrics: dict[str, Any], step: int) -> None:
        record = {"step": step, **{k: _jsonable(v) for k, v in metrics.items()}}
        self.history.append(record)
        fh = self._ensure_open()
        if fh is not None:
            fh.write(json.dumps(record) + "\n")
            fh.flush()

    def log(self, name: str, data: Any, step: int) -> None:
        self.log_dict({name: data}, step=step)

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None


class WandBLogger(JsonlLogger):
    """W&B logger with JSONL mirroring; requires the wandb package."""

    def __init__(
        self,
        project: str,
        entity: str | None = None,
        group: str | None = None,
        log_dir: Path | str | None = None,
        tags: list[str] | None = None,
        **kwargs: Any,
    ) -> None:
        super().__init__(log_dir=log_dir)
        import wandb  # raises ImportError if unavailable

        self._wandb = wandb
        self._run = wandb.init(project=project, entity=entity, group=group, tags=tags, **kwargs)
        self.run_name = self._run.name or self.run_name
        self.run_id = self._run.id or self.run_id

    def log_config(self, cfg: Any, checkpoint_dir: Path | str | None = None) -> None:
        from ssi_tpu_torch.config import to_container

        super().log_config(cfg, checkpoint_dir)
        resolved = to_container(cfg, resolve=True)
        self._wandb.config.update(resolved, allow_val_change=True)
        if checkpoint_dir is not None:
            try:
                self._wandb.save(str(Path(checkpoint_dir) / TRAIN_CONFIG_FILENAME), policy="now")
            except Exception as e:  # non-fatal (ref: torchtune WandBLogger behavior)
                LOGGER.warning(f"Failed to upload config snapshot to W&B: {e}")

    def log_dict(self, metrics: dict[str, Any], step: int) -> None:
        super().log_dict(metrics, step)
        self._wandb.log({k: _jsonable(v) for k, v in metrics.items()}, step=step)

    def close(self) -> None:
        super().close()
        if getattr(self, "_run", None) is not None:
            self._run.finish()


def setup_metric_logger(cfg_wandb: Any, tags: list[str] | None = None, log_dir: Path | str | None = None):
    """W&B if importable and enabled, else JSONL (always works offline)."""
    kwargs = {k: v for k, v in cfg_wandb.items()} if cfg_wandb is not None else {}
    enabled = kwargs.pop("enabled", True)
    if enabled:
        try:
            return WandBLogger(log_dir=log_dir, tags=tags, **kwargs)
        except Exception as e:
            LOGGER.warning(f"W&B unavailable ({type(e).__name__}: {e}); falling back to JSONL metric logging.")
    return JsonlLogger(log_dir=log_dir)


def configure_job_logging(cfg: Any, run_dir: Path | str, job_name: str = "train") -> None:
    """Apply the user's hydra/job_logging config group, or the built-in default.

    Restores the reference's overridable logging surface
    (ref: conf/hydra/job_logging/custom.yaml:1-34): if the composed config
    carries ``hydra.job_logging_config`` (set by ssi_tpu_torch.config.compose), that
    yaml is applied via ``logging.config.dictConfig`` after substituting the
    reference's ``${hydra.runtime.output_dir}`` / ``${hydra.job.name}``
    placeholders — reference logging configs drop in unchanged. Selecting
    ``hydra/job_logging=none`` keeps basic console logging only. Configs built
    without the composer fall back to the hardcoded per-run file handler.
    """
    hydra_node = cfg.get("hydra") if hasattr(cfg, "get") else None
    choice = hydra_node.get("job_logging") if hydra_node is not None else "custom"
    if choice in (None, "none"):
        return
    yaml_path = hydra_node.get("job_logging_config") if hydra_node is not None else None
    if yaml_path is None:
        attach_run_file_logging(run_dir, job_name)  # composer-less fallback
        return

    run_dir = Path(run_dir)
    run_dir.mkdir(parents=True, exist_ok=True)
    substitutions = {
        "${hydra.runtime.output_dir}": str(run_dir),
        "${hydra.job.name}": str(job_name),
    }
    _dict_config_from_yaml(yaml_path, substitutions)
    LOGGER.info(f"Applied job_logging config {yaml_path} (run dir {run_dir})")


def configure_hydra_logging(cfg: Any) -> None:
    """Apply the hydra/hydra_logging config group — framework-phase logging.

    The analog of Hydra configuring its own logger at app startup
    (ref: conf/hydra/hydra_logging/custom.yaml): CLI entry points call this
    right after ``ssi_tpu_torch.config.compose`` so composition/setup messages use
    the HYDRA-tagged console format until job_logging takes over. A missing
    hydra node, ``hydra/hydra_logging=none``, or a composer-less config all
    leave the process's existing logging untouched.
    """
    hydra_node = cfg.get("hydra") if hasattr(cfg, "get") else None
    if hydra_node is None:
        return
    if hydra_node.get("hydra_logging") in (None, "none"):
        return
    yaml_path = hydra_node.get("hydra_logging_config")
    if yaml_path is None:
        return
    _dict_config_from_yaml(yaml_path)
    LOGGER.info(f"Applied hydra_logging config {yaml_path}")


def _dict_config_from_yaml(yaml_path: str | Path, substitutions: dict[str, str] | None = None) -> None:
    """dictConfig a logging yaml, degrading the colorlog formatter when the
    colorlog package is absent (handlers fall back to the first plain
    formatter in the file instead of failing)."""
    import logging.config

    text = Path(yaml_path).read_text()
    for placeholder, value in (substitutions or {}).items():
        text = text.replace(placeholder, value)
    config = yaml_subset.load(text)
    try:
        import colorlog  # noqa: F401
    except ImportError:
        fmts = config.get("formatters", {})
        if "colorlog" in fmts:
            fmts.pop("colorlog")
            fallback = next(iter(fmts), None)
            for handler in config.get("handlers", {}).values():
                if handler.get("formatter") == "colorlog":
                    if fallback is None:
                        handler.pop("formatter", None)
                    else:
                        handler["formatter"] = fallback
    logging.config.dictConfig(config)


def attach_run_file_logging(run_dir: Path | str, job_name: str = "train") -> None:
    """Attach a per-run file handler to the root logger.

    Parity with the reference's custom Hydra logging config, which writes a
    ``<job>.log`` into each run's output dir alongside the colored console
    (ref: conf/hydra/job_logging/custom.yaml:20-34).
    """
    run_dir = Path(run_dir)
    run_dir.mkdir(parents=True, exist_ok=True)
    path = run_dir / f"{job_name}.log"
    root = logging.getLogger()
    for h in root.handlers:
        if isinstance(h, logging.FileHandler) and getattr(h, "baseFilename", None) == str(path):
            return  # already attached (idempotent across setup calls)
    handler = logging.FileHandler(path)
    handler.setFormatter(logging.Formatter("[%(asctime)s][%(name)s][%(levelname)s] - %(message)s"))
    root.addHandler(handler)
    LOGGER.info(f"Run log file: {path}")


def _jsonable(v: Any) -> Any:
    try:
        json.dumps(v)
        return v
    except (TypeError, ValueError):
        try:
            return float(v)
        except (TypeError, ValueError):
            return str(v)
