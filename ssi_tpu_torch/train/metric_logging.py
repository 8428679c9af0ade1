"""Job logging for the port's entry points — ``configure_job_logging``,
``configure_hydra_logging``, ``_dict_config_from_yaml`` and
``attach_run_file_logging`` of ``ssi_tpu/train/metric_logging.py``
(141-239), copied; the logging YAML is read by the port's own YAML reader
(``ssi_tpu_torch.config.yaml_subset``) instead of pyyaml. The metric loggers
(JSONL, W&B) are not ported yet (ROADMAP.md queue A, item A7).
"""

from __future__ import annotations

import logging
from pathlib import Path
from typing import Any

from ssi_tpu_torch.config import yaml_subset

LOGGER = logging.getLogger(__name__)


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
