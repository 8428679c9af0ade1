"""Batched generation over an SFT split — the port's twin of ``scripts/generate.py``.

Usage::

    python -m ssi_tpu_torch.cli.generate model=/path/to/step_N [data=sft/<name>] [key=value ...]

Composes ``conf/generate.yaml`` (read in place, by the port's own config
reader), auto-resolves n_dsus and the data config from the training-config
snapshot next to the checkpoint when not given explicitly, and calls
``ssi_tpu_torch.generate.run_generation``. It runs on the CUDA card; with no
card visible it refuses unless ``+device=cpu`` is given.

Tensor-parallel generation runs one process a rank under torchrun::

    torchrun --nproc_per_node N -m ssi_tpu_torch.cli.generate model=... tensor_parallel=N

The process group comes up from torchrun's environment (NCCL on the card,
gloo with ``+device=cpu``), as in the training CLIs, and is torn down on
exit; rank 0 writes the generations.
"""

import logging
from pathlib import Path
import sys

from ssi_tpu_torch._build import write_launch_counts
from ssi_tpu_torch.config import compose, load_yaml
from ssi_tpu_torch.constants import SUPPORTED_DATASETS, TRAIN_CONFIG_FILENAME
from ssi_tpu_torch.generate import run_generation
from ssi_tpu_torch.parallel import joined_from_launcher
from ssi_tpu_torch.utils import resolve_device

LOGGER = logging.getLogger(__name__)

TEST_CONFIG_GROUPS_SUBDIR = "data/sft"
CONF_DIR = Path(__file__).resolve().parents[2] / "conf"


def main(argv: list[str]) -> None:
    logging.basicConfig(
        format="[%(asctime)s][%(name)s][%(levelname)s] - %(message)s",
        level=logging.INFO,
        stream=sys.stdout,
    )
    cfg = compose(str(CONF_DIR), "generate", overrides=argv)
    device = resolve_device(cfg)  # refuse before any work when the card is missing
    with joined_from_launcher(device):
        _run(cfg, argv)


def _run(cfg, argv: list[str]) -> None:
    from ssi_tpu_torch.train.metric_logging import configure_hydra_logging

    configure_hydra_logging(cfg)

    train_cfg = None
    if cfg.get("train_yaml") is None:
        # our layout: .../checkpoints/step_N -> snapshot in parents[0] (the checkpoints
        # dir); the reference's epoch_X/global_step_N layout put it at parents[1]
        for parent_idx in (0, 1):
            train_yaml_rundir = Path(cfg.model).parents[parent_idx] / TRAIN_CONFIG_FILENAME
            if train_yaml_rundir.exists():
                train_cfg = load_yaml(train_yaml_rundir)
                LOGGER.warning(f"Loaded training config from {train_yaml_rundir!s}")
                break
    else:
        train_cfg = load_yaml(cfg.train_yaml)

    # Resolve speech.n_dsus: CLI > training config > data config
    if cfg.speech.n_dsus is None:
        if train_cfg and train_cfg.get("speech", {}).get("n_dsus") is not None:
            cfg.speech.n_dsus = train_cfg["speech"]["n_dsus"]
            LOGGER.info(f"Auto-setting cfg.speech.n_dsus to {cfg.speech.n_dsus} from training config.")
        elif cfg.get("data") is not None and cfg.data.get("n_dsus") is not None:
            cfg.speech.n_dsus = cfg.data.n_dsus
            LOGGER.info(f"Auto-setting cfg.speech.n_dsus to {cfg.speech.n_dsus} from data config.")
        else:
            raise ValueError("cfg.speech.n_dsus must be specified via CLI, training config, or data config.")

    # Resolve the data config group from the training dataset if not selected
    if cfg.get("data") is None:
        if train_cfg is None:
            raise RuntimeError("No data config selected and no training config found to infer it from.")
        source = train_cfg["data"]["train"]["dataset"]["source"]
        if "/" not in source or source.count("/") != 1:
            raise RuntimeError(
                f"Cannot infer a data config from training source {source!r} (not an owner/name HF repo id); "
                "select one explicitly, e.g. data=sft/mls-hubert_large_ll60k-layer_22"
            )
        _owner, train_dataset = source.split("/")
        if train_dataset.split("-")[0] not in SUPPORTED_DATASETS:
            raise RuntimeError(f"Unsupported dataset for generation: {train_dataset}")
        cfg_data_path = (CONF_DIR / TEST_CONFIG_GROUPS_SUBDIR / train_dataset).with_suffix(".yaml")
        if not cfg_data_path.exists():
            raise RuntimeError(f"Cannot find test dataset config at {cfg_data_path}.")
        composed = compose(str(CONF_DIR), "generate", overrides=argv + [f"data=sft/{train_dataset}"])
        composed.speech.n_dsus = cfg.speech.n_dsus
        cfg = composed

    run_generation(cfg)


if __name__ == "__main__":
    main(sys.argv[1:])
    write_launch_counts("generate")
