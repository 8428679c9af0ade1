"""Constants of ``ssi_tpu/constants.py`` that the port needs, copied (that
module is jax-free, but importing ``ssi_tpu`` loads jax through its
``__init__``). ``tests/test_torch_optimizer.py`` and
``tests/test_torch_config.py`` hold each value equal to the original."""

import os
from pathlib import Path

# Seed (ref: ssi/constants.py:12-13)
SEED: int = 42_831

# Supported datasets (ref: ssi/constants.py:21-24)
SUPPORTED_DATASETS: set[str] = {"mls", "voxpopuli", "librispeech", "gigaspeech"}
HF_OWNER: str = "anilkeshwani"
SUPPORTED_DTYPES: set[str] = {"fp32", "bf16"}

# W&B (ref: ssi/constants.py:27-29)
DEBUGGING_TAG: str = "trial-run"
WANDB_ENTITY_DEFAULT: str = "anilkeshwani"
WANDB_PROJECT_DEFAULT: str = "speech-integration"

# Checkpoints and artefacts (ref: ssi/constants.py:39-50)
HOME_DIR = Path(os.environ.get("SSI_TPU_HOME", os.environ.get("HAFH", str(Path.home() / "ssi_tpu"))))
BASE_MODELS_DIR = HOME_DIR / "models" / "base"
EXTENDED_MODELS_DIR = HOME_DIR / "models" / "extended"
LLAMA_3_2_1B_BASE_DIR = BASE_MODELS_DIR / "Llama-3.2-1B"

# Relative paths inside an HF-format Llama 3.2 model directory
LLAMA_3_2_TOKENIZER_RELPATH = Path("original", "tokenizer.model")
LLAMA_3_2_CONFIG_RELPATH = Path("config.json")
LLAMA_3_2_GENERATION_CONFIG_RELPATH = Path("generation_config.json")
LLAMA_3_2_PARAMS_RELPATH = Path("original", "params.json")

# Llama 3.2 tokenizer
LLAMA_BOS_TOKEN = "<|begin_of_text|>"
LLAMA_EOS_TOKEN = "<|end_of_text|>"

# Resolved-config snapshot filename written to the checkpoint dir (ref: ssi/constants.py:56)
TRAIN_CONFIG_FILENAME = "torchtune_config.yaml"  # kept for drop-in compatibility with ref tooling

# Checkpoint schema v1 keys (ref: ssi/constants.py:61-97)
OPTIMIZER_KEY: str = "optimizer"
SEED_KEY: str = "seed"
GLOBAL_STEP_KEY: str = "global_step"
RNG_KEY: str = "rng_state"
TRAINING_HPARAMS_KEY: str = "training_hparams"
LR_SCHEDULER_KEY: str = "lr_scheduler"
CONSUMED_SAMPLES_KEY: str = "consumed_samples"
CUMULATIVE_METRICS_KEY: str = "cumulative_metrics"
CHECKPOINT_VERSION_KEY: str = "checkpoint_version"
CHECKPOINT_VERSION: int = 1

# Loss ignore index (torch cross-entropy convention, kept for data-format compatibility)
CROSS_ENTROPY_IGNORE_IDX: int = -100

# Keys reserved for the collated batch (ref: ssi/constants.py:97)
RESERVED_BATCH_KEYS: set[str] = {"tokens", "mask", "labels"}
