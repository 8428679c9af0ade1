"""Constants of ``ssi_tpu/constants.py`` that the port needs, copied (that
module is jax-free, but importing ``ssi_tpu`` loads jax through its
``__init__``). ``tests/test_torch_optimizer.py`` and
``tests/test_torch_config.py`` hold each value equal to the original."""

from pathlib import Path

# Supported datasets (ref: ssi/constants.py:21-24)
SUPPORTED_DATASETS: set[str] = {"mls", "voxpopuli", "librispeech", "gigaspeech"}
HF_OWNER: str = "anilkeshwani"

# Relative path of config.json inside an HF-format Llama 3.2 model directory
LLAMA_3_2_CONFIG_RELPATH = Path("config.json")

# Resolved-config snapshot filename written to the checkpoint dir (ref: ssi/constants.py:56)
TRAIN_CONFIG_FILENAME = "torchtune_config.yaml"  # kept for drop-in compatibility with ref tooling

# Loss ignore index (torch cross-entropy convention, kept for data-format compatibility)
CROSS_ENTROPY_IGNORE_IDX: int = -100

# Keys reserved for the collated batch (ref: ssi/constants.py:97)
RESERVED_BATCH_KEYS: set[str] = {"tokens", "mask", "labels"}
