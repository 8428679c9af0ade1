"""Constants of ``ssi_tpu/constants.py`` that the port needs, copied (that
module is jax-free, but importing ``ssi_tpu`` loads jax through its
``__init__``). ``tests/test_torch_optimizer.py`` holds each value equal to
the original."""

# Loss ignore index (torch cross-entropy convention, kept for data-format compatibility)
CROSS_ENTROPY_IGNORE_IDX: int = -100
