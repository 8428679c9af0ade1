"""ssi_tpu_torch — the PyTorch/CUDA port of ``ssi_tpu`` for one NVIDIA H100.

The JAX package ``ssi_tpu`` stays the reference; each module here mirrors its
counterpart's name and public layouts so the parity tests compare like with
like. Every Pallas kernel on a ported path is a hand-written CUDA kernel under
``csrc/`` (built by ``_build`` with nvcc at first use); beside each kernel sits
its plain PyTorch version, which CPU tensors take.

The port imports torch and never jax, and nothing of ``ssi_tpu`` either
(whose ``__init__`` may load jax): it keeps its own copies of the host
modules it needs (model configs, constants, helpers, the config system,
the tokenizer and its C++ BPE core, the SFT and CPT data pipeline,
checkpoint reading and writing, the training utilities, the extension),
and none of them imports pyyaml, tiktoken, safetensors, msgpack,
``datasets`` or ml_dtypes. ``cli/`` holds the entry points: ``generate``,
``extend_llama3_2``, ``train_sft`` and ``train_cpt``.
"""

__version__ = "0.1.0"
