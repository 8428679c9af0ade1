"""Llama 3.2 model hyperparameter configs — the port's own copy of
``ssi_tpu/models/configs.py``, so that importing the port never imports the
JAX package (whose ``__init__`` may load jax).

Same fields, same vocab arithmetic and the same registry names and values;
``tests/test_torch_model.py`` holds every entry equal to its JAX counterpart.
Checkpoint expectations and the speech-config update arrive with the
checkpoint and CLI port.
"""

from __future__ import annotations

from dataclasses import dataclass, replace


@dataclass
class ConfigLlama3_2:
    """Llama 3.2 hyperparameters with dynamic vocab arithmetic:
    ``vocab_size = base_vocab_size_txt + n_special_txt + n_dsus + 2*modality_tokens``."""

    base_vocab_size_txt: int
    n_special_txt: int
    num_layers: int
    num_heads: int
    num_kv_heads: int
    embed_dim: int
    max_seq_len: int
    intermediate_dim: int
    attn_dropout: float
    norm_eps: float
    rope_base: int
    scale_factor: int
    n_dsus: int = 0
    modality_tokens: bool = False
    # 1B/3B tie the output projection to the embedding; 8B has a separate lm_head
    tied_embeddings: bool = True
    rope_low_freq_factor: float = 1.0
    rope_high_freq_factor: float = 4.0
    rope_original_max_seq_len: int = 8192
    n_checkpoint_shards: int = 1

    def __post_init__(self) -> None:
        if not isinstance(self.n_dsus, int) or self.n_dsus < 0:
            raise ValueError("n_dsus must be a non-negative integer")
        if not isinstance(self.modality_tokens, bool):
            raise ValueError("modality_tokens must be boolean")

    @property
    def head_dim(self) -> int:
        return self.embed_dim // self.num_heads

    @property
    def vocab_size(self) -> int:
        return self.base_vocab_size_txt + self.n_special_txt + self.n_dsus + (2 * self.modality_tokens)

    def copy(self) -> "ConfigLlama3_2":
        return replace(self)


_LLAMA3 = dict(base_vocab_size_txt=128_000, n_special_txt=256, max_seq_len=131072,
               attn_dropout=0.0, norm_eps=1e-5, rope_base=500_000)

MODEL_CONFIGS: dict[str, ConfigLlama3_2] = {
    "llama3_2_100m": ConfigLlama3_2(**_LLAMA3, num_layers=8, num_heads=8, num_kv_heads=4, embed_dim=512,
                                    intermediate_dim=2048, scale_factor=32),
    "llama3_2_1b": ConfigLlama3_2(**_LLAMA3, num_layers=16, num_heads=32, num_kv_heads=8, embed_dim=2048,
                                  intermediate_dim=8192, scale_factor=32),
    "llama3_2_3b": ConfigLlama3_2(**_LLAMA3, num_layers=28, num_heads=24, num_kv_heads=8, embed_dim=3072,
                                  intermediate_dim=8192, scale_factor=32, n_checkpoint_shards=2),
    "llama3_1_8b": ConfigLlama3_2(**_LLAMA3, num_layers=32, num_heads=32, num_kv_heads=8, embed_dim=4096,
                                  intermediate_dim=14336, scale_factor=8, n_checkpoint_shards=4,
                                  tied_embeddings=False),
    # tiny architecture for CPU tests (not a reference model)
    "tiny_test": ConfigLlama3_2(base_vocab_size_txt=256, n_special_txt=256, num_layers=2, num_heads=4,
                                num_kv_heads=2, embed_dim=64, max_seq_len=2048, intermediate_dim=128,
                                attn_dropout=0.0, norm_eps=1e-5, rope_base=500_000, scale_factor=32),
}


def get_model_config(name: str) -> ConfigLlama3_2:
    """A fresh copy of the registry entry ``name``."""
    try:
        return MODEL_CONFIGS[name].copy()
    except KeyError:
        raise KeyError(f"Unknown model_config {name!r}. Available: {sorted(MODEL_CONFIGS)}") from None
