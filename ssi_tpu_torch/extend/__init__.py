"""Model + tokenizer extension for discrete speech units — the port's copy of
``ssi_tpu/extend/__init__.py`` (numpy, as the original):

- ``extend_tiktoken`` — append base64(PUA char) merge lines to ``tokenizer.model``
  with consecutive next ranks; duplicate detection; in-place or to a new file;
- ``extend_embeddings`` — grow the tied embedding matrix with rows sampled from a
  multivariate Gaussian fit to the base text-token rows (covariance scaled 1e-5);
  new layout ``[base_text | dsu | modality? | special]``;
- ``extend_config`` / ``extend_params`` / ``extend_generation_config`` — JSON edits
  shifting bos/eos/vocab_size to the post-extension IDs.

``tests/test_torch_tokenizer.py`` holds ``extend_tiktoken``'s output
byte-equal, and ``tests/test_torch_extend.py`` the extension CLI's whole
output directory.
"""

from __future__ import annotations

import base64
import json
import logging
from pathlib import Path

import numpy as np

from ssi_tpu_torch.models.configs import ConfigLlama3_2
from ssi_tpu_torch.speech import MODALITY_TOKEN_SPEECH, MODALITY_TOKEN_TEXT, dsu2pua

LOGGER = logging.getLogger(__name__)

__all__ = [
    "extend_tiktoken",
    "extend_embeddings",
    "extend_config",
    "extend_generation_config",
    "extend_params",
    "gaussian_from_embeddings",
]


def extend_tiktoken(n_new_dsus: int, use_modality_tokens: bool, tokenizer_model: Path, output_path: Path) -> None:
    """Append PUA token merge lines to a tiktoken ``tokenizer.model`` file.

    Format per line: ``<base64(token bytes)> <merge rank>``. New ranks continue from
    the current max (ref: ssi/extend_llama3_2/__init__.py:22-78).
    """
    tokenizer_model = Path(tokenizer_model)
    output_path = Path(output_path)
    is_inplace: bool = tokenizer_model == output_path
    if not is_inplace and output_path.exists():
        raise FileExistsError(f"Extended tokenizer output already exists at: {output_path}")

    with open(tokenizer_model) as file:
        base_tokenizer_lines: list[str] = file.readlines()

    vocabulary: dict[bytes, int] = {}
    for line in base_tokenizer_lines:
        token, rnk = line.split()
        vocabulary[base64.b64decode(token.encode("utf-8"))] = int(rnk)

    rank: int = max(vocabulary.values()) + 1  # tokenizer.model need not be rank-sorted

    def _create_token_list(tks: list[str]) -> list[str]:
        nonlocal rank
        tokenizer_lines = []
        for i, token in enumerate(tks):
            token_bytes: bytes = token.encode("utf-8")
            if token_bytes in vocabulary:
                raise RuntimeError(f"Token {token} (idx: {i}) already exists in the vocabulary")
            token_b64_ascii = base64.b64encode(token_bytes).decode("utf-8")
            tokenizer_lines.append(f"{token_b64_ascii} {rank}\n")
            rank += 1
        return tokenizer_lines

    dsu_tkns = [dsu2pua(i) for i in range(n_new_dsus)]
    dsu_tokenizer_lines = _create_token_list(dsu_tkns)
    LOGGER.info(f"Adding {len(dsu_tokenizer_lines)} DSU tokens to {tokenizer_model!s}")

    if use_modality_tokens:
        modality_tokenizer_lines = _create_token_list([MODALITY_TOKEN_TEXT, MODALITY_TOKEN_SPEECH])
        LOGGER.info(f"Adding {len(modality_tokenizer_lines)} modality tokens to {tokenizer_model!s}")
    else:
        modality_tokenizer_lines = []
        LOGGER.info(f"No Modality Tokens added to {tokenizer_model}")

    output_path.parent.mkdir(parents=True, exist_ok=True)
    with open(output_path, "w" if is_inplace else "x") as file:
        file.writelines(base_tokenizer_lines + dsu_tokenizer_lines + modality_tokenizer_lines)

    LOGGER.info(f"Extended tokenizer.model saved to {output_path}")


def gaussian_from_embeddings(weights: np.ndarray, sigma_scaling: float = 1e-5):
    """Fit mean + scaled empirical covariance to embedding rows; return a sampler.

    Equivalent of sardalign's ``multivariate_normal_from_weights`` (ref:
    ssi/extend_llama3_2/__init__.py:96): samples are drawn from
    ``N(mean, sigma_scaling * cov)`` via Cholesky.
    """
    weights = np.asarray(weights)
    n, d = weights.shape
    mean = weights.mean(axis=0, dtype=np.float64)
    # Chunked fp64-accumulated covariance: avoids materializing a full fp64 copy
    # plus a centered copy (~4 GB transient for the 128k x 2048 base embeddings).
    cov = np.zeros((d, d), np.float64)
    for start in range(0, n, 8192):
        chunk = weights[start : start + 8192].astype(np.float64) - mean
        cov += chunk.T @ chunk
    cov /= n
    scaled = sigma_scaling * cov
    # Jitter for numerical PD-ness (covariances of near-collinear rows)
    jitter = 1e-12 * np.eye(d)
    for _ in range(8):
        try:
            chol = np.linalg.cholesky(scaled + jitter)
            break
        except np.linalg.LinAlgError:
            jitter *= 10.0
    else:
        raise np.linalg.LinAlgError("Covariance not positive definite even with jitter")

    def sample(n_samples: int, rng: np.random.Generator) -> np.ndarray:
        z = rng.standard_normal((n_samples, d))
        return (mean + z @ chol.T).astype(np.float32)

    return sample


def extend_embeddings(
    embed: np.ndarray,
    llama_config: ConfigLlama3_2,
    n_new_dsus: int,
    use_modality_tokens: bool,
    rng: np.random.Generator,
    sigma_scaling: float = 1e-5,
) -> np.ndarray:
    """Grow the tied embedding matrix with Gaussian-sampled rows.

    Input layout ``[base_text | special]``; output ``[base_text | new | special]``
    (ref: ssi/extend_llama3_2/__init__.py:81-106). Returns a new fp32 array; the
    caller re-ties the output projection by construction (the JAX model always
    projects through ``params["embed"]``).
    """
    base_vocab_size = llama_config.base_vocab_size_txt
    special_tokens_size = llama_config.n_special_txt
    embed = np.asarray(embed)
    if embed.shape != (base_vocab_size + special_tokens_size, llama_config.embed_dim):
        raise RuntimeError(
            f"Unexpected embedding size for Llama 3.2 model: {embed.shape} != "
            f"({base_vocab_size + special_tokens_size}, {llama_config.embed_dim})"
        )
    base_vocab_embeddings = embed[:base_vocab_size, :]
    special_tokens_embeddings = embed[base_vocab_size:, :]
    sampler = gaussian_from_embeddings(base_vocab_embeddings, sigma_scaling=sigma_scaling)
    n_new = n_new_dsus + 2 * use_modality_tokens
    new_token_embeddings = sampler(n_new, rng).astype(embed.dtype)
    out = np.concatenate((base_vocab_embeddings, new_token_embeddings, special_tokens_embeddings), axis=0)

    # Invariants (ref: ssi/extend_llama3_2/__init__.py:104-106)
    assert np.array_equal(out[:base_vocab_size, :], embed[:base_vocab_size, :])
    assert np.array_equal(out[-special_tokens_size:, :], embed[-special_tokens_size:, :])
    assert out.shape[0] - embed.shape[0] == n_new
    LOGGER.info(f"Added {n_new_dsus} new DSU embeddings to the model (in memory)")
    if use_modality_tokens:
        LOGGER.info("Added embeddings for modality tokens to the model embedding weights (in memory)")
    return out


def extend_config(
    config_json: Path,
    bos_token_id: int,
    eos_token_id: int,
    vocab_size: int,
    llama_config: ConfigLlama3_2,
) -> None:
    """Shift bos/eos/vocab_size in HF config.json (ref: ssi/extend_llama3_2/__init__.py:114-133)."""
    base_vocab_size = llama_config.base_vocab_size_txt
    special_tokens_size = llama_config.n_special_txt
    with open(config_json) as f:
        config = json.load(f)
    assert config.pop("bos_token_id") == 128_000
    assert config.pop("eos_token_id") == 128_001
    assert config.pop("vocab_size") == base_vocab_size + special_tokens_size
    config["bos_token_id"] = bos_token_id
    config["eos_token_id"] = eos_token_id
    config["vocab_size"] = vocab_size
    with open(config_json, "w") as f:
        json.dump(config, f, indent=2)
    LOGGER.info(f"Updated config.json with new bos_token_id, eos_token_id, and vocab_size: {config_json}")


def extend_generation_config(generation_config_json: Path, bos_token_id: int, eos_token_id: int) -> None:
    """Shift bos/eos in generation_config.json (ref: ssi/extend_llama3_2/__init__.py:136-149)."""
    with open(generation_config_json) as f:
        config = json.load(f)
    assert config.pop("bos_token_id") == 128_000
    assert config.pop("eos_token_id") == 128_001
    config["bos_token_id"] = bos_token_id
    config["eos_token_id"] = eos_token_id
    with open(generation_config_json, "w") as f:
        json.dump(config, f, indent=2)
    LOGGER.info("Updated generation_config.json with new bos_token_id and eos_token_id")


def extend_params(params_json: Path, vocab_size: int, llama_config: ConfigLlama3_2) -> None:
    """Shift vocab_size in Meta params.json (ref: ssi/extend_llama3_2/__init__.py:152-161)."""
    base_vocab_size = llama_config.base_vocab_size_txt
    special_tokens_size = llama_config.n_special_txt
    with open(params_json) as f:
        config = json.load(f)
    assert config.pop("vocab_size") == base_vocab_size + special_tokens_size
    config["vocab_size"] = vocab_size
    with open(params_json, "w") as f:
        json.dump(config, f, indent=2)
    LOGGER.info(f"Updated params.json with new vocab_size: {params_json}")
