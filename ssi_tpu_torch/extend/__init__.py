"""Tokenizer extension for discrete speech units — ``extend_tiktoken`` of
``ssi_tpu/extend/__init__.py``, copied (``tests/test_torch_tokenizer.py``
holds its output byte-equal). The embedding, config and params extension
(the rest of ``extend/*``) is not ported yet (ROADMAP.md queue A, item A7).
"""

from __future__ import annotations

import base64
import logging
from pathlib import Path

from ssi_tpu_torch.speech import MODALITY_TOKEN_SPEECH, MODALITY_TOKEN_TEXT, dsu2pua

LOGGER = logging.getLogger(__name__)

__all__ = ["extend_tiktoken"]


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
