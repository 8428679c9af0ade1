"""Discrete speech unit (DSU) utilities — a verbatim copy of
``ssi_tpu/speech.py`` (``tests/test_torch_tokenizer.py`` holds it equal).

Self-contained replacement for the reference's external ``sardalign`` dependency
(ref: ssi/data/cpt.py:10-19 imports sardalign constants/utils; sardalign itself is a
git dependency of the reference, not vendored). Provides:

- ``dsu2pua`` / ``pua2dsu``: DSU index <-> Unicode Private Use Area character mapping.
- Modality boundary tokens (single PUA codepoints so the PUA-aware tiktoken regex
  tokenizes each as exactly one token).
- ``times_to_dsu_idxs``: word-alignment times -> speech-token index conversion
  (ref: plans/Bugfix - CPT Interleave Config Sampling Parameters.md:235 documents the
  formula ``token_index = int(time_in_seconds * sampling_rate / downsampling_ratio)``).
- Default dataset column keys for aligned MLS rows.

PUA layout: DSU ``i`` maps to U+E000+i for i < 6400 (the BMP private use area,
U+E000..U+F8FF — "U+E000 onwards", per the reference's tokenizer-architecture notes).
Codebooks larger than 6400 entries (FocalCodec: 8192) continue into the plane-15
private use area (U+F0000..) so that every DSU character still matches the ``\\p{Co}``
(private-use) regex category — chr(0xE000 + i) alone would leave the BMP PUA at
i == 6400 and stop matching ``\\p{Co}``.
"""

from __future__ import annotations

# --- PUA ranges -----------------------------------------------------------------

_BMP_PUA_START = 0xE000
_BMP_PUA_SIZE = 0xF8FF - 0xE000 + 1  # 6400 codepoints
_PLANE15_PUA_START = 0xF0000
# Plane-15 DSU range stops at 0xFFFFB: the last two codepoints are reserved for the
# modality boundary tokens so a maximal codebook can never collide with them.
_PLANE15_PUA_SIZE = 0xFFFFB - 0xF0000 + 1  # 65532 codepoints

MAX_DSUS = _BMP_PUA_SIZE + _PLANE15_PUA_SIZE

# Modality boundary tokens: single plane-15 PUA codepoints taken from the very end of
# the plane-15 private use area so they can never collide with DSU codepoints.
MODALITY_TOKEN_TEXT: str = chr(0xFFFFC)
MODALITY_TOKEN_SPEECH: str = chr(0xFFFFD)

# Default column keys for aligned speech-text dataset rows (sardalign-equivalent).
# Overridable per data config (*_key options in conf/data/_cpt_base.yaml).
TOKENIZED_KEY: str = "tokenized"
SPEECH_TOKENS_KEY: str = "speech_tokens"
ALIGNMENT_START_TIME_KEY: str = "align_t_starts"
ALIGNMENT_END_TIME_KEY: str = "align_t_ends"


def dsu2pua(dsu: int) -> str:
    """Map a DSU index to its private-use-area character."""
    if dsu < 0:
        raise ValueError(f"DSU index must be non-negative, got {dsu}")
    if dsu < _BMP_PUA_SIZE:
        return chr(_BMP_PUA_START + dsu)
    if dsu < MAX_DSUS:
        return chr(_PLANE15_PUA_START + (dsu - _BMP_PUA_SIZE))
    raise ValueError(f"DSU index {dsu} exceeds available PUA codepoints ({MAX_DSUS})")


def pua2dsu(char: str) -> int:
    """Inverse of :func:`dsu2pua`."""
    cp = ord(char)
    if _BMP_PUA_START <= cp <= 0xF8FF:
        return cp - _BMP_PUA_START
    if _PLANE15_PUA_START <= cp <= 0xFFFFD:
        return cp - _PLANE15_PUA_START + _BMP_PUA_SIZE
    raise ValueError(f"Character U+{cp:04X} is not a DSU PUA codepoint")


def is_dsu_char(char: str) -> bool:
    cp = ord(char)
    return (_BMP_PUA_START <= cp <= 0xF8FF) or (_PLANE15_PUA_START <= cp <= 0xFFFFD)


def times_to_dsu_idxs(
    times: tuple[float, float],
    sampling_rate: int,
    downsampling_ratio: int,
) -> tuple[int, int]:
    """Convert (start_time, end_time) in seconds to speech-token indices.

    ref: ssi/data/cpt.py:20 aliases sardalign's ``times_to_hubert_idxs``; the formula is
    documented in plans/Bugfix - CPT Interleave Config Sampling Parameters.md:235.
    """
    start_time, end_time = times
    start_idx = int(start_time * sampling_rate / downsampling_ratio)
    end_idx = int(end_time * sampling_rate / downsampling_ratio)
    return start_idx, end_idx
