"""Llama 3 tiktoken tokenizer with Private-Use-Area (DSU) support — the port's
copy of ``ssi_tpu/tokenizer/__init__.py``. tiktoken is not a dependency of
the port: the BPE core is always the first-party C++ one
(``ssi_tpu_torch/native``, bit-identical to tiktoken and with no fallback),
and ``load_tiktoken_bpe`` is the port's own ``tokenizer.model`` reader. The
C++ core has a scanner for each of the two split patterns, the PUA one and
``CL100K_PATTERN`` (``pattern: cl100k``, BPE-compressed DSU runs). Any other
split regex is matched by the ``regex`` package (imported when such a
pattern is first compiled, and refused by name when it is missing), and the
C++ core merges the pieces it cuts, all of a text's in one call.
``tests/test_torch_tokenizer.py``, ``tests/test_torch_cl100k.py`` and
``tests/test_torch_regex_pattern.py`` hold encode, decode and
``tokenize_messages`` equal to the JAX tokenizer's tiktoken backend.

The original is a standalone reimplementation of the tokenizer stack the reference assembles from
torchtune + a monkeypatch (ref: ssi/tokenizer/__init__.py:18-45,
ssi/tokenizer/monkeypatch.py:7-43). Behavioural contract:

- byte-level BPE (the C++ core) with a PUA-aware split regex so each private-use
  codepoint (DSU character) tokenizes as exactly one token;
- the 256 Llama-3 special tokens are assigned *dynamically* to the ID range
  ``[base_vocab_size, base_vocab_size + 256)`` so they float above any appended
  DSU tokens (ref: ssi/tokenizer/__init__.py:29-31);
- chat-format tokenization (``tokenize_messages``) producing token/mask pairs
  identical in structure to torchtune v0.5's Llama3Tokenizer.
"""

from __future__ import annotations

import base64
import logging
from pathlib import Path
from pprint import pformat
from typing import Any, Iterator

from ssi_tpu_torch.native.bpe import NativeEncoding
from ssi_tpu_torch.tokenizer.messages import Message
from ssi_tpu_torch.utils import import_optional

__all__ = [
    "CL100K_PATTERN",
    "CL100K_PATTERN_PUA",
    "LLAMA3_SPECIAL_TOKENS",
    "Llama3Tokenizer",
    "load_tiktoken_bpe",
    "setup_llama3_tokenizer",
    "truncate",
]

LOGGER = logging.getLogger(__name__)

# Standard cl100k split pattern used by the Llama 3 tokenizer.
CL100K_PATTERN = r"""(?i:'s|'t|'re|'ve|'m|'ll|'d)|[^\r\n\p{L}\p{N}]?\p{L}+|\p{N}{1,3}| ?[^\s\p{L}\p{N}]+[\r\n]*|\s*[\r\n]+|\s+(?!\S)|\s+"""  # noqa: E501

# PUA-aware variant: adds \p{Co} to the exclusion sets and as a final single-char
# alternative, so each private-use codepoint is split out as its own piece
# (ref: ssi/tokenizer/monkeypatch.py:7 — must match character-for-character for
# bit-identical DSU tokenization).
CL100K_PATTERN_PUA = r"""(?i:'s|'t|'re|'ve|'m|'ll|'d)|[^\r\n\p{L}\p{N}\p{Co}]?\p{L}+|\p{N}{1,3}| ?[^\s\p{L}\p{N}\p{Co}]+[\r\n]*|\s*[\r\n]+|\s+(?!\S)|\s+|\p{Co}"""  # noqa: E501

assert CL100K_PATTERN_PUA != CL100K_PATTERN

# the split regexes the C++ scanner implements -> its pattern names
_NATIVE_PATTERNS = {CL100K_PATTERN_PUA: "cl100k_pua", CL100K_PATTERN: "cl100k"}

# The 256 Llama 3 special tokens, in canonical order. IDs here are the *base-model*
# assignments (base vocab 128000); after DSU extension the same ordering is re-assigned
# dynamically to [base_vocab_size, base_vocab_size + 256).
_NAMED_SPECIAL_TOKENS = [
    "<|begin_of_text|>",
    "<|end_of_text|>",
    "<|reserved_special_token_0|>",
    "<|reserved_special_token_1|>",
    "<|finetune_right_pad_id|>",
    "<|step_id|>",
    "<|start_header_id|>",
    "<|end_header_id|>",
    "<|eom_id|>",
    "<|eot_id|>",
    "<|python_tag|>",
    "<|image|>",
    "<|video|>",
]
NUM_RESERVED_SPECIAL_TOKENS = 256
_RESERVED_SPECIAL_TOKENS = [
    f"<|reserved_special_token_{2 + i}|>" for i in range(NUM_RESERVED_SPECIAL_TOKENS - len(_NAMED_SPECIAL_TOKENS))
]
LLAMA3_SPECIAL_TOKENS: dict[str, int] = {
    tok: 128_000 + i for i, tok in enumerate(_NAMED_SPECIAL_TOKENS + _RESERVED_SPECIAL_TOKENS)
}

# Guards against pathological inputs (very long texts / very long runs without
# whitespace) during BPE. These change token boundaries at the margins, so the split
# rules are part of the tokenization contract.
MAX_ENCODE_CHARS = 400_000
MAX_NO_WHITESPACE_CHARS = 25_000


def load_tiktoken_bpe(path: str | Path) -> dict[bytes, int]:
    """A ``tokenizer.model`` merges file -> {token bytes: rank}: one
    ``<base64 token> <rank>`` per line (``tiktoken.load.load_tiktoken_bpe``'s
    format and result)."""
    lines = Path(path).read_bytes().splitlines()
    return {base64.b64decode(token): int(rank) for token, rank in (line.split() for line in lines if line)}


def truncate(tokens: list[Any], max_seq_len: int, eos_id: int | None = None) -> list[Any]:
    """Truncate to ``max_seq_len``, optionally coercing the final element to ``eos_id``."""
    tokens_truncated = tokens[:max_seq_len]
    if eos_id is not None and tokens_truncated and tokens_truncated[-1] != eos_id:
        tokens_truncated[-1] = eos_id
    return tokens_truncated


class Llama3Tokenizer:
    """Llama 3 tokenizer: PUA-aware BPE core + chat-format message tokenization.

    Args:
        path: Path to the tiktoken ``tokenizer.model`` BPE merges file.
        special_tokens: Mapping of special token strings to IDs. ``None`` uses the
            base-model assignments in :data:`LLAMA3_SPECIAL_TOKENS`.
        max_seq_len: Maximum sequence length for truncation (``None`` = no limit).
        prompt_template: Optional callable ``list[Message] -> list[Message]``.
        pattern: split regex. Default :data:`CL100K_PATTERN_PUA` (every DSU
            character is its own token — the reference contract). Pass
            :data:`CL100K_PATTERN` for BPE-COMPRESSED DSU runs: without the
            ``\\p{Co}`` isolation, adjacent DSU characters form one piece and
            the trained multi-DSU merges (``tokenizer/bpe_train.py``) can
            fire. The C++ scanner implements these two; any other regex is
            matched by the ``regex`` package (:func:`compile_split_regex`).
    """

    def __init__(
        self,
        path: str | Path,
        special_tokens: dict[str, int] | None = None,
        max_seq_len: int | None = None,
        prompt_template=None,
        pattern: str = CL100K_PATTERN_PUA,
        mergeable_ranks: dict[bytes, int] | None = None,
    ):
        self.path = str(path)
        self.special_tokens = dict(special_tokens) if special_tokens is not None else dict(LLAMA3_SPECIAL_TOKENS)
        self.max_seq_len = max_seq_len
        self.prompt_template = prompt_template

        # accept pre-parsed ranks so setup_llama3_tokenizer doesn't parse the
        # multi-MB base64 merges file twice per process
        if mergeable_ranks is None:
            mergeable_ranks = load_tiktoken_bpe(self.path)
        self._base_vocab_size = len(mergeable_ranks)
        self.pattern = pattern
        # a pattern the scanner does not implement: regex cuts, the C++ core merges each piece whole
        self._split = None if pattern in _NATIVE_PATTERNS else compile_split_regex(pattern)
        # the C++ core reads the merges file itself; a failed build raises (no fallback)
        self._native = NativeEncoding(self.path, self.special_tokens, pattern=_NATIVE_PATTERNS.get(pattern, "whole"))
        self._special_token_ids = set(self.special_tokens.values())

        self.bos_id = self.special_tokens["<|begin_of_text|>"]
        self.eos_id = self.special_tokens["<|end_of_text|>"]
        self.pad_id = self.special_tokens["<|finetune_right_pad_id|>"]
        self.step_id = self.special_tokens["<|step_id|>"]
        self.start_header_id = self.special_tokens["<|start_header_id|>"]
        self.end_header_id = self.special_tokens["<|end_header_id|>"]
        self.eom_id = self.special_tokens["<|eom_id|>"]
        self.eot_id = self.special_tokens["<|eot_id|>"]
        self.python_tag = self.special_tokens["<|python_tag|>"]
        self.image_id = self.special_tokens["<|image|>"]
        self.stop_tokens = [self.eos_id, self.eom_id, self.eot_id]

    # -- core BPE ------------------------------------------------------------------

    @property
    def base_vocab_size(self) -> int:
        return self._base_vocab_size

    @property
    def vocab_size(self) -> int:
        return self._native.n_vocab

    @staticmethod
    def _split_long_repetitions(s: str, max_consecutive: int) -> Iterator[str]:
        """Yield substrings with runs of consecutive (non-)whitespace capped in length."""
        current_slice_len = 0
        current_slice_is_space = s[0].isspace() if s else False
        slice_start = 0
        for i in range(len(s)):
            is_now_space = s[i].isspace()
            if current_slice_is_space ^ is_now_space:
                current_slice_len = 1
                current_slice_is_space = is_now_space
            else:
                current_slice_len += 1
                if current_slice_len > max_consecutive:
                    yield s[slice_start:i]
                    slice_start = i
                    current_slice_len = 1
        yield s[slice_start:]

    def encode(self, text: str, add_bos: bool = True, add_eos: bool = True) -> list[int]:
        """Byte-level BPE encode with the tokenizer's split pattern."""
        substrs: list[str] = []
        tokens: list[int] = []
        if text:
            for i in range(0, len(text), MAX_ENCODE_CHARS):
                substr = text[i : i + MAX_ENCODE_CHARS]
                substrs.extend(self._split_long_repetitions(substr, MAX_NO_WHITESPACE_CHARS))
            core = self._native
            for substr in substrs:
                # Special token strings appearing in user data are encoded as plain text.
                if self._split is None:
                    tokens.extend(core.encode(substr, allowed_special=set(), disallowed_special=()))
                else:
                    tokens.extend(core.encode_pieces([m.group() for m in self._split.finditer(substr)]))
        if add_bos:
            tokens.insert(0, self.bos_id)
        if add_eos:
            tokens.append(self.eos_id)
        return tokens

    def decode(self, token_ids: list[int], truncate_at_eos: bool = True, skip_special_tokens: bool = True) -> str:
        """Decode IDs to text; optionally cut at the first EOS and drop special tokens."""
        if truncate_at_eos:
            try:
                k = token_ids.index(self.eos_id)
            except ValueError:
                k = None
            if k is not None:  # EOS at index 0 must truncate to empty, not be skipped
                token_ids = token_ids[:k]
        if skip_special_tokens:
            token_ids = [t for t in token_ids if t not in self._special_token_ids]
        return self._native.decode(token_ids)

    # -- chat format -----------------------------------------------------------------

    def _tokenize_header(self, message: Message) -> list[int]:
        return (
            [self.start_header_id]
            + self.encode(message.role.strip(), add_bos=False, add_eos=False)
            + [self.end_header_id]
            + self.encode("\n\n", add_bos=False, add_eos=False)
        )

    def _tokenize_end(self, message: Message) -> list[int]:
        return [self.eot_id] if message.eot else [self.eom_id]

    def _tokenize_body(self, message: Message) -> list[int]:
        tokenized_body: list[int] = []
        for item in message.content:
            if item["type"] == "text":
                tokenized_body += self.encode(item["content"].strip(), add_bos=False, add_eos=False)
            elif item["type"] == "image":
                tokenized_body += [self.image_id]
            else:
                raise RuntimeError(f"Unsupported message content type: {item['type']}")
        if message.ipython:
            tokenized_body = [self.python_tag] + tokenized_body
        return tokenized_body

    def tokenize_message(self, message: Message, *, add_start_tokens: bool = True, add_end_tokens: bool = True):
        tokenized_header = self._tokenize_header(message) if add_start_tokens else []
        tokenized_body = self._tokenize_body(message)
        tokenized_end = self._tokenize_end(message) if add_end_tokens else []
        return tokenized_header + tokenized_body + tokenized_end

    def tokenize_messages(self, messages: list[Message], *, add_end_tokens: bool = True):
        """Tokenize a conversation into (tokens, mask).

        ``mask[i] == True`` means token ``i`` is excluded from the loss. BOS/EOS are
        always masked. When ``add_end_tokens`` is False (inference), the final message
        gets no end token and no EOS is appended, leaving the sequence open for
        generation.
        """
        templated = self.prompt_template(messages) if self.prompt_template is not None else messages
        tokens = [self.bos_id]
        mask = [True]
        num_messages = len(templated)
        for i, message in enumerate(templated):
            add_end_tokens_message = add_end_tokens if i == num_messages - 1 else True
            tokenized_message = self.tokenize_message(message, add_end_tokens=add_end_tokens_message)
            tokens = tokens + tokenized_message
            mask = mask + ([message.masked] * len(tokenized_message))
            if self.max_seq_len and len(tokens) >= self.max_seq_len:
                break
        if add_end_tokens:
            tokens = tokens + [self.eos_id]
            mask = mask + [True]
        if self.max_seq_len:
            tokens = truncate(tokens, self.max_seq_len, self.eos_id if add_end_tokens else None)
            mask = truncate(mask, self.max_seq_len, True if add_end_tokens else None)
        return tokens, mask

    def __call__(self, sample: dict[str, Any], inference: bool = False) -> dict[str, Any]:
        """Tokenize ``sample["messages"]`` in place, adding ``tokens`` and ``mask`` keys."""
        messages = sample.pop("messages")
        tokens, mask = self.tokenize_messages(messages, add_end_tokens=not inference)
        sample["tokens"] = tokens
        sample["mask"] = mask
        return sample


def setup_llama3_tokenizer(
    path: Path | str,
    max_seq_len: int | None = None,
    prompt_template=None,
    verbose: bool = True,
    pattern: str | None = None,
) -> tuple[Llama3Tokenizer, dict[str, int]]:
    """Load a (possibly DSU-extended) tokenizer.model with dynamic special tokens.

    The 256 Llama-3 special tokens are assigned to the contiguous range starting at
    the *current* base vocab size, so they sit above any appended DSU tokens
    (ref: ssi/tokenizer/__init__.py:18-45).

    ``pattern``: ``None`` = the PUA contract pattern; the string ``"cl100k"``
    (or a raw regex) selects the non-PUA-splitting pattern for BPE-compressed
    DSU runs (config key ``tokenizer.pattern: cl100k``). Any other raw regex
    splits through the ``regex`` package, as the JAX tokenizer's tiktoken
    backend splits by it.
    """
    if pattern is None:
        pattern = CL100K_PATTERN_PUA
    elif pattern == "cl100k":
        pattern = CL100K_PATTERN
    elif pattern == "cl100k_pua":
        pattern = CL100K_PATTERN_PUA
    path = Path(path)
    # parse the merges file ONCE and hand the ranks to the tokenizer below.
    # (The reference hashes the file and passes the hash to load_tiktoken_bpe —
    # a check that is true by construction since the hash comes from the same
    # file; ref: ssi/tokenizer/__init__.py:24-26. Dropped here.)
    mergeable_ranks = load_tiktoken_bpe(str(path))
    base_vocab_size = len(mergeable_ranks)
    assert base_vocab_size == max(mergeable_ranks.values()) + 1, "Requirement: base vocab contiguous and 0-indexed"
    special_token_names = list(LLAMA3_SPECIAL_TOKENS)
    if len(special_token_names) != 256:
        raise RuntimeError("Unexpected number of special tokens in Llama 3.2. Has the API changed?")
    special_tokens_dynamic = dict(
        zip(special_token_names, range(base_vocab_size, base_vocab_size + len(special_token_names)))
    )
    tokenizer = Llama3Tokenizer(
        path=str(path),
        special_tokens=special_tokens_dynamic,
        max_seq_len=max_seq_len,
        prompt_template=prompt_template,
        pattern=pattern,
        mergeable_ranks=mergeable_ranks,
    )
    if verbose:
        LOGGER.info(f"Loaded Llama 3 tokenizer (native BPE core) from: {path}")
        LOGGER.info(
            f"Llama3 special tokens (dynamic): {pformat(special_tokens_dynamic, sort_dicts=False, underscore_numbers=True)}"
        )
        LOGGER.info(f"Tokenizer base vocabulary size (BPE merges file): {base_vocab_size}")
        LOGGER.info(f"Llama 3 tokenizer vocabulary size: {tokenizer.vocab_size}")
    return tokenizer, special_tokens_dynamic


def compile_split_regex(pattern: str) -> Any:
    """``regex.compile(pattern)``: a split regex that the C++ scanner does not
    implement is matched by the ``regex`` package, whose classes and
    ``\\s`` are tiktoken's (Python's ``re`` also counts U+001C-U+001F as
    ``\\s``, and has no ``\\p{...}``)."""
    regex = import_optional("regex", f"The split pattern {pattern!r} (the C++ scanner implements only "
                                     "CL100K_PATTERN_PUA and CL100K_PATTERN)")
    return regex.compile(pattern)
