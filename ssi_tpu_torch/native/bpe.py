"""tiktoken-compatible Python facade over the C++ BPE core — a copy of
``ssi_tpu/native/bpe.py`` whose library never falls back (see
``ssi_tpu_torch/native/__init__.py``).

Exposes the subset of ``tiktoken.Encoding`` the tokenizer stack actually uses
(ssi_tpu_torch/tokenizer/__init__.py, tokenizer/bpe_train.py): ordinary text
encode with specials disabled, decode, and ``n_vocab``, under one of the
split patterns of :data:`PATTERNS`, chosen at construction, or of a text
that another split regex has already cut (``encode_pieces``); and
:func:`split`, the pieces a pattern cuts a text into. Special tokens never
reach the native core — encode is always called with specials disallowed (user data containing
special-token strings is encoded as plain text, same policy as the
reference), and decode splices special strings around native calls for the
base-vocab runs.

Bit-identity with tiktoken is the contract, held by tests/test_native_bpe.py
(the JAX package's copy), tests/test_torch_tokenizer.py and
tests/test_torch_cl100k.py (this one).
"""

from __future__ import annotations

from array import array
import base64
import ctypes
from itertools import accumulate

from ssi_tpu_torch.native import load_native

__all__ = ["PATTERNS", "NativeEncoding", "split"]

# The split patterns the C++ scanner implements, by name -> its mode:
# ``CL100K_PATTERN_PUA`` (every private-use codepoint its own piece),
# ``CL100K_PATTERN`` (runs of DSU characters are one piece), and ``whole``:
# the text is one piece, tiktoken's ``(?s:.+)``.
PATTERNS = {"cl100k_pua": 0, "cl100k": 1, "whole": 2}


def _mode(pattern: str) -> int:
    if pattern not in PATTERNS:
        raise ValueError(f"unknown native split pattern {pattern!r}; one of {sorted(PATTERNS)}")
    return PATTERNS[pattern]


def split(text: str, pattern: str) -> list[str]:
    """The pieces ``pattern`` (a name of :data:`PATTERNS`) cuts ``text`` into,
    in order: ``[m.group() for m in regex.finditer(<the regex>, text)]``."""
    lib = load_native()
    data = text.encode("utf-8")
    c = ctypes
    ends = c.POINTER(c.c_int64)()
    n = c.c_int64()
    if lib.bpe_split(data, len(data), _mode(pattern), c.byref(ends), c.byref(n)) != 0:
        raise RuntimeError(lib.bpe_last_error().decode())
    try:
        bounds = [0, *ends[: n.value]]
    finally:
        lib.bpe_free_i64(ends)
    return [data[a:b].decode("utf-8") for a, b in zip(bounds, bounds[1:])]


class NativeEncoding:
    """Loads a tiktoken ``tokenizer.model`` merges file into the C++ core.

    Args:
        path: merges file ("<base64> <rank>" lines).
        special_tokens: special string -> id (ids at/above the base vocab).
        pattern: the split pattern of encode, a name of :data:`PATTERNS`.
        ranks: {token bytes: rank} in place of ``path`` (``path`` is then None).
    """

    def __init__(self, path: str | None, special_tokens: dict[str, int] | None = None, pattern: str = "cl100k_pua",
                 ranks: dict[bytes, int] | None = None):
        self._mode = _mode(pattern)
        lib = load_native()
        self._lib = lib
        if (path is None) == (ranks is None):
            raise ValueError("give exactly one of path and ranks")
        if ranks is not None:
            data = "".join(base64.b64encode(tok).decode() + f" {rank}\n"
                           for tok, rank in sorted(ranks.items(), key=lambda kv: kv[1])).encode()
            self._handle = lib.bpe_new_from_buffer(data, len(data))
        else:
            self._handle = lib.bpe_new(str(path).encode())
        if not self._handle:
            raise OSError(f"BPE load failed: {lib.bpe_last_error().decode()}")
        self._base_vocab = int(lib.bpe_n_vocab(self._handle))
        self.special_tokens = dict(special_tokens or {})
        self._special_by_id = {v: k for k, v in self.special_tokens.items()}

    def __del__(self):
        handle, self._handle = getattr(self, "_handle", None), None
        if handle:
            self._lib.bpe_free(handle)

    @property
    def n_vocab(self) -> int:
        if self.special_tokens:
            return max(self._base_vocab, max(self.special_tokens.values()) + 1)
        return self._base_vocab

    def encode(self, text: str, allowed_special=frozenset(), disallowed_special=()) -> list[int]:
        """Ordinary encode — special-token *strings* in the text are plain text."""
        if allowed_special:
            raise NotImplementedError("native encode supports allowed_special=set() only")
        data = text.encode("utf-8")
        c = ctypes
        out = c.POINTER(c.c_int32)()
        out_len = c.c_int64()
        rc = self._lib.bpe_encode(self._handle, data, len(data), self._mode, c.byref(out), c.byref(out_len))
        if rc != 0:
            raise RuntimeError(self._lib.bpe_last_error().decode())
        try:
            return out[: out_len.value]
        finally:
            self._lib.bpe_free_i32(out)

    def encode_pieces(self, pieces: list[str]) -> list[int]:
        """Each of ``pieces`` merged alone, in order, in one native call: the
        ids tiktoken's encode gives a text that its split regex cuts into
        ``pieces`` (empty pieces give no id)."""
        ends = array("q", accumulate(n for n in map(len, map(str.encode, pieces)) if n))
        if not ends:
            return []
        data = "".join(pieces).encode("utf-8")
        c = ctypes
        out = c.POINTER(c.c_int32)()
        out_len = c.c_int64()
        rc = self._lib.bpe_encode_pieces(self._handle, data, len(data), (c.c_int64 * len(ends)).from_buffer(ends),
                                         len(ends), c.byref(out), c.byref(out_len))
        if rc != 0:
            raise RuntimeError(self._lib.bpe_last_error().decode())
        try:
            return out[: out_len.value]
        finally:
            self._lib.bpe_free_i32(out)

    def _decode_base_run(self, ids: list[int]) -> bytes:
        if not ids:
            return b""
        c = ctypes
        arr = (c.c_int32 * len(ids))(*ids)
        out = c.POINTER(c.c_uint8)()
        out_len = c.c_int64()
        rc = self._lib.bpe_decode(self._handle, arr, len(ids), c.byref(out), c.byref(out_len))
        if rc != 0:
            raise KeyError(self._lib.bpe_last_error().decode())
        try:
            return bytes(out[: out_len.value])
        finally:
            self._lib.bpe_free_u8(out)

    def decode_bytes(self, token_ids: list[int]) -> bytes:
        parts: list[bytes] = []
        run: list[int] = []
        for t in token_ids:
            if t in self._special_by_id:
                parts.append(self._decode_base_run(run))
                run = []
                parts.append(self._special_by_id[t].encode("utf-8"))
            else:
                run.append(int(t))
        parts.append(self._decode_base_run(run))
        return b"".join(parts)

    def decode(self, token_ids: list[int], errors: str = "replace") -> str:
        return self.decode_bytes(token_ids).decode("utf-8", errors=errors)
