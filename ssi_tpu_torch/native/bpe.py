"""tiktoken-compatible Python facade over the C++ BPE core — a copy of
``ssi_tpu/native/bpe.py`` whose library never falls back (see
``ssi_tpu_torch/native/__init__.py``).

Exposes the subset of ``tiktoken.Encoding`` the tokenizer stack actually uses
(ssi_tpu_torch/tokenizer/__init__.py): ordinary text encode with specials
disabled, decode, and ``n_vocab``. Special tokens never reach the native core
— encode is always called with specials disallowed (user data containing
special-token strings is encoded as plain text, same policy as the
reference), and decode splices special strings around native calls for the
base-vocab runs.

Bit-identity with tiktoken is the contract, held by tests/test_native_bpe.py
(the JAX package's copy) and tests/test_torch_tokenizer.py (this one).
"""

from __future__ import annotations

import ctypes

from ssi_tpu_torch.native import load_native

__all__ = ["NativeEncoding"]


class NativeEncoding:
    """Loads a tiktoken ``tokenizer.model`` merges file into the C++ core.

    Args:
        path: merges file ("<base64> <rank>" lines).
        special_tokens: special string -> id (ids at/above the base vocab).
    """

    def __init__(self, path: str, special_tokens: dict[str, int] | None = None):
        lib = load_native()
        self._lib = lib
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
        rc = self._lib.bpe_encode(self._handle, data, len(data), c.byref(out), c.byref(out_len))
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
