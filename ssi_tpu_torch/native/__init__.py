"""The port's native (C++) host code: the byte-level BPE core that stands in
for tiktoken's Rust BPE — a copy of ``ssi_tpu/native/`` (``__init__``'s build
and load, ``bpe.py``, ``src/bpe.cc``, ``src/unicode_tables.h``, the last held
byte-equal by ``tests/test_torch_tokenizer.py``) that adds a scanner for
``CL100K_PATTERN``, a whole-piece mode and a split entry (held equal to
tiktoken and ``regex`` by ``tests/test_torch_cl100k.py``). It is host code,
not a kernel.

Build: ``src/*.cc`` compile with g++ (``-O2 -std=c++17 -shared -fPIC``) into
one shared library under the gitignored ``ssi_tpu_torch/_build/``, keyed by
a hash of the sources and flags, at first use (never at import); the
library is written under a temporary name and renamed into place, so a
concurrent loader never opens a half-written file.

There is no fallback: a missing compiler or a failed build raises
``RuntimeError``, where the JAX tokenizer would switch to tiktoken.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import subprocess
import tempfile
import time
from pathlib import Path

LOGGER = logging.getLogger(__name__)

_SRC_DIR = Path(__file__).parent / "src"
_BUILD_DIR = Path(__file__).parent.parent / "_build"
_CXX_FLAGS = ["-O2", "-std=c++17", "-shared", "-fPIC", "-Wall"]

_lib: ctypes.CDLL | None = None


def _source_hash() -> str:
    h = hashlib.sha256()
    for path in sorted(_SRC_DIR.glob("*")):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    h.update(" ".join(_CXX_FLAGS).encode())
    return h.hexdigest()[:16]


def build_library() -> Path:
    """Compile src/*.cc into one cached .so; returns its path."""
    out = _BUILD_DIR / f"libssi_native_{_source_hash()}.so"
    if out.exists():
        return out
    _BUILD_DIR.mkdir(exist_ok=True)
    sources = sorted(str(p) for p in _SRC_DIR.glob("*.cc"))
    if not sources:
        raise RuntimeError(f"no C++ sources under {_SRC_DIR}")
    t0 = time.perf_counter()
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD_DIR)
    os.close(fd)
    cmd = ["g++", *_CXX_FLAGS, "-I", str(_SRC_DIR), "-o", tmp, *sources]
    try:
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
        except FileNotFoundError:
            raise RuntimeError("g++ not found: the native BPE core is built from source at first use") from None
        if proc.returncode != 0:
            raise RuntimeError(f"native build failed ({' '.join(cmd)}):\n{proc.stderr[-4000:]}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    LOGGER.info("built native library: %s (%.1f s)", out, time.perf_counter() - t0)
    return out


def load_native() -> ctypes.CDLL:
    """Build (if needed) and open the native library, its signatures bound."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build_library()))
        _bind_signatures(lib)
        _lib = lib
    return _lib


def _bind_signatures(lib: ctypes.CDLL) -> None:
    c = ctypes
    lib.bpe_last_error.restype = c.c_char_p
    lib.bpe_new.argtypes = [c.c_char_p]
    lib.bpe_new.restype = c.c_void_p
    lib.bpe_new_from_buffer.argtypes = [c.c_char_p, c.c_int64]
    lib.bpe_new_from_buffer.restype = c.c_void_p
    lib.bpe_free.argtypes = [c.c_void_p]
    lib.bpe_n_vocab.argtypes = [c.c_void_p]
    lib.bpe_n_vocab.restype = c.c_int64
    lib.bpe_encode.argtypes = [
        c.c_void_p, c.c_char_p, c.c_int64, c.c_int32,
        c.POINTER(c.POINTER(c.c_int32)), c.POINTER(c.c_int64),
    ]
    lib.bpe_encode.restype = c.c_int
    lib.bpe_free_i32.argtypes = [c.POINTER(c.c_int32)]
    lib.bpe_split.argtypes = [
        c.c_char_p, c.c_int64, c.c_int32, c.POINTER(c.POINTER(c.c_int64)), c.POINTER(c.c_int64),
    ]
    lib.bpe_split.restype = c.c_int
    lib.bpe_free_i64.argtypes = [c.POINTER(c.c_int64)]
    lib.bpe_encode_pieces.argtypes = [
        c.c_void_p, c.c_char_p, c.c_int64, c.POINTER(c.c_int64), c.c_int64,
        c.POINTER(c.POINTER(c.c_int32)), c.POINTER(c.c_int64),
    ]
    lib.bpe_encode_pieces.restype = c.c_int
    lib.bpe_decode.argtypes = [
        c.c_void_p, c.POINTER(c.c_int32), c.c_int64,
        c.POINTER(c.POINTER(c.c_uint8)), c.POINTER(c.c_int64),
    ]
    lib.bpe_decode.restype = c.c_int
    lib.bpe_free_u8.argtypes = [c.POINTER(c.c_uint8)]
