"""Build and load the port's CUDA kernels (nvcc -> one shared library -> ctypes).

Each ``csrc/*.cu`` source compiles to an object with its own nvcc process, all
started together, and one more nvcc call links the objects into one shared
library with a plain C interface, cached under ``_build/`` keyed by a hash of
the sources and flags (edit a source and the next load rebuilds; the library
is written under a temporary name and renamed into place, so a concurrent
loader never opens a half-written file). The build happens at first use,
inside the first call that launches a kernel, never at import: CPU-only
machines import every module without a compiler.

There is no fallback. A missing nvcc, a failed build, or a launch whose C
entry point returns a non-zero ``cudaError_t`` raises ``RuntimeError``.

``launch_counts`` holds one plain integer per kernel, incremented by the
kernel's wrapper right after a successful launch and nowhere else, so a run
can show that its main path went through the kernels.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from collections import Counter
from pathlib import Path

_CSRC_DIR = Path(__file__).parent / "csrc"
_BUILD_DIR = Path(__file__).parent / "_build"
_DEFAULT_CUDA_HOME = "/usr/local/cuda"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-O3", "-std=c++17", "-Xcompiler", "-fPIC", "-Xptxas=-v",
]

# kernel name -> launches since the last reset (see module docstring)
launch_counts: Counter = Counter()

_lib: ctypes.CDLL | None = None
# seconds the last build took (0.0 when the cached library was reused) and
# nvcc's diagnostics of that build (ptxas register/spill report)
build_seconds: float = 0.0
build_log: str = ""

_c = ctypes
_P = _c.c_void_p
_I = _c.c_int
_L = _c.c_longlong
_SIGNATURES = {
    # dtype, q, k, v, seg, o, lse, B, S, Hq, Hkv, q/k/v strides (b, s, h), causal, scale, stream
    "ssi_flash_attention_fwd": [_I, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                                _L, _L, _L, _L, _L, _L, _L, _L, _L, _I, _c.c_float, _P],
    # dtype, q, k_pool, v_pool, page_table, seq_lens, k_new, v_new, write_rows,
    # out, part (scratch), n_slots, Hq, Hkv, page_size, max_pages, pages per split,
    # n_splits, scale, stream
    "ssi_paged_attention_fused": [_I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                                  _I, _I, _I, _I, _I, _I, _I, _c.c_float, _P],
    # dtype, q, k_pool, v_pool, page_table, hist_lens, k_new, v_new, write_rows,
    # out, part (scratch), n_slots, T, Hq, Hkv, page_size, max_pages, trash row,
    # pages per split, n_splits, scale, stream
    "ssi_paged_attention_multi": [_I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                                  _I, _I, _I, _I, _I, _I, _I, _I, _I, _c.c_float, _P],
    # dtype, q, k, v, o, do, lse, seg, delta (scratch), dq, dk, dv, B, S, Hq, Hkv, causal, scale, stream
    "ssi_flash_attention_bwd": [_I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                                _I, _I, _I, _I, _I, _c.c_float, _P],
    # dtype, N, V -> rows of the logsumexp's (max, sum) scratch
    "ssi_cross_entropy_lse_splits": [_I, _I, _I],
    # dtype, h, e, m_part (scratch), l_part (scratch), lse, N, V, D, n_split, stream
    "ssi_cross_entropy_lse": [_I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    # dtype, h, e, lse, labels, g, dlogits (out, row stride ldv), N, V, D, ldv, stream
    "ssi_cross_entropy_dlogits": [_I, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    # dtype, dlogits, e, dh (out), N, V, D, ldv, stream
    "ssi_cross_entropy_dh": [_I, _P, _P, _P, _I, _I, _I, _I, _P],
    # dtype, dlogits, h, de (out), N, V, D, ldv, stream
    "ssi_cross_entropy_de": [_I, _P, _P, _P, _I, _I, _I, _I, _P],
}


def find_nvcc() -> str:
    """nvcc from ``PATH``, else ``$CUDA_HOME/bin`` (or the toolkit's default
    install prefix); raises ``RuntimeError`` naming where it looked."""
    found = shutil.which("nvcc")
    if found:
        return found
    homes = [os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"), _DEFAULT_CUDA_HOME]
    tried = []
    for home in homes:
        if not home:
            continue
        cand = Path(home) / "bin" / "nvcc"
        tried.append(str(cand))
        if cand.is_file() and os.access(cand, os.X_OK):
            return str(cand)
    raise RuntimeError(
        "nvcc not found: the CUDA kernels are built from source at first use and need "
        f"the CUDA toolkit (searched PATH and {', '.join(tried) or 'no CUDA_HOME'})"
    )


def _sources() -> list[Path]:
    return sorted(_CSRC_DIR.glob("*.cu"))


def _source_hash() -> str:
    h = hashlib.sha256()
    for path in sorted(_CSRC_DIR.glob("*.cu*")):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def build_library() -> Path:
    """Compile ``csrc/*.cu`` into the cached shared library; returns its path."""
    global build_seconds, build_log
    out = _BUILD_DIR / f"libssi_kernels_{_source_hash()}.so"
    if out.exists():
        build_seconds = 0.0
        return out
    nvcc = find_nvcc()
    _BUILD_DIR.mkdir(exist_ok=True)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=_BUILD_DIR) as work:
        objs, procs = [], []
        try:
            for src in _sources():  # one nvcc per source, all running at once
                obj = Path(work) / f"{src.stem}.o"
                cmd = [nvcc, *NVCC_FLAGS, "-I", str(_CSRC_DIR), "-c", "-o", str(obj), str(src)]
                procs.append((cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
                objs.append(str(obj))
            logs = []
            for cmd, proc in procs:
                text, _ = proc.communicate(timeout=900)
                logs.append(text)
                if proc.returncode != 0:
                    raise RuntimeError(f"CUDA kernel build failed ({' '.join(cmd)}):\n{text[-6000:]}")
        finally:
            for _, proc in procs:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
        tmp = Path(work) / "lib.so"
        cmd = [nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp), *objs]
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
        build_log = "".join(logs) + proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"CUDA kernel link failed ({' '.join(cmd)}):\n{build_log[-6000:]}")
        os.replace(tmp, out)
    build_seconds = time.perf_counter() - t0
    (_BUILD_DIR / f"{out.stem}.log").write_text(build_log)
    return out


def load_library() -> ctypes.CDLL:
    """Build (if needed) and open the kernel library, with every entry
    point's ``argtypes``/``restype`` declared."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build_library()))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = _c.c_int
        _lib = lib
    return _lib


def check_launch(name: str, err: int) -> None:
    """Raise on a non-zero ``cudaError_t`` from a C launcher, else count the launch."""
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: cudaError_t {err}")
    launch_counts[name] += 1
