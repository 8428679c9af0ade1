"""safetensors read and write in plain Python, giving torch tensors — the read
side of ``ssi_tpu/native/safetensors_io.py`` (``safe_open``, ``load_file``)
plus a small writer (``save_file``), without the ``safetensors`` package.

The format: an 8-byte little-endian header length, a JSON header (per tensor
``dtype``, ``shape`` and ``data_offsets`` into the data section; optional
``__metadata__`` of str -> str), then the raw little-endian tensor bytes.

Reads are zero-copy: the file is memory-mapped copy-on-write and each tensor
is a ``torch.frombuffer`` view of its bytes, so BF16 needs neither
``ml_dtypes`` nor a numpy bf16 type, and a tensor keeps the map alive (it
stays valid after the ``safe_open`` context exits). The writer orders
tensors by element size, then name (so every tensor's offset is aligned to
its element size), and pads the header to a multiple of 8 bytes, as the
``safetensors`` package does; ``tests/test_torch_checkpoint.py`` holds both
directions bit for bit against it.
"""

from __future__ import annotations

import json
import mmap
import struct
from pathlib import Path
from typing import Any, Mapping

import torch

__all__ = ["safe_open", "load_file", "save_file"]

_ST_TO_TORCH = {
    "F64": torch.float64, "F32": torch.float32, "F16": torch.float16, "BF16": torch.bfloat16,
    "I64": torch.int64, "I32": torch.int32, "I16": torch.int16, "I8": torch.int8,
    "U8": torch.uint8, "BOOL": torch.bool,
}
_TORCH_TO_ST = {v: k for k, v in _ST_TO_TORCH.items()}


class safe_open:
    """Context manager mirroring ``safetensors.safe_open(path, framework="pt")``."""

    def __init__(self, path: str | Path, framework: str = "pt", device: str = "cpu"):
        if framework != "pt" or device != "cpu":
            raise ValueError("safe_open reads to CPU torch tensors (framework='pt', device='cpu')")
        with open(path, "rb") as f:
            (n,) = struct.unpack("<Q", f.read(8))
            header = json.loads(f.read(n))
            self._map = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_COPY)
        self._metadata = header.pop("__metadata__", None)
        self._start = 8 + n
        self._entries: dict[str, dict[str, Any]] = header

    def __enter__(self) -> "safe_open":
        return self

    def __exit__(self, *exc) -> None:
        pass  # the map lives as long as a tensor that views it

    def keys(self) -> list[str]:
        return sorted(self._entries)

    def metadata(self) -> dict[str, str] | None:
        return self._metadata

    def get_tensor(self, name: str) -> torch.Tensor:
        info = self._entries[name]
        if info["dtype"] not in _ST_TO_TORCH:
            raise ValueError(f"unsupported dtype tag {info['dtype']} for tensor {name}")
        dtype = _ST_TO_TORCH[info["dtype"]]
        begin, end = info["data_offsets"]
        shape = list(info["shape"])
        numel = 1
        for d in shape:
            numel *= d
        if end - begin != numel * dtype.itemsize:
            raise ValueError(f"tensor {name}: {end - begin} bytes for shape {shape} of {info['dtype']}")
        if numel == 0:
            return torch.empty(shape, dtype=dtype)
        return torch.frombuffer(self._map, dtype=dtype, count=numel, offset=self._start + begin).reshape(shape)


def load_file(path: str | Path) -> dict[str, torch.Tensor]:
    f = safe_open(path)
    return {k: f.get_tensor(k) for k in f.keys()}


def save_file(tensors: Mapping[str, torch.Tensor], path: str | Path, metadata: Mapping[str, str] | None = None) -> None:
    """Write a safetensors file that the ``safetensors`` package reads."""
    items = sorted(tensors.items(), key=lambda kv: (-kv[1].element_size(), kv[0]))
    header: dict[str, Any] = {}
    if metadata is not None:
        header["__metadata__"] = dict(metadata)
    offset = 0
    for name, t in items:
        if t.dtype not in _TORCH_TO_ST:
            raise ValueError(f"unsupported dtype for safetensors: {t.dtype} ({name})")
        nbytes = t.numel() * t.element_size()
        header[name] = {"dtype": _TORCH_TO_ST[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + nbytes]}
        offset += nbytes
    raw = json.dumps(header, separators=(",", ":"), ensure_ascii=False).encode()
    raw += b" " * (-len(raw) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(raw)))
        f.write(raw)
        for _, t in items:
            if t.numel():
                f.write(t.detach().contiguous().cpu().reshape(-1).view(torch.uint8).numpy())
