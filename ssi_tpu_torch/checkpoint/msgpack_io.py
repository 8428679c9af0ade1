"""The msgpack subset that the schema-v1 training state uses, first-party (the
``msgpack`` package may be absent where the port runs).

``pack`` gives the bytes that ``ssi_tpu/checkpoint/__init__.py`` ``pack_state``
(``msgpack.packb(state, default=_msgpack_default, strict_types=False)``)
gives for the same tree, and ``unpack`` reads them back
(``tests/test_torch_msgpack.py`` holds both directions against it):

- nil, bool, int (the smallest format that holds it: positive and negative
  fixint, uint 8-64 for positive values, int 8-64 for negative ones), float
  (float64), str (fixstr / str 8-32, UTF-8), bin 8-32, array (list and tuple)
  and map (in the dict's order), as ``msgpack.Packer``'s defaults write them;
- arrays as ext type 42 holding the packed ``[dtype, shape, raw bytes]``
  (C order, little-endian; bfloat16 as its uint16 bits with dtype
  ``"bfloat16"``). A torch tensor (on any device) or a numpy array is
  written so; numpy integer and floating scalars as ``int`` and ``float``.

``pack_to_file`` streams: each array's bytes go to the file leaf by leaf
(a device tensor is copied to the host one leaf at a time), so a state of
gigabytes is never held as one ``bytes`` object. ``load`` maps the file and
decodes from the map. Arrays decode to numpy arrays, bfloat16 to a torch
bfloat16 tensor (numpy has no bfloat16 without ``ml_dtypes``).
"""

from __future__ import annotations

import io
import mmap
import struct
from pathlib import Path
from typing import Any, BinaryIO, Callable

import numpy as np
import torch

__all__ = ["NDARRAY_EXT", "load", "pack", "pack_to_file", "unpack"]

NDARRAY_EXT = 42

_TORCH_DTYPE_NAMES = {
    torch.float64: "float64", torch.float32: "float32", torch.float16: "float16", torch.bfloat16: "bfloat16",
    torch.int64: "int64", torch.int32: "int32", torch.int16: "int16", torch.int8: "int8", torch.uint8: "uint8",
    torch.bool: "bool",
}


# ---------------------------------------------------------------------------
# Encoding
# ---------------------------------------------------------------------------


def _int(n: int) -> bytes:
    if n < 0:
        if n >= -32:
            return struct.pack("b", n)
        if n >= -(1 << 7):
            return b"\xd0" + struct.pack(">b", n)
        if n >= -(1 << 15):
            return b"\xd1" + struct.pack(">h", n)
        if n >= -(1 << 31):
            return b"\xd2" + struct.pack(">i", n)
        if n >= -(1 << 63):
            return b"\xd3" + struct.pack(">q", n)
        raise TypeError(f"Cannot serialize an int outside the 64-bit range: {n}")
    if n < 1 << 7:
        return struct.pack("B", n)
    if n < 1 << 8:
        return b"\xcc" + struct.pack(">B", n)
    if n < 1 << 16:
        return b"\xcd" + struct.pack(">H", n)
    if n < 1 << 32:
        return b"\xce" + struct.pack(">I", n)
    if n < 1 << 64:
        return b"\xcf" + struct.pack(">Q", n)
    raise TypeError(f"Cannot serialize an int outside the 64-bit range: {n}")


def _str(s: str) -> bytes:
    raw = s.encode("utf-8")
    n = len(raw)
    if n < 32:
        return bytes([0xA0 | n]) + raw
    if n < 1 << 8:
        return b"\xd9" + struct.pack(">B", n) + raw
    if n < 1 << 16:
        return b"\xda" + struct.pack(">H", n) + raw
    return b"\xdb" + struct.pack(">I", n) + raw


def _bin_header(n: int) -> bytes:
    if n < 1 << 8:
        return b"\xc4" + struct.pack(">B", n)
    if n < 1 << 16:
        return b"\xc5" + struct.pack(">H", n)
    return b"\xc6" + struct.pack(">I", n)


def _container_header(n: int, fix: int, h16: bytes, h32: bytes) -> bytes:
    if n < 16:
        return bytes([fix | n])
    if n < 1 << 16:
        return h16 + struct.pack(">H", n)
    return h32 + struct.pack(">I", n)


def _ext_header(code: int, n: int) -> bytes:
    fixed = {1: b"\xd4", 2: b"\xd5", 4: b"\xd6", 8: b"\xd7", 16: b"\xd8"}
    if n in fixed:
        return fixed[n] + struct.pack("b", code)
    if n < 1 << 8:
        return b"\xc7" + struct.pack(">Bb", n, code)
    if n < 1 << 16:
        return b"\xc8" + struct.pack(">Hb", n, code)
    return b"\xc9" + struct.pack(">Ib", n, code)


def _array_parts(obj: torch.Tensor | np.ndarray) -> tuple[str, list[int], Callable[[], Any], int]:
    """(dtype name, shape, a thunk giving the host bytes as a buffer, byte count)."""
    if isinstance(obj, torch.Tensor):
        if obj.dtype not in _TORCH_DTYPE_NAMES:
            raise TypeError(f"Cannot serialize a tensor of dtype {obj.dtype}")
        name, shape = _TORCH_DTYPE_NAMES[obj.dtype], list(obj.shape)

        def host() -> Any:
            t = obj.detach().to("cpu").contiguous()
            return (t.view(torch.int16) if t.dtype == torch.bfloat16 else t).numpy().reshape(-1).view(np.uint8)

        return name, shape, host, obj.numel() * obj.element_size()
    is_bf16 = obj.dtype.name == "bfloat16"  # an ml_dtypes array, where one is given
    name, shape = ("bfloat16" if is_bf16 else str(obj.dtype)), list(obj.shape)

    def host_np() -> Any:
        arr = np.ascontiguousarray(obj.view(np.uint16) if is_bf16 else obj)
        return arr.reshape(-1).view(np.uint8)

    return name, shape, host_np, obj.nbytes


def _pack_into(obj: Any, write: Callable[[Any], Any]) -> None:
    if obj is None:
        write(b"\xc0")
    elif isinstance(obj, bool):
        write(b"\xc3" if obj else b"\xc2")
    elif isinstance(obj, int):
        write(_int(obj))
    elif isinstance(obj, float):
        write(b"\xcb" + struct.pack(">d", obj))
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        raw = bytes(obj)
        write(_bin_header(len(raw)) + raw)
    elif isinstance(obj, str):
        write(_str(obj))
    elif isinstance(obj, dict):
        write(_container_header(len(obj), 0x80, b"\xde", b"\xdf"))
        for key, value in obj.items():
            _pack_into(key, write)
            _pack_into(value, write)
    elif isinstance(obj, (list, tuple)):
        write(_container_header(len(obj), 0x90, b"\xdc", b"\xdd"))
        for item in obj:
            _pack_into(item, write)
    elif isinstance(obj, (torch.Tensor, np.ndarray)):
        name, shape, host, nbytes = _array_parts(obj)
        head = b"\x93" + _str(name) + pack(shape) + _bin_header(nbytes)  # [dtype, shape, raw]
        write(_ext_header(NDARRAY_EXT, len(head) + nbytes) + head)
        if nbytes:
            write(host())
    elif isinstance(obj, np.integer):
        write(_int(int(obj)))
    elif isinstance(obj, np.floating):
        write(b"\xcb" + struct.pack(">d", float(obj)))
    else:
        raise TypeError(f"Cannot serialize object of type {type(obj)}")


def pack(obj: Any) -> bytes:
    """The msgpack bytes of ``obj`` (``pack_state``'s)."""
    buf = io.BytesIO()
    _pack_into(obj, buf.write)
    return buf.getvalue()


def pack_to_file(obj: Any, f: BinaryIO) -> None:
    """Write ``pack(obj)`` to the open binary file ``f``, array by array."""
    _pack_into(obj, f.write)


# ---------------------------------------------------------------------------
# Decoding
# ---------------------------------------------------------------------------


class _Reader:
    def __init__(self, buf: Any) -> None:
        self.buf = memoryview(buf)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.buf):
            raise ValueError("msgpack data ends early")
        out = self.buf[self.pos : self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str) -> Any:
        size = struct.calcsize(fmt)
        return struct.unpack(fmt, self.take(size))[0]

    def value(self) -> Any:
        b = self.unpack("B")
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self._map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return [self.value() for _ in range(b & 0x0F)]
        if 0xA0 <= b <= 0xBF:
            return str(self.take(b & 0x1F), "utf-8")
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if b in simple:
            return simple[b]
        fixed = {0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
                 0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
        if b in fixed:
            return self.unpack(fixed[b])
        lengths = {0xC4: ">B", 0xC5: ">H", 0xC6: ">I", 0xD9: ">B", 0xDA: ">H", 0xDB: ">I",
                   0xDC: ">H", 0xDD: ">I", 0xDE: ">H", 0xDF: ">I", 0xC7: ">B", 0xC8: ">H", 0xC9: ">I"}
        if b in lengths:
            n = self.unpack(lengths[b])
            if b <= 0xC6:
                return bytes(self.take(n))
            if b >= 0xD9 and b <= 0xDB:
                return str(self.take(n), "utf-8")
            if b in (0xDC, 0xDD):
                return [self.value() for _ in range(n)]
            if b in (0xDE, 0xDF):
                return self._map(n)
            return self._ext(self.unpack(">b"), n)
        fixext = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
        if b in fixext:
            return self._ext(self.unpack(">b"), fixext[b])
        raise ValueError(f"msgpack format byte 0x{b:02x} is not in the subset this reader decodes")

    def _map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            key = self.value()
            out[key] = self.value()
        return out

    def _ext(self, code: int, n: int) -> Any:
        if code != NDARRAY_EXT:
            raise ValueError(f"msgpack ext type {code} is not the array ext ({NDARRAY_EXT}) this reader decodes")
        end = self.pos + n
        if self.unpack("B") != 0x93:
            raise ValueError("array ext: expected [dtype, shape, raw]")
        dtype, shape = self.value(), self.value()
        b = self.unpack("B")
        nbytes = self.unpack({0xC4: ">B", 0xC5: ">H", 0xC6: ">I"}[b])
        raw = self.take(nbytes)
        if self.pos != end:
            raise ValueError("array ext: length does not match its contents")
        if dtype == "bfloat16":
            flat = torch.frombuffer(bytearray(raw), dtype=torch.bfloat16) if nbytes else torch.empty(0, dtype=torch.bfloat16)
            return flat.reshape(shape)
        return np.frombuffer(raw, dtype=np.dtype(dtype)).reshape(shape).copy()


def unpack(data: Any) -> Any:
    """Decode one msgpack value from a bytes-like object (``unpack_state``'s result,
    arrays as described in the module docstring)."""
    reader = _Reader(data)
    out = reader.value()
    if reader.pos != len(reader.buf):
        raise ValueError(f"{len(reader.buf) - reader.pos} bytes of extra data after the msgpack value")
    return out


def load(path: str | Path) -> Any:
    """Decode a msgpack file from a map of it (no copy of the whole file)."""
    with open(path, "rb") as f:
        if Path(path).stat().st_size == 0:
            raise ValueError(f"{path} is empty")
        with mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ) as mapped:
            view = memoryview(mapped)
            try:
                return unpack(view)
            finally:
                view.release()
