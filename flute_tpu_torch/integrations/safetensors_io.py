"""A small reader and writer of the safetensors file format.

The importers read HF checkpoint shards and the tests and ``chip_smoke.py``
write them; the port carries this module so that neither needs the
``safetensors`` package. The format: an 8-byte little-endian header length
``n``, ``n`` bytes of JSON (``{"__metadata__": {...}, name: {"dtype",
"shape", "data_offsets"}, ...}``, padded with spaces to a multiple of 8),
then the tensors' raw little-endian bytes, each at its ``data_offsets``
from the end of the header. Tensors are torch tensors (bfloat16 included)
or numpy arrays. :func:`save_file` writes the bytes the ``safetensors``
package writes for the same tensors: the tensors laid out by dtype, widest
first in the package's order, then by name.
"""

from __future__ import annotations

import json
import os
import struct
from typing import Iterator, Optional

import numpy as np
import torch

# the safetensors dtype names in the package's order (the writer lays the
# tensors out from the last of these to the first)
_ORDER = ("BOOL", "U8", "I8", "F8_E5M2", "F8_E4M3", "I16", "U16", "F16", "BF16", "I32",
          "U32", "F32", "F64", "I64", "U64")
_TORCH = {
    "BOOL": torch.bool, "U8": torch.uint8, "I8": torch.int8, "I16": torch.int16,
    "F16": torch.float16, "BF16": torch.bfloat16, "I32": torch.int32, "F32": torch.float32,
    "F64": torch.float64, "I64": torch.int64,
}
for _name, _attr in (("U16", "uint16"), ("U32", "uint32"), ("U64", "uint64"),
                     ("F8_E5M2", "float8_e5m2"), ("F8_E4M3", "float8_e4m3fn")):
    if hasattr(torch, _attr):
        _TORCH[_name] = getattr(torch, _attr)
_NAME = {dt: name for name, dt in _TORCH.items()}


def _as_tensor(value) -> torch.Tensor:
    """A CPU tensor holding ``value``'s bytes (a numpy bfloat16 array, which
    torch cannot take directly, through its 16-bit pattern)."""
    if isinstance(value, torch.Tensor):
        return value.detach().cpu().contiguous()
    a = np.ascontiguousarray(value)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy() if not a.flags.writeable else a)


def _raw(t: torch.Tensor) -> bytes:
    if t.numel() == 0:
        return b""
    return t.reshape(-1).view(torch.uint8).numpy().tobytes()


def save_file(tensors: dict, path: str, metadata: Optional[dict] = None) -> None:
    """Write ``{name: tensor or array}`` to ``path`` in the safetensors
    format, with the string-valued ``metadata`` in ``__metadata__``."""
    items = []
    for name, value in tensors.items():
        t = _as_tensor(value)
        if t.dtype not in _NAME:
            raise ValueError(f"{name}: dtype {t.dtype} has no safetensors name")
        items.append((name, t, _NAME[t.dtype]))
    items.sort(key=lambda it: (-_ORDER.index(it[2]), it[0]))
    header: dict = {}
    if metadata:
        header["__metadata__"] = {str(k): str(v) for k, v in metadata.items()}
    offset = 0
    for name, t, dtype in items:
        nbytes = t.numel() * t.element_size()
        header[name] = {"dtype": dtype, "shape": list(t.shape),
                        "data_offsets": [offset, offset + nbytes]}
        offset += nbytes
    blob = json.dumps(header, separators=(",", ":")).encode()
    blob += b" " * (-len(blob) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(blob)))
        f.write(blob)
        for _, t, _ in items:
            f.write(_raw(t))


class SafeOpen:
    """One safetensors file, read a tensor at a time: ``keys()`` in name
    order (as the package's ``safe_open`` lists them), ``get_tensor(name)``
    as a CPU tensor, ``metadata()``.
    Use as a context manager, as the ``safetensors`` package's
    ``safe_open``."""

    def __init__(self, path: str):
        self.path = path
        self._f = open(path, "rb")
        (n,) = struct.unpack("<Q", self._f.read(8))
        header = json.loads(self._f.read(n))
        self._meta = header.pop("__metadata__", None)
        self._start = 8 + n
        self._entries = dict(sorted(header.items()))

    def __enter__(self) -> "SafeOpen":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def close(self) -> None:
        self._f.close()

    def keys(self) -> list[str]:
        return list(self._entries)

    def metadata(self) -> Optional[dict]:
        return self._meta

    def get_tensor(self, name: str) -> torch.Tensor:
        e = self._entries[name]
        dtype = _TORCH[e["dtype"]]
        begin, end = e["data_offsets"]
        shape = tuple(e["shape"])
        if end == begin:
            return torch.empty(shape, dtype=dtype)
        self._f.seek(self._start + begin)
        buf = bytearray(end - begin)
        if self._f.readinto(buf) != len(buf):
            raise ValueError(f"{self.path}: tensor {name} is cut short")
        return torch.frombuffer(buf, dtype=dtype).reshape(shape)


def load_file(path: str) -> dict[str, torch.Tensor]:
    """Every tensor of a safetensors file, as CPU tensors."""
    with SafeOpen(path) as f:
        return {name: f.get_tensor(name) for name in f.keys()}


def iter_dir(model_dir: str) -> Iterator[tuple[str, torch.Tensor]]:
    """``(name, tensor)`` of every ``.safetensors`` file in ``model_dir``,
    the files and each file's names in sorted order, one tensor read at a
    time."""
    files = sorted(f for f in os.listdir(model_dir) if f.endswith(".safetensors"))
    if not files:
        raise FileNotFoundError(f"no safetensors files in {model_dir}")
    for fn in files:
        with SafeOpen(os.path.join(model_dir, fn)) as f:
            for name in f.keys():
                yield name, f.get_tensor(name)
