"""Quantized-checkpoint I/O, counterpart of
``flute_tpu/integrations/checkpoint.py``, in the same on-disk format.

A checkpoint is a directory holding one ``.npy`` file per tensor, a
``manifest.json`` and a ``flute_config.json`` sidecar
(``{version, num_bits, group_size, model_config}``). The manifest lists the
params tree's leaves in the JAX package's flattening order (dict keys
sorted, lists in order, ``None`` leaves left out) by their ``/``-joined
path. A dense leaf is an ``array`` entry; a :class:`QuantizedLinear` is a
``quantized_linear`` entry with its ``num_bits``, ``group_size``,
``config_key``, ``hadamard_size`` and ``layout`` and the files of its
``planes.<i>``, ``scales``, ``table`` and, where set, ``pair_values`` and
``bias``. bfloat16 is stored as its uint16 bit pattern, the file reference
marked ``#bf16``. So a checkpoint written by either package loads in the
other, and for the same params both write the same manifest and the same
bytes in every file.
"""

from __future__ import annotations

import json
import os
import re
from typing import Any, Optional

import numpy as np
import torch

from flute_tpu_torch.device import resolve_device
from flute_tpu_torch.nn import QuantizedLinear
from flute_tpu_torch.version import __version__

_MANIFEST = "manifest.json"
_SIDECAR = "flute_config.json"


def _safe_name(path_str: str) -> str:
    return re.sub(r"[^A-Za-z0-9_.-]", "_", path_str)


def _leaves(node, path=()):
    """(path, leaf) in the JAX package's flattening order."""
    if isinstance(node, dict):
        for k in sorted(node):
            yield from _leaves(node[k], path + (str(k),))
    elif isinstance(node, (list, tuple)):
        for i, v in enumerate(node):
            yield from _leaves(v, path + (str(i),))
    elif node is not None:
        yield "/".join(path), node


def _store(root: str, key: str, arr) -> str:
    """Save one tensor (or array) as ``<key>.npy``; returns its reference."""
    fname = _safe_name(key) + ".npy"
    if isinstance(arr, torch.Tensor):
        # C order whatever the strides (a transposed view too), as the JAX
        # package writes
        t = arr.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            np.save(os.path.join(root, fname), t.view(torch.int16).numpy().view(np.uint16))
            return fname + "#bf16"
        a = t.numpy()
    else:
        a = np.ascontiguousarray(arr)
    np.save(os.path.join(root, fname), a)
    return fname


def _load_arr(root: str, ref: str, device) -> torch.Tensor:
    if ref.endswith("#bf16"):
        a = np.load(os.path.join(root, ref[: -len("#bf16")]))
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(np.load(os.path.join(root, ref))).to(device)


def _quantized_entry(root: str, tree_path: str, planes, scales, table, *, pair_values,
                     bias, num_bits, group_size, config_key, hadamard_size, layout) -> dict:
    tensors = {}
    for i, p in enumerate(planes):
        tensors[f"planes.{i}"] = _store(root, f"{tree_path}.planes.{i}", p)
    tensors["scales"] = _store(root, f"{tree_path}.scales", scales)
    tensors["table"] = _store(root, f"{tree_path}.table", table)
    if pair_values is not None:
        tensors["pair_values"] = _store(root, f"{tree_path}.pair_values", pair_values)
    if bias is not None:
        tensors["bias"] = _store(root, f"{tree_path}.bias", bias)
    return {
        "path": tree_path,
        "type": "quantized_linear",
        "num_bits": num_bits,
        "group_size": group_size,
        "config_key": config_key,
        "hadamard_size": hadamard_size,
        "layout": layout,
        "tensors": tensors,
    }


def _finish(path: str, entries: list, model_config, num_bits, group_size) -> None:
    with open(os.path.join(path, _MANIFEST), "w") as f:
        json.dump({"version": __version__, "entries": entries}, f, indent=1)
    sidecar = {
        "version": __version__,
        "num_bits": num_bits,
        "group_size": group_size,
        "model_config": model_config,
    }
    with open(os.path.join(path, _SIDECAR), "w") as f:
        json.dump(sidecar, f, indent=1)


def save_quantized(
    path: str,
    params: Any,
    *,
    model_config: Optional[dict] = None,
    num_bits: Optional[int] = None,
    group_size: Optional[int] = None,
) -> None:
    """Write a params tree (dense tensors and :class:`QuantizedLinear`
    modules in nested dicts and lists) to the directory ``path``."""
    os.makedirs(path, exist_ok=True)
    entries = []
    for ps, leaf in _leaves(params):
        if isinstance(leaf, QuantizedLinear):
            entries.append(_quantized_entry(
                path, ps, leaf.planes, leaf.scales, leaf.table,
                pair_values=leaf.pair_values, bias=leaf.bias, num_bits=leaf.num_bits,
                group_size=leaf.group_size, config_key=leaf.config_key,
                hadamard_size=leaf.hadamard_size, layout=leaf.layout,
            ))
        else:
            entries.append({"path": ps, "type": "array",
                            "tensors": {"value": _store(path, ps, leaf)}})
    _finish(path, entries, model_config, num_bits, group_size)


class StreamingWriter:
    """Writes the format of :func:`save_quantized` one leaf at a time, each
    tensor flushed to disk as it is added, for models whose quantized tree
    never has to be held whole."""

    def __init__(self, path: str):
        self.path = path
        os.makedirs(path, exist_ok=True)
        self.entries: list[dict] = []

    def add_array(self, tree_path: str, arr) -> None:
        self.entries.append({"path": tree_path, "type": "array",
                             "tensors": {"value": _store(self.path, tree_path, arr)}})

    def add_none(self, tree_path: str) -> None:
        self.entries.append({"path": tree_path, "type": "none"})

    def add_quantized(
        self,
        tree_path: str,
        planes,
        scales,
        table,
        *,
        num_bits: int,
        group_size: int,
        config_key: Optional[str] = None,
        bias=None,
        layout: str = "auto",
        pair_values=None,
    ) -> None:
        self.entries.append(_quantized_entry(
            self.path, tree_path, planes, scales, table, pair_values=pair_values, bias=bias,
            num_bits=num_bits, group_size=group_size, config_key=config_key,
            hadamard_size=None, layout=layout,
        ))

    def finish(
        self,
        *,
        model_config: Optional[dict] = None,
        num_bits: Optional[int] = None,
        group_size: Optional[int] = None,
    ) -> None:
        _finish(self.path, self.entries, model_config, num_bits, group_size)


def load_quantized(path: str, device=None) -> tuple[Any, dict]:
    """Load a checkpoint onto ``device`` (``cuda`` unless named); returns
    (params tree, sidecar dict). Lists come back as lists."""
    dev = resolve_device(device)
    with open(os.path.join(path, _MANIFEST)) as f:
        manifest = json.load(f)
    with open(os.path.join(path, _SIDECAR)) as f:
        sidecar = json.load(f)

    tree: dict = {}
    for e in manifest["entries"]:
        parts = e["path"].split("/")
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        key = parts[-1]
        tensors = e.get("tensors", {})

        def load(name):
            return _load_arr(path, tensors[name], dev) if name in tensors else None

        if e["type"] == "none":
            node[key] = None
        elif e["type"] == "array":
            node[key] = load("value")
        else:
            planes = []
            while f"planes.{len(planes)}" in tensors:
                planes.append(load(f"planes.{len(planes)}"))
            node[key] = QuantizedLinear(
                planes,
                load("scales"),
                load("table"),
                bias=load("bias"),
                pair_values=load("pair_values"),
                num_bits=e["num_bits"],
                group_size=e["group_size"],
                config_key=e.get("config_key"),
                # checkpoints older than the w4sym layout carry no layout
                layout=e.get("layout", "auto"),
                hadamard_size=e.get("hadamard_size"),
            )
    return _listify(tree), sidecar


def _listify(node):
    """Dicts whose keys are the integers 0..n-1 become lists."""
    if isinstance(node, dict):
        conv = {k: _listify(v) for k, v in node.items()}
        if conv and all(re.fullmatch(r"\d+", k) for k in conv):
            idx = sorted(conv, key=int)
            if [int(i) for i in idx] == list(range(len(idx))):
                return [conv[i] for i in idx]
        return conv
    return node
