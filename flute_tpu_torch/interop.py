"""Build the port's params from a numpy tree of the JAX package's params.

The tree is what a caller gets by turning every leaf of a ``flute_tpu``
params pytree into numpy: dense arrays stay arrays, and each quantized
linear is a dict with ``planes`` (list of int32 arrays), ``scales``,
``table``, ``pair_values`` and ``bias`` (each may be None), ``num_bits``,
``group_size``, ``layout``, ``config_key`` and ``hadamard_size``. Planes are
carried bit for bit and the chunk rides in the config key; bfloat16 arrays
(numpy dtype named ``bfloat16``) stay bfloat16. A layer whose
``hadamard_size`` is set keeps its rotation: no field is dropped on the way.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from flute_tpu_torch.device import resolve_device
from flute_tpu_torch.nn import QuantizedLinear


def tensor_from_numpy(a, device) -> torch.Tensor:
    """A numpy array as a tensor on ``device``, keeping bfloat16 as
    bfloat16 (through its 16-bit pattern)."""
    a = np.asarray(a)
    if not a.flags.writeable:  # a tensor must own memory it may write
        a = a.copy()
    if a.dtype.name == "bfloat16":
        bits = np.ascontiguousarray(a).view(np.int16)
        return torch.from_numpy(bits).view(torch.bfloat16).to(device)
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


def _quantized_from_numpy(d: dict, device) -> QuantizedLinear:
    def optional(key):
        return None if d.get(key) is None else tensor_from_numpy(d[key], device)

    return QuantizedLinear(
        [tensor_from_numpy(p, device) for p in d["planes"]],
        tensor_from_numpy(d["scales"], device),
        tensor_from_numpy(d["table"], device).float(),
        bias=optional("bias"),
        pair_values=optional("pair_values"),
        num_bits=int(d["num_bits"]),
        group_size=int(d["group_size"]),
        config_key=d.get("config_key"),
        layout=d.get("layout", "auto"),
        hadamard_size=d.get("hadamard_size"),
    )


def params_from_numpy(tree: Any, device=None) -> Any:
    """The port's params for a numpy tree of JAX params, on ``device``
    (``cuda`` unless named)."""
    dev = resolve_device(device)

    def visit(node):
        if isinstance(node, dict):
            if "planes" in node:
                return _quantized_from_numpy(node, dev)
            return {k: visit(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(visit(v) for v in node)
        if node is None:
            return None
        return tensor_from_numpy(node, dev)

    return visit(tree)


def move_params(tree: Any, device) -> Any:
    """A copy of the port's params on ``device`` (quantized modules and
    dense tensors alike)."""
    if isinstance(tree, dict):
        return {k: move_params(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(move_params(v, device) for v in tree)
    if isinstance(tree, QuantizedLinear):
        return QuantizedLinear(
            [p.to(device) for p in tree.planes],
            tree.scales.to(device),
            tree.table.to(device),
            bias=None if tree.bias is None else tree.bias.to(device),
            pair_values=None if tree.pair_values is None else tree.pair_values.to(device),
            num_bits=tree.num_bits,
            group_size=tree.group_size,
            config_key=tree.config_key,
            layout=tree.layout,
            hadamard_size=tree.hadamard_size,
            config=tree.config,
        )
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    return tree
