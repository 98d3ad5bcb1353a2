"""Quantized module layer, counterpart of ``flute_tpu/nn.py``.

``QuantizedLinear`` is an ``nn.Module`` whose packed planes, scales, table,
optional pair table and bias are buffers, and whose quantization metadata
(``num_bits``, ``group_size``, ``layout``, ``config_key`` and the ``chunk``
it carries) are attributes. ``layout`` must travel with the module: the
w4sym layout has the plane shape of classic W4 and cannot be told from it.
``from_codes`` builds one from codes computed elsewhere (importers,
checkpoints). A config a tuner chose (``flute_tpu_torch.tune``) rides on the
module beside its key: the key, which is what a checkpoint keeps, never
carries the tuned Hopper launch. A layer with ``hadamard_size`` rotates x
(a grouped Hadamard transform) before the GEMM, as HIGGS checkpoints need.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import numpy as np
import torch
from torch import nn

from flute_tpu_torch import packing
from flute_tpu_torch.device import resolve_device
from flute_tpu_torch.ops import lut_gemm
from flute_tpu_torch.ops.kernel_config import KernelConfig, get_kernel_config
from flute_tpu_torch.quantize import nf


class QuantizedLinear(nn.Module):
    """A LUT-quantized linear layer: ``y = x @ dequant(W) + bias``.

    Tensor contract (that of :func:`flute_tpu_torch.ops.lut_gemm.lut_qgemm`):
    planes packed int32 for logical codes ``[K, N]`` (K = in_features,
    N = out_features); scales ``[K // group_size, N]`` in the compute dtype;
    table float32 ``[2^num_bits]``; optional ``pair_values`` float32
    ``[2^b, 2^b, 2]``, a joint table for K-row pairs (HIGGS vector
    dequantization) that replaces ``table``; optional bias ``[N]``.

    ``hadamard_size``: when set, x is rotated by the grouped Hadamard
    transform of that size before the GEMM (HIGGS layers); None = none.
    ``config``: the config itself, with a tuner's launch, given in place
    of ``config_key``.

    The parameters before ``config`` are the JAX layer's fields in its
    order, ``(planes, scales, table, pair_values, bias, num_bits,
    group_size, config_key, hadamard_size, layout)``, so that its
    positional form builds the same layer; ``config`` is keyword-only.
    """

    def __init__(
        self,
        planes,
        scales: torch.Tensor,
        table: torch.Tensor,
        pair_values: Optional[torch.Tensor] = None,
        bias: Optional[torch.Tensor] = None,
        num_bits: int = 4,
        group_size: int = 64,
        config_key: Optional[str] = None,
        hadamard_size: Optional[int] = None,
        layout: str = "auto",
        *,
        config: Optional[KernelConfig] = None,
    ):
        super().__init__()
        self.num_planes = len(planes)
        for i, p in enumerate(planes):
            self.register_buffer(f"plane{i}", p)
        self.register_buffer("scales", scales)
        self.register_buffer("table", table)
        self.register_buffer("pair_values", pair_values)
        self.register_buffer("bias", bias)
        self.num_bits = num_bits
        self.group_size = group_size
        # the config with its tuned launch; ``config_key`` is its key
        self._config = config if config is not None or config_key is None else \
            KernelConfig.from_key(config_key)
        self.layout = layout
        self.hadamard_size = hadamard_size

    @property
    def planes(self) -> tuple[torch.Tensor, ...]:
        return tuple(getattr(self, f"plane{i}") for i in range(self.num_planes))

    @property
    def in_features(self) -> int:
        return self.scales.shape[0] * self.group_size

    @property
    def out_features(self) -> int:
        return self.scales.shape[1]

    @property
    def config(self) -> Optional[KernelConfig]:
        """The layer's config: its key parsed, with the launch a tuner chose
        where one did."""
        return self._config

    @property
    def config_key(self) -> Optional[str]:
        """The persisted form of :attr:`config` (never holds the tuned
        launch)."""
        return None if self._config is None else self._config.key()

    @property
    def chunk(self) -> int:
        """Pack chunk of the planes (part of the layout, kept in the key)."""
        return (self.config or KernelConfig()).chunk

    def with_config(self, config: Optional[KernelConfig]) -> "QuantizedLinear":
        """The same layer (sharing its tensors) with another config (its
        tuned launch kept on the module)."""
        return self.replace(config=config)

    def replace(self, **changes) -> "QuantizedLinear":
        """A new layer with some of ``planes``, ``scales``, ``table``,
        ``bias``, ``pair_values`` and ``config`` replaced; it shares every
        other tensor with this one."""
        fields = dict(planes=self.planes, scales=self.scales, table=self.table,
                      bias=self.bias, pair_values=self.pair_values, config=self.config)
        unknown = set(changes) - set(fields)
        if unknown:
            raise TypeError(f"cannot replace {sorted(unknown)}")
        fields.update(changes)
        return QuantizedLinear(
            fields["planes"], fields["scales"], fields["table"], bias=fields["bias"],
            pair_values=fields["pair_values"], num_bits=self.num_bits,
            group_size=self.group_size, config=fields["config"],
            layout=self.layout, hadamard_size=self.hadamard_size,
        )

    @property
    def kernel_layout(self) -> str:
        """The kernel layout of the layer's calls (the argument of
        :func:`~flute_tpu_torch.ops.kernel_config.kernel_layout`): ``"pair"``
        with a pair table, else ``"w4sym"``, ``"w3wide"`` or ``"plane"``."""
        if self.pair_values is not None:
            return "pair"
        if self.layout != "auto":
            return self.layout
        wide = packing.is_w3_wide(self.planes, self.num_bits, self.in_features)
        return "w3wide" if wide else "plane"

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.hadamard_size is not None:
            from flute_tpu_torch.ops.hadamard import grouped_hadamard_transform

            x = grouped_hadamard_transform(x, self.hadamard_size)
        y = lut_gemm.lut_qgemm(
            x,
            list(self.planes),
            self.scales,
            self.table,
            num_bits=self.num_bits,
            config=self.config,
            pair_values=self.pair_values,
            layout=self.layout,
        )
        if self.bias is not None:
            y = y + self.bias.to(y.dtype)
        return y

    def dequantize(self, dtype=torch.bfloat16) -> torch.Tensor:
        """Materialize the dense ``[in, out]`` weight (for tests/debug)."""
        codes = packing.unpack(
            list(self.planes), self.num_bits, chunk=self.chunk, layout=self.layout
        )
        if self.pair_values is not None:
            return lut_gemm.dequantize_codes_pair(codes, self.scales, self.pair_values, dtype)
        return lut_gemm.dequantize_codes(codes, self.scales, self.table, dtype)

    def extra_repr(self) -> str:
        return (
            f"in={self.in_features}, out={self.out_features}, bits={self.num_bits}, "
            f"group={self.group_size}, layout={self.layout}, chunk={self.chunk}"
            + ("" if self.hadamard_size is None else f", hadamard={self.hadamard_size}")
        )


def _pack(codes_kn: torch.Tensor, num_bits: int, chunk: int, wide: bool, layout: str):
    """Pack on the codes' device with the torch packers."""
    if layout == "w4sym":
        return [packing.pack_w4_sym(codes_kn, chunk=chunk)]
    if wide:
        return [packing.pack_w3_wide(codes_kn, chunk=chunk)]
    return packing.pack_plane(codes_kn, num_bits, chunk=chunk)


def quantize_linear(
    weight,
    num_bits: int = 4,
    group_size: int = 64,
    *,
    bias: Optional[torch.Tensor] = None,
    dtype: torch.dtype = torch.bfloat16,
    custom_scales: Optional[torch.Tensor] = None,
    table=None,
    example_batch_size: int = 8,
    config: Optional[KernelConfig] = None,
    chunk: int = packing.DEFAULT_CHUNK,
    wide: Optional[bool] = None,
    symmetric: Optional[bool] = None,
    device=None,
) -> QuantizedLinear:
    """NF-quantize a dense ``[out, in]`` weight into a :class:`QuantizedLinear`.

    Runs on ``device``: by default the weight's own device for a tensor,
    else ``cuda`` (with no GPU, pass ``device="cpu"``).

    The layer is keyed with ``config`` (default: what
    :func:`~flute_tpu_torch.ops.kernel_config.get_kernel_config` gives for
    ``example_batch_size`` rows, the planner's launch unless the tuner's
    registry holds the shape), its chunk set to ``chunk``.

    ``symmetric``: quantize against the sign-symmetric NF grid and pack the
    w4sym layout (4-bit only). Default: True for 4-bit when no table was
    supplied. A supplied ``table`` is used as-is; if it meets the
    sign-symmetric contract, in sign-magnitude or ascending order, the
    w4sym layout is chosen.
    """
    if isinstance(weight, torch.Tensor) and device is None:
        dev = weight.device
    else:
        dev = resolve_device(device)
    w = torch.as_tensor(weight).to(dev)
    if custom_scales is not None:
        custom_scales = custom_scales.to(dev)
    if symmetric is None:
        symmetric = num_bits == 4 and table is None and chunk % 8 == 0
    layout = "auto"
    if table is None:
        if symmetric:
            if num_bits != 4:
                raise ValueError("symmetric NF quantization requires num_bits=4")
            _, codes, scales, table = nf.nf_quantize_symmetric(
                w, num_bits, group_size, custom_scales=custom_scales
            )
            layout = "w4sym"
        else:
            _, codes, scales, table = nf.nf_quantize(
                w, num_bits, group_size, custom_scales=custom_scales
            )
    else:
        table = torch.as_tensor(table, dtype=torch.float32).to(dev)
        t_np = table.cpu().numpy()
        if num_bits == 4 and packing.is_symmetric_table(t_np, num_bits):
            # sign-magnitude-ordered symmetric table: quantize via the
            # ascending view, map codes back, pack the w4sym layout
            order = torch.from_numpy(np.argsort(t_np)).to(dev)
            _, codes_sorted, scales = nf.quantize_with_table(
                w, table[order], group_size, custom_scales
            )
            codes = order.to(torch.int32)[codes_sorted.long()]
            layout = "w4sym"
        elif num_bits == 4 and packing.is_ascending_symmetric_table(t_np, num_bits):
            # ascending symmetric table (e.g. learnable grids): reorder to
            # sign-magnitude codes and take the w4sym layout
            table_sym, perm = packing.sym_code_order(t_np)
            _, codes_asc, scales = nf.quantize_with_table(
                w, table, group_size, custom_scales
            )
            codes = torch.from_numpy(perm).to(dev, torch.int32)[codes_asc.long()]
            table = torch.from_numpy(table_sym).to(dev)
            layout = "w4sym"
        else:
            _, codes, scales = nf.quantize_with_table(
                w, table, group_size, custom_scales
            )
    codes_kn = codes.T.contiguous()  # [K, N]
    if wide is None:
        wide = num_bits == 3 and chunk % 256 == 0
    elif wide and (num_bits != 3 or chunk % 256 != 0):
        raise ValueError("wide layout requires num_bits=3 and chunk % 256 == 0")
    planes = _pack(codes_kn, num_bits, chunk, wide, layout)
    scales_kn = scales.T.to(dtype).contiguous()  # [K/g, N]
    if config is None:
        n, k = w.shape
        kernel = layout if layout != "auto" else ("w3wide" if wide else "plane")
        config = get_kernel_config(example_batch_size, n, k, num_bits, group_size, dtype=dtype,
                                   layout=kernel)
    return QuantizedLinear(
        planes,
        scales_kn,
        table.to(device=dev, dtype=torch.float32),
        bias=None if bias is None else torch.as_tensor(bias).to(dev),
        num_bits=num_bits,
        group_size=group_size,
        config_key=dataclasses.replace(config, chunk=chunk).key(),
        layout=layout,
    )


def from_codes(
    codes_kn,
    scales_kn: torch.Tensor,
    table,
    num_bits: int,
    group_size: int,
    *,
    pair_values: Optional[torch.Tensor] = None,
    bias: Optional[torch.Tensor] = None,
    config: Optional[KernelConfig] = None,
    example_batch_size: int = 8,
    chunk: int = packing.DEFAULT_CHUNK,
    device=None,
) -> QuantizedLinear:
    """A :class:`QuantizedLinear` from pre-computed ``[K, N]`` codes (the
    entry point of importers and checkpoints), packed in the pair-plane
    layout on ``device``: the codes' device for a tensor, else ``cuda``
    unless named. ``table`` None means zeros (for a layer that looks its
    values up in ``pair_values``). ``config`` is kept as the layer's key
    with its chunk set to ``chunk`` (default: ``KernelConfig()``).
    ``example_batch_size`` is kept for the JAX signature: this key does not
    depend on it."""
    del example_batch_size
    if isinstance(codes_kn, torch.Tensor) and device is None:
        dev = codes_kn.device
    else:
        dev = resolve_device(device)
    codes_kn = torch.as_tensor(codes_kn).to(dev)
    if table is None:
        table = torch.zeros((2**num_bits,), dtype=torch.float32)
    return QuantizedLinear(
        packing.pack_plane(codes_kn, num_bits, chunk=chunk),
        torch.as_tensor(scales_kn).to(dev),
        torch.as_tensor(table, dtype=torch.float32).to(dev),
        bias=None if bias is None else torch.as_tensor(bias).to(dev),
        pair_values=None if pair_values is None else torch.as_tensor(
            pair_values, dtype=torch.float32
        ).to(dev),
        num_bits=num_bits,
        group_size=group_size,
        config_key=dataclasses.replace(config or KernelConfig(), chunk=chunk).key(),
    )


def quantize_params(
    params: Any,
    num_bits: int = 4,
    group_size: int = 64,
    *,
    dtype: torch.dtype = torch.bfloat16,
    predicate: Optional[Callable[[tuple, torch.Tensor], bool]] = None,
    example_batch_size: int = 8,
) -> Any:
    """Walk a nested dict/list of tensors, replacing 2-D ``[out, in]``
    weights with :class:`QuantizedLinear` modules on the weight's device,
    each keyed for ``example_batch_size`` rows (:func:`quantize_linear`).

    ``predicate(path, leaf)`` selects the leaves (``path`` is the tuple of
    keys and indices); default: every 2-D tensor whose in-dim divides by
    ``group_size`` and by the pack chunk. 1-D leaves are untouched.
    """

    def default_predicate(path, leaf):
        if not (isinstance(leaf, torch.Tensor) and leaf.ndim == 2):
            return False
        k = leaf.shape[1]
        return k % group_size == 0 and k % packing.DEFAULT_CHUNK == 0

    pred = predicate or default_predicate

    def visit(path, node):
        if isinstance(node, dict):
            return {k: visit(path + (k,), v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(visit(path + (i,), v) for i, v in enumerate(node))
        if isinstance(node, torch.Tensor) and pred(path, node):
            return quantize_linear(node, num_bits, group_size, dtype=dtype,
                                   example_batch_size=example_batch_size)
        return node

    return visit((), params)
