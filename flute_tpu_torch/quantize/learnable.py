"""NFL: learned-scale quantization calibration, counterpart of
``flute_tpu/quantize/learnable.py``.

``LearnableQuantizedLinear`` holds a frozen dense weight (a buffer) and
trainable per-group scales (an ``nn.Parameter``); its forward is
straight-through fake quantization followed by the dense product.
``learn_scales`` trains only the scales against the causal-LM loss with
``torch.optim.Adam`` (optax's ``adam``: the same betas and eps, eps outside
the square root, no weight decay). Tensors are in the kernel orientation
(``[K, N]`` weights, ``[K/g, N]`` scales), so ``finalize`` packs without a
transpose of the learned scales' meaning.
"""

from __future__ import annotations

from typing import Callable, Iterable, Optional

import numpy as np
import torch
from torch import nn

from flute_tpu_torch.quantize import nf


class LearnableQuantizedLinear(nn.Module):
    """Fake-quantized linear with trainable per-group scales.

    ``weight``: frozen dense ``[K, N]`` (in, out), f32. ``scales``:
    trainable ``[K // group_size, N]``, initialized to the group absmax.
    ``table``: ``[2^b]`` ascending float32. The parameters are the JAX
    layer's fields in its order, ``(weight, scales, table, bias, num_bits,
    group_size)``, so that its positional form builds the same layer.
    """

    def __init__(
        self,
        weight: torch.Tensor,
        scales: torch.Tensor,
        table: torch.Tensor,
        bias: Optional[torch.Tensor] = None,
        num_bits: int = 4,
        group_size: int = 64,
    ):
        super().__init__()
        self.register_buffer("weight", weight)
        self.scales = nn.Parameter(scales)
        self.register_buffer("table", table)
        self.register_buffer("bias", bias)
        self.num_bits = num_bits
        self.group_size = group_size

    def fake_quantized_weight(self, dtype: Optional[torch.dtype] = None) -> torch.Tensor:
        """STE fake quantization of the frozen weight: the codes are chosen
        without a gradient (``searchsorted`` over the table's pivots, left
        side), and the value is ``table[codes] * scales``, so the scales'
        gradient is ``table[codes]`` times the weight's."""
        dtype = dtype or self.weight.dtype
        k, n = self.weight.shape
        g = self.group_size
        with torch.no_grad():
            wg = self.weight.float().reshape(k // g, g, n)
            s = self.scales.float()[:, None, :]
            s_safe = torch.where(s == 0, torch.ones_like(s), s)
            pivots = nf.nf_pivots(self.table.float())
            codes = torch.searchsorted(pivots, (wg / s_safe).contiguous(), right=False)
        vals = self.table.to(dtype)[codes]
        deq = vals * self.scales.float()[:, None, :].to(dtype)
        return deq.reshape(k, n).to(dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w_fq = self.fake_quantized_weight(x.dtype)
        y = torch.matmul(x.float(), w_fq.float()).to(x.dtype)
        if self.bias is not None:
            y = y + self.bias.to(y.dtype)
        return y


def make_learnable(
    weight_in_out,
    num_bits: int = 4,
    group_size: int = 64,
    symmetric: Optional[bool] = None,
) -> LearnableQuantizedLinear:
    """Wrap a dense ``[in, out]`` weight with absmax-initialized learnable
    scales, on the weight's device.

    ``symmetric`` (default True for 4-bit) trains against the ascending
    sign-symmetric NF grid, so that ``finalize`` lands on the w4sym layout."""
    w = torch.as_tensor(weight_in_out).detach().float()
    k, n = w.shape
    if symmetric is None:
        symmetric = num_bits == 4
    if symmetric:
        if num_bits != 4:
            raise ValueError("symmetric NF requires num_bits=4")
        table = nf.nf_values_symmetric_exact(num_bits)
    else:
        table = nf.nf_values(num_bits, symmetric=False)
    absmax = w.reshape(k // group_size, group_size, n).abs().amax(dim=1)
    return LearnableQuantizedLinear(
        w, absmax, torch.from_numpy(np.asarray(table)).to(w.device),
        num_bits=num_bits, group_size=group_size,
    )


def finalize(layer: LearnableQuantizedLinear, **quant_kwargs):
    """Quantize the frozen weight with the learned scales into a packed
    :class:`flute_tpu_torch.nn.QuantizedLinear`."""
    from flute_tpu_torch.nn import quantize_linear

    return quantize_linear(
        layer.weight.T,  # [out, in]
        layer.num_bits,
        layer.group_size,
        custom_scales=layer.scales.detach().T,  # [N, K/g]
        table=layer.table,
        bias=layer.bias,
        **quant_kwargs,
    )


# The seven projection matrices of each block, the layers that are calibrated.
PROJ_KEYS = ("q", "k", "v", "o", "gate", "up", "down")


def make_model_learnable(params: dict, num_bits: int, group_size: int) -> dict:
    """Swap every projection leaf of a Llama-layout params tree for a
    :class:`LearnableQuantizedLinear`."""
    out = dict(params)
    out["layers"] = []
    for layer in params["layers"]:
        new_layer = dict(layer)
        for key in PROJ_KEYS:
            w = layer[key]
            if not isinstance(w, LearnableQuantizedLinear):
                new_layer[key] = make_learnable(w, num_bits, group_size)
        out["layers"].append(new_layer)
    return out


def finalize_model(params: dict, **quant_kwargs) -> dict:
    """Turn every LearnableQuantizedLinear back into a packed
    QuantizedLinear with its learned scales."""
    out = dict(params)
    out["layers"] = []
    for layer in params["layers"]:
        new_layer = dict(layer)
        for key, v in layer.items():
            if isinstance(v, LearnableQuantizedLinear):
                new_layer[key] = finalize(v, **quant_kwargs)
        out["layers"].append(new_layer)
    return out


def split_scales(params: dict) -> tuple[dict, dict]:
    """The trainable scales of a learnable params tree, by ``"<layer>/<key>"``,
    and the tree itself. Rejoin with :func:`merge_scales`."""
    scales = {}
    for li, layer in enumerate(params["layers"]):
        for key, v in layer.items():
            if isinstance(v, LearnableQuantizedLinear):
                scales[f"{li}/{key}"] = v.scales
    return scales, params


def merge_scales(scales: dict, params: dict) -> dict:
    """A copy of ``params`` whose learnable layers take the scales of
    ``scales`` (the other tensors shared)."""
    out = dict(params)
    out["layers"] = []
    for li, layer in enumerate(params["layers"]):
        new_layer = dict(layer)
        for key, v in layer.items():
            sk = f"{li}/{key}"
            if sk in scales:
                new_layer[key] = LearnableQuantizedLinear(
                    v.weight, scales[sk], v.table, v.bias,
                    num_bits=v.num_bits, group_size=v.group_size,
                )
        out["layers"].append(new_layer)
    return out


def clm_loss(params: dict, config, tokens: torch.Tensor, forward: Callable) -> torch.Tensor:
    """Next-token cross-entropy over a ``[B, T]`` batch, from a fresh cache."""
    from flute_tpu_torch.models import llama

    b, t = tokens.shape
    cache = llama.init_cache(config, b, t, dtype=config.dtype, device=tokens.device)
    logits, _ = forward(params, config, tokens[:, :-1], cache, 0)
    targets = tokens[:, 1:].long()
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -torch.gather(logp, -1, targets[..., None])[..., 0]
    return nll.mean()


def learn_scales(
    params: dict,
    config,
    batches: Iterable,
    *,
    num_bits: int = 4,
    group_size: int = 64,
    learning_rate: float = 1e-4,
    forward: Optional[Callable] = None,
    callback: Optional[Callable[[int, float], None]] = None,
) -> dict:
    """Optimize the per-group scales against the CLM loss with Adam; returns
    the learnable params tree with the trained scales. Batches are ``[B, T]``
    token arrays, moved to the params' device."""
    from flute_tpu_torch.models import llama

    fwd = forward or llama.forward
    lparams = make_model_learnable(params, num_bits, group_size)
    scales, _ = split_scales(lparams)
    opt = torch.optim.Adam(list(scales.values()), lr=learning_rate, betas=(0.9, 0.999),
                           eps=1e-8, weight_decay=0.0)
    dev = params["embed"].device
    for i, batch in enumerate(batches):
        tokens = torch.as_tensor(np.asarray(batch), dtype=torch.int64).to(dev)
        opt.zero_grad(set_to_none=True)
        loss = clm_loss(lparams, config, tokens, fwd)
        loss.backward()
        opt.step()
        if callback is not None:
            callback(i, loss.item())
    return lparams
