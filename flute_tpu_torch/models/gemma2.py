"""Gemma-2 in PyTorch, LUT-quantized; counterpart of
``flute_tpu/models/gemma2.py``.

The second model family. Its differences from Llama:

* embeddings scaled by ``sqrt(hidden)`` (rounded to the compute dtype
  first, as the JAX model rounds it) and a tied lm_head;
* RMSNorm with the ``(1 + w)`` convention (:func:`rms_norm_gemma`);
* sandwich norms: the attention and MLP outputs are normalised before
  each residual add;
* a GeGLU MLP (tanh-approximated GELU on the gate);
* attention logits capped at ``tanh(s / 50) * 50`` before the mask, and
  the final logits at ``tanh(l / 30) * 30``;
* even layers attend a sliding window of ``sliding_window`` slots, odd
  layers the whole cache;
* queries scaled by ``query_pre_attn_scalar ** -0.5``, not
  ``head_dim ** -0.5``.

It reuses the Llama building blocks and cache contract, so
:class:`~flute_tpu_torch.serving.Engine` serves it with
``forward=gemma2.forward, init_cache=gemma2.init_cache`` and
:class:`~flute_tpu_torch.serving.PagedEngine` tells it from its config.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from flute_tpu_torch.device import resolve_device
from flute_tpu_torch.models import llama
from flute_tpu_torch.models.llama import (
    apply_linear,
    apply_rope,
    gqa_attention,
    matmul_f32,
    split_fused_qkv,
)
from flute_tpu_torch.nn import QuantizedLinear, quantize_linear
from flute_tpu_torch.parallel.comm import all_reduce_


@dataclasses.dataclass(frozen=True)
class Gemma2Config:
    vocab_size: int = 256128
    hidden_size: int = 3584
    intermediate_size: int = 14336
    num_layers: int = 42
    num_heads: int = 16
    num_kv_heads: int = 8
    head_dim: int = 256
    rms_norm_eps: float = 1e-6
    rope_theta: float = 10000.0
    query_pre_attn_scalar: float = 256.0
    attn_logit_softcap: float = 50.0
    final_logit_softcap: float = 30.0
    sliding_window: int = 4096
    dtype: torch.dtype = torch.bfloat16
    # the rope-scaling fields llama.rope_tables reads (no scaling)
    rope_scaling_factor: Optional[float] = None
    rope_low_freq_factor: float = 1.0
    rope_high_freq_factor: float = 4.0
    rope_original_max_position: int = 8192

    @staticmethod
    def gemma2_9b() -> "Gemma2Config":
        return Gemma2Config()

    @staticmethod
    def gemma2_27b() -> "Gemma2Config":
        return Gemma2Config(
            hidden_size=4608,
            intermediate_size=36864,
            num_layers=46,
            num_heads=32,
            num_kv_heads=16,
            head_dim=128,
            query_pre_attn_scalar=144.0,
        )

    @staticmethod
    def tiny(vocab_size: int = 512) -> "Gemma2Config":
        return Gemma2Config(
            vocab_size=vocab_size,
            hidden_size=256,
            intermediate_size=512,
            num_layers=2,
            num_heads=4,
            num_kv_heads=2,
            head_dim=128,
            sliding_window=8,
        )


def rms_norm_gemma(x: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    """Gemma's RMSNorm: scale by ``(1 + w)``, statistics in f32."""
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * (1.0 + weight.float())).to(x.dtype)


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu(approximate=True)`` op for op, each op rounded to x's
    dtype as the JAX function rounds it (one f32 evaluation rounded once,
    ``torch.nn.functional.gelu(approximate="tanh")``, differs from it in
    about 45% of bf16 results)."""
    c = torch.tensor(math.sqrt(2 / math.pi), dtype=torch.float32).to(x.dtype)
    cdf = 0.5 * (1.0 + torch.tanh(c * (x + 0.044715 * (x * x * x))))
    return x * cdf


def embed_scale(config: Gemma2Config) -> float:
    """``sqrt(hidden)`` rounded to the compute dtype (59.75 at 3584 in
    bf16), the JAX model's ``jnp.asarray(hidden**0.5, dtype)``."""
    return float(torch.tensor(config.hidden_size**0.5, dtype=config.dtype))


def attention_options(config: Gemma2Config, li: int) -> dict:
    """Layer ``li``'s query scale, logit softcap and window (even layers
    slide, in Hugging Face's order), as the paged kernels take them."""
    return dict(scale=config.query_pre_attn_scalar**-0.5, softcap=config.attn_logit_softcap,
                window=config.sliding_window if li % 2 == 0 else None)


def capped_logits(config: Gemma2Config, logits: torch.Tensor) -> torch.Tensor:
    """The final logit softcap in the logits' dtype (f32 from the dense
    head, the compute dtype from a quantized one, as the JAX model caps
    them), returned in f32."""
    cap = config.final_logit_softcap
    return (torch.tanh(logits / cap) * cap).float()


def _block(
    params: dict,
    config: Gemma2Config,
    x: torch.Tensor,
    cos: torch.Tensor,
    sin: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    pos,
    mask: torch.Tensor,  # [B, T, S], the sliding window already in it
    group=None,  # the tp process group: all-reduces after o and down
) -> torch.Tensor:
    b, t, _ = x.shape
    d = config.head_dim
    eps = config.rms_norm_eps
    h = rms_norm_gemma(x, params["attn_norm"], eps)
    if "qkv" in params:
        q, k, v = split_fused_qkv(apply_linear(params["qkv"], h), config.num_heads,
                                  config.num_kv_heads, d)
    else:
        q = apply_linear(params["q"], h).reshape(b, t, -1, d)
        k = apply_linear(params["k"], h).reshape(b, t, -1, d)
        v = apply_linear(params["v"], h).reshape(b, t, -1, d)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    llama._cache_update(k_cache, k, pos)
    llama._cache_update(v_cache, v, pos)
    attn = gqa_attention(q, k_cache, v_cache, mask, scale=config.query_pre_attn_scalar**-0.5,
                         logit_softcap=config.attn_logit_softcap)
    o = all_reduce_(apply_linear(params["o"], attn.reshape(b, t, -1)), group)
    x = x + rms_norm_gemma(o, params["post_attn_norm"], eps)

    h = rms_norm_gemma(x, params["mlp_norm"], eps)
    if "gate_up" in params:
        gu = apply_linear(params["gate_up"], h)
        inter = gu.shape[-1] // 2
        gate, up = gu[..., :inter], gu[..., inter:]
    else:
        gate = apply_linear(params["gate"], h)
        up = apply_linear(params["up"], h)
    down = all_reduce_(apply_linear(params["down"], gelu_tanh(gate) * up), group)
    return x + rms_norm_gemma(down, params["post_mlp_norm"], eps)


def init_cache(config: Gemma2Config, batch: int, max_len: int, dtype=None, device=None) -> dict:
    """Preallocated KV cache, as :func:`flute_tpu_torch.models.llama.init_cache`."""
    return llama.init_cache(config, batch, max_len, dtype=dtype, device=device)


def forward(
    params: dict,
    config: Gemma2Config,
    tokens: torch.Tensor,  # [B, T] integer
    cache: dict,
    pos,  # int or 0-dim/[B] tensor: cache slot of tokens[:, 0]
    position_offsets: Optional[torch.Tensor] = None,  # [B] left-pad widths
    group=None,  # the tp process group (parallel.tp_model_forward)
) -> tuple[torch.Tensor, dict]:
    """The contract of :func:`flute_tpu_torch.models.llama.forward`:
    capped f32 logits ``[B, T, vocab]`` and the cache, written in place."""
    x = params["embed"][tokens.long()].to(config.dtype) * embed_scale(config)
    pos, slots, causal, cos, sin = llama.step_positions(config, tokens, cache, pos,
                                                        position_offsets)
    # the sliding layers see only the last `sliding_window` slots
    js = torch.arange(causal.shape[-1], device=tokens.device)[None, None, :]
    window = causal & (js > slots[:, :, None] - config.sliding_window)
    for li, layer in enumerate(params["layers"]):
        mask = window if li % 2 == 0 else causal
        x = _block(layer, config, x, cos, sin, cache["k"][li], cache["v"][li], pos, mask,
                   group)

    x = rms_norm_gemma(x, params["final_norm"], config.rms_norm_eps)
    head = params.get("lm_head")
    if isinstance(head, QuantizedLinear):
        # the quantized copy of the tied head, its vocabulary padded
        logits = head(x)[..., :config.vocab_size]
    else:
        # the tied head: the embedding's transposed view, never copied
        logits = matmul_f32(x, params["embed"].T)
    return capped_logits(config, logits), cache


def init_params(
    config: Gemma2Config,
    rng=llama._DEFAULT_RNG,
    scale: float = 0.02,
    *,
    seed: Optional[int] = None,
    device=None,
) -> dict:
    """Dense random params (linear leaves ``[in, out]``, norms zero, as
    ``(1 + w)`` wants them, no ``lm_head``: it is tied) on ``device``.

    The parameters before ``*`` are JAX's ``init_params(config, rng=0,
    scale=0.02)``; ``seed`` and ``device`` are keyword-only. ``rng`` draws
    JAX's values with numpy on the host; ``seed``, or neither (as
    ``seed=0``, the default), draws with a ``torch.Generator`` on the
    device (:func:`flute_tpu_torch.models.llama.init_params`)."""
    randn, dev = llama._normal_draws(config, rng, seed, scale, device)
    c = config
    qdim = c.num_heads * c.head_dim
    kvdim = c.num_kv_heads * c.head_dim

    def zeros(n):
        return torch.zeros((n,), dtype=c.dtype, device=dev)

    layers = []
    for _ in range(c.num_layers):
        layers.append(
            {
                "attn_norm": zeros(c.hidden_size),
                "q": randn(c.hidden_size, qdim),
                "k": randn(c.hidden_size, kvdim),
                "v": randn(c.hidden_size, kvdim),
                "o": randn(qdim, c.hidden_size),
                "post_attn_norm": zeros(c.hidden_size),
                "mlp_norm": zeros(c.hidden_size),
                "gate": randn(c.hidden_size, c.intermediate_size),
                "up": randn(c.hidden_size, c.intermediate_size),
                "down": randn(c.intermediate_size, c.hidden_size),
                "post_mlp_norm": zeros(c.hidden_size),
            }
        )
    return {
        "embed": randn(c.vocab_size, c.hidden_size),
        "layers": layers,
        "final_norm": zeros(c.hidden_size),
    }


def quantize_model(
    params: dict,
    num_bits: int = 4,
    group_size: int = 64,
    *,
    example_batch_size: int = 8,
    chunk: Optional[int] = None,
    fuse: bool = False,
    quantize_lm_head: bool = False,
    symmetric: Optional[bool] = None,
    device=None,
) -> dict:
    """Quantize every block's projections with Llama's walker
    (:func:`flute_tpu_torch.models.llama.quantize_model`); the embedding
    and norms stay dense.

    ``quantize_lm_head=True`` quantizes a copy of the tied head: the
    embedding ``[vocab, hidden]``, already ``[out, in]``, with zero rows to
    a multiple of 2048, into ``lm_head`` (with the blocks' ``chunk``, as the
    JAX model quantizes it); the dense embedding keeps serving the input
    lookups, and ``forward`` slices the logits back before the softcap."""
    out = llama.quantize_model(params, num_bits, group_size,
                               example_batch_size=example_batch_size, chunk=chunk, fuse=fuse,
                               symmetric=symmetric, device=device)
    if quantize_lm_head:
        dev = resolve_device(device)
        kw = {"chunk": chunk} if chunk is not None else {}
        out["lm_head"] = quantize_linear(llama.pad_rows(params["embed"].to(dev)), num_bits,
                                         group_size, example_batch_size=example_batch_size,
                                         device=dev, **kw)
    return out
