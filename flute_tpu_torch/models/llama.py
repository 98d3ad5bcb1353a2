"""Llama-3/3.1 in PyTorch, LUT-quantized; counterpart of
``flute_tpu/models/llama.py``.

Params are a plain dict in the JAX package's layout (``embed``, ``layers``
[a list of per-block dicts], ``final_norm``, ``lm_head``), so weights carry
over leaf for leaf. Linear leaves are dense ``[in, out]`` tensors or
:class:`flute_tpu_torch.nn.QuantizedLinear` modules.

Numerics follow the JAX model: RMSNorm statistics in f32; RoPE cos/sin
cast to the compute dtype before the rotation; attention scores in f32
with a finite -1e30 mask and probabilities cast back to the compute dtype;
dense projections accumulate in f32 and round to the compute dtype; the
dense lm_head returns f32 logits from an f32-accumulated product.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import numpy as np
import torch

from flute_tpu_torch.device import resolve_device
from flute_tpu_torch.nn import QuantizedLinear, quantize_linear
from flute_tpu_torch.parallel.comm import all_reduce_


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 128256
    hidden_size: int = 4096
    intermediate_size: int = 14336
    num_layers: int = 32
    num_heads: int = 32
    num_kv_heads: int = 8
    head_dim: int = 128
    rms_norm_eps: float = 1e-5
    rope_theta: float = 500000.0
    # Llama-3.1 rope scaling ("llama3" type); None disables.
    rope_scaling_factor: Optional[float] = 8.0
    rope_low_freq_factor: float = 1.0
    rope_high_freq_factor: float = 4.0
    rope_original_max_position: int = 8192
    tie_word_embeddings: bool = False
    dtype: torch.dtype = torch.bfloat16

    @staticmethod
    def llama3_8b() -> "LlamaConfig":
        return LlamaConfig(rope_scaling_factor=None)

    @staticmethod
    def llama31_8b() -> "LlamaConfig":
        return LlamaConfig()

    @staticmethod
    def llama31_70b() -> "LlamaConfig":
        return LlamaConfig(
            hidden_size=8192,
            intermediate_size=28672,
            num_layers=80,
            num_heads=64,
            num_kv_heads=8,
        )

    @staticmethod
    def llama31_405b() -> "LlamaConfig":
        return LlamaConfig(
            hidden_size=16384,
            intermediate_size=53248,
            num_layers=126,
            num_heads=128,
            num_kv_heads=8,
        )

    @staticmethod
    def tiny(vocab_size: int = 512) -> "LlamaConfig":
        """A miniature config for tests: real architecture (GQA, RoPE
        scaling, SwiGLU), toy sizes aligned to pack chunks."""
        return LlamaConfig(
            vocab_size=vocab_size,
            hidden_size=256,
            intermediate_size=512,
            num_layers=2,
            num_heads=4,
            num_kv_heads=2,
            head_dim=128,
        )


# ---------------------------------------------------------------------------
# Building blocks
# ---------------------------------------------------------------------------


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * weight.float()).to(x.dtype)


def _matmul_upcast(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.matmul(a.float(), b.float())


def matmul_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` with an f32 result, the JAX model's
    ``preferred_element_type=float32`` product. On CUDA, for 16-bit operands
    of one dtype, one cuBLAS product of the operands as they are (``mm`` /
    ``bmm`` with ``out_dtype``; a transposed view is passed without a copy):
    a product of two bf16 or f16 values is exact in f32, so only the order of
    the f32 sums differs from the upcast product. Otherwise (the CPU, f32)
    the product of the f32 upcasts, which is also taken where autograd must
    pass through the product (NFL's calibration loss): ``out_dtype`` has no
    derivative. ``a`` is ``[..., m, k]`` and ``b`` ``[k, n]`` or
    ``[..., k, n]`` with the same leading dims."""
    if a.device.type != "cuda" or a.dtype not in (torch.bfloat16, torch.float16) \
            or b.dtype != a.dtype \
            or (torch.is_grad_enabled() and (a.requires_grad or b.requires_grad)):
        return _matmul_upcast(a, b)
    if b.ndim == 2:
        out = torch.mm(a.reshape(-1, a.shape[-1]), b, out_dtype=torch.float32)
        return out.reshape(*a.shape[:-1], b.shape[-1])
    lead = a.shape[:-2]
    out = torch.bmm(a.reshape(-1, *a.shape[-2:]), b.reshape(-1, *b.shape[-2:]),
                    out_dtype=torch.float32)
    return out.reshape(*lead, *out.shape[-2:])


def apply_linear(layer, x: torch.Tensor) -> torch.Tensor:
    """A quantized module, or a dense ``[in, out]`` tensor cast to x's dtype,
    multiplied with f32 accumulation and rounded to x's dtype."""
    if isinstance(layer, torch.nn.Module):
        return layer(x)
    return torch.matmul(x.float(), layer.to(x.dtype).float()).to(x.dtype)


def split_fused_qkv(
    qkv: torch.Tensor, num_heads: int, num_kv_heads: int, head_dim: int
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Split a fused qkv projection output [B, T, W] into (q, k, v) heads."""
    b, t, w = qkv.shape
    d = head_dim
    total = (num_heads + 2 * num_kv_heads) * d
    f, rem = divmod(total, w)
    if rem or num_heads % f or num_kv_heads % f:
        raise ValueError(
            f"fused qkv width {w} is not a 1/tp slice of {total} "
            f"(heads {num_heads}/{num_kv_heads} must divide by tp)"
        )
    qd = num_heads * d // f
    kvd = num_kv_heads * d // f
    q = qkv[..., :qd].reshape(b, t, -1, d)
    k = qkv[..., qd:qd + kvd].reshape(b, t, -1, d)
    v = qkv[..., qd + kvd:].reshape(b, t, -1, d)
    return q, k, v


def _rope_inv_freq(config: LlamaConfig) -> np.ndarray:
    d = config.head_dim
    inv = 1.0 / (config.rope_theta ** (np.arange(0, d, 2, dtype=np.float64) / d))
    if config.rope_scaling_factor is not None:
        # Llama-3.1 NTK-by-parts scaling (HF "llama3" rope type)
        factor = config.rope_scaling_factor
        low = config.rope_original_max_position / config.rope_low_freq_factor
        high = config.rope_original_max_position / config.rope_high_freq_factor
        wavelen = 2 * np.pi / inv
        smooth = (config.rope_original_max_position / wavelen - config.rope_low_freq_factor) / (
            config.rope_high_freq_factor - config.rope_low_freq_factor
        )
        smooth = np.clip(smooth, 0.0, 1.0)
        scaled = (1 - smooth) * inv / factor + smooth * inv
        inv = np.where(wavelen > low, inv / factor, np.where(wavelen < high, inv, scaled))
    return inv.astype(np.float32)


@functools.lru_cache(maxsize=None)
def _inv_freq(config, device: torch.device) -> torch.Tensor:
    """The inverse frequencies on ``device``, made once per (config,
    device): a step must not copy them from the host (a CUDA graph cannot
    capture that copy)."""
    return torch.from_numpy(_rope_inv_freq(config)).to(device)


def rope_tables(
    config: LlamaConfig, positions: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """cos/sin tables ``[B, T, head_dim//2]`` for integer positions [B, T]."""
    ang = positions.float()[..., None] * _inv_freq(config, positions.device)
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Rotate ``[B, T, H, D]`` (half-split convention, as HF Llama)."""
    d2 = x.shape[-1] // 2
    x1, x2 = x[..., :d2], x[..., d2:]
    cos = cos[:, :, None, :].to(x.dtype)
    sin = sin[:, :, None, :].to(x.dtype)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def gqa_attention(
    q: torch.Tensor,  # [B, T, H, D]
    k: torch.Tensor,  # [B, Hkv, S, D] (head-major cache layout)
    v: torch.Tensor,  # [B, Hkv, S, D]
    mask: torch.Tensor,  # [B, T, S] bool (True = attend)
    *,
    scale: Optional[float] = None,
    logit_softcap: Optional[float] = None,
) -> torch.Tensor:
    """GQA attention over a head-major KV cache, in plain matmul/softmax:
    f32 scores and f32 sums of the products, a finite -1e30 mask,
    probabilities in the compute dtype. ``logit_softcap`` (Gemma-2) caps the
    scaled scores at ``tanh(s / cap) * cap`` in f32, before the mask.

    A decode step (T = 1) multiplies the 16-bit operands with f32 results
    (:func:`matmul_f32`), never copying the cache. A prefill block takes the
    product of the f32 upcasts: that adds each row's terms in K order, so the
    zeros of left padding leave its sums as they are, and a prompt's
    first-token logits do not depend on where a batch's padding puts it in
    the cache; tensor-core sums group the products by 16 from the start of
    the cache, and over 32 layers that grouping alone moves the logits by a
    few percent."""
    b, t, h, d = q.shape
    hkv = k.shape[1]
    rep = h // hkv
    scale = scale if scale is not None else d**-0.5
    mm = matmul_f32 if t == 1 else _matmul_upcast
    qm = q.reshape(b, t, hkv, rep, d).permute(0, 2, 3, 1, 4).reshape(b, hkv, rep * t, d)
    scores = mm(qm, k.transpose(-1, -2)) * scale
    scores = scores.reshape(b, hkv, rep, t, -1)
    if logit_softcap is not None:
        scores = torch.tanh(scores / logit_softcap) * logit_softcap
    scores = scores.masked_fill(~mask[:, None, None, :, :], -1e30)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    out = mm(probs.reshape(b, hkv, rep * t, -1), v)
    out = out.reshape(b, hkv, rep, t, d).permute(0, 3, 1, 2, 4)
    return out.reshape(b, t, h, d).to(q.dtype)


# ---------------------------------------------------------------------------
# KV cache
# ---------------------------------------------------------------------------


def init_cache(
    config: LlamaConfig, batch: int, max_len: int, dtype=None, device=None
) -> dict:
    """Preallocated KV cache: per-layer head-major [B, Hkv, S, D] tensors."""
    dev = resolve_device(device)
    dtype = dtype or config.dtype
    shape = (batch, config.num_kv_heads, max_len, config.head_dim)
    return {
        "k": [torch.zeros(shape, dtype=dtype, device=dev) for _ in range(config.num_layers)],
        "v": [torch.zeros(shape, dtype=dtype, device=dev) for _ in range(config.num_layers)],
    }


def _cache_update(cache_layer: torch.Tensor, new: torch.Tensor, pos) -> None:
    """Write ``new`` [B, T, Hkv, D] into the [B, Hkv, S, D] cache at slot
    ``pos`` (an int, a 0-dim tensor, or a [B] tensor of one slot per
    sequence).

    Unlike the JAX model, which returns an updated copy, this writes in place
    into the preallocated cache: a slice assignment for an int slot, an
    ``index_copy_`` for a 0-dim tensor (the slot stays on the device), an
    indexed write for per-sequence slots."""
    new = new.to(cache_layer.dtype)
    t = new.shape[1]
    if isinstance(pos, int):
        cache_layer[:, :, pos:pos + t] = new.transpose(1, 2)
        return
    if pos.ndim == 0:
        cache_layer.index_copy_(2, pos + torch.arange(t, device=pos.device),
                                new.transpose(1, 2))
        return
    b = new.shape[0]
    slots = pos[:, None] + torch.arange(t, device=pos.device)[None, :]  # [B, T]
    rows = torch.arange(b, device=pos.device)[:, None]
    cache_layer[rows, :, slots] = new  # advanced dims first: [B, T, Hkv, D]


# ---------------------------------------------------------------------------
# Forward pass
# ---------------------------------------------------------------------------


def _block(
    params: dict,
    config: LlamaConfig,
    x: torch.Tensor,  # [B, T, hidden]
    cos: torch.Tensor,
    sin: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    pos,  # int, 0-dim tensor, or [B] tensor of per-sequence slots
    mask: torch.Tensor,  # [B, T, S]
    group=None,  # the tp process group under tensor parallelism
) -> torch.Tensor:
    """One transformer block. Under tensor parallelism (``group`` set) the
    params are this rank's slices: q/k/v/gate/up column-parallel, o/down
    row-parallel, each followed by one all-reduce, two per block. Head
    counts come from the local tensors, so the same code runs sharded and
    whole."""
    b, t, _ = x.shape
    d = config.head_dim
    h = rms_norm(x, params["attn_norm"], config.rms_norm_eps)
    if "qkv" in params:
        qkv = apply_linear(params["qkv"], h)
        q, k, v = split_fused_qkv(qkv, config.num_heads, config.num_kv_heads, d)
    else:
        q = apply_linear(params["q"], h).reshape(b, t, -1, d)
        k = apply_linear(params["k"], h).reshape(b, t, -1, d)
        v = apply_linear(params["v"], h).reshape(b, t, -1, d)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    _cache_update(k_cache, k, pos)
    _cache_update(v_cache, v, pos)
    attn = gqa_attention(q, k_cache, v_cache, mask)
    x = x + all_reduce_(apply_linear(params["o"], attn.reshape(b, t, -1)), group)

    h = rms_norm(x, params["mlp_norm"], config.rms_norm_eps)
    if "gate_up" in params:
        gu = apply_linear(params["gate_up"], h)
        inter = gu.shape[-1] // 2
        gate, up = gu[..., :inter], gu[..., inter:]
    else:
        gate = apply_linear(params["gate"], h)
        up = apply_linear(params["up"], h)
    down = apply_linear(params["down"], torch.nn.functional.silu(gate) * up)
    return x + all_reduce_(down, group)


def step_positions(config, tokens: torch.Tensor, cache: dict, pos, position_offsets):
    """What a step's blocks share: ``pos`` (an int, or a tensor on the
    tokens' device), the cache slots ``[1|B, T]``, the causal mask
    ``[B, T, S]`` (query in slot ``pos + i`` attends cache slot ``j`` iff
    ``j <= pos + i`` and ``j`` is not a left-pad slot) and the RoPE tables."""
    b, t = tokens.shape
    dev = tokens.device
    s = cache["k"][0].shape[2]
    if isinstance(pos, torch.Tensor):
        pos = pos.to(device=dev, dtype=torch.int64)
        pos_col = pos[:, None] if pos.ndim == 1 else pos
    else:
        pos = int(pos)
        pos_col = pos
    slots = pos_col + torch.arange(t, device=dev)[None, :]  # [1|B, T]
    if position_offsets is None:
        positions = slots.expand(b, t)
    else:
        offs = position_offsets.to(device=dev, dtype=torch.int64)
        positions = torch.clamp(slots - offs[:, None], min=0)
    cos, sin = rope_tables(config, positions)
    js = torch.arange(s, device=dev)[None, None, :]
    mask = (js <= slots[:, :, None]).expand(b, t, s)
    if position_offsets is not None:
        mask = mask & (js >= offs[:, None, None])
    return pos, slots, mask, cos, sin


def forward(
    params: dict,
    config: LlamaConfig,
    tokens: torch.Tensor,  # [B, T] integer
    cache: dict,
    pos,  # int or 0-dim/[B] tensor: cache slot of tokens[:, 0]
    position_offsets: Optional[torch.Tensor] = None,  # [B] left-pad widths
    group=None,  # the tp process group (parallel.tp_model_forward)
) -> tuple[torch.Tensor, dict]:
    """Run the model over a token chunk, returning f32 logits [B, T, vocab]
    and the cache (updated in place). Prefill (T = chunk) and decode (T = 1).
    With a tp ``group`` the params and cache are this rank's slices and
    the logits come out whole.

    Ragged batches are left-padded: sequence i's real tokens start at slot
    ``position_offsets[i]``; its RoPE position at slot j is
    ``j - position_offsets[i]`` and earlier slots are masked out.

    ``pos`` as a tensor stays on the device: slots, mask and cache writes
    come from it with no host read, so the step can be captured in a CUDA
    graph and replayed with a new ``pos`` written into the same tensor. An
    int gives the same bits.
    """
    x = params["embed"][tokens.long()].to(config.dtype)
    pos, _, mask, cos, sin = step_positions(config, tokens, cache, pos, position_offsets)
    for li, layer in enumerate(params["layers"]):
        x = _block(layer, config, x, cos, sin, cache["k"][li], cache["v"][li], pos, mask,
                   group)
    return head_logits(params, config, x), cache


def head_logits(params: dict, config: LlamaConfig, x: torch.Tensor) -> torch.Tensor:
    """f32 logits of the last block's output ``x``: the final norm, then the
    lm_head (the embedding's transpose when tied)."""
    x = rms_norm(x, params["final_norm"], config.rms_norm_eps)
    head = params["lm_head"] if params.get("lm_head") is not None else params["embed"].T
    if isinstance(head, QuantizedLinear):
        # a quantized head's vocabulary is padded (quantize_model)
        logits = head(x)[..., :config.vocab_size]
    else:
        # f32 logits from an f32-accumulated product, never rounded to bf16;
        # the head (a transposed view when tied) is never copied
        logits = matmul_f32(x, head)
    return logits.float()


# ---------------------------------------------------------------------------
# Random init and quantization
# ---------------------------------------------------------------------------


class _DefaultRng(int):
    """The default of ``init_params``'s ``rng``: 0, as in JAX's signature,
    but an object of its own, so that a call that passes neither ``rng`` nor
    ``seed`` is told apart from ``rng=0``."""

    def __repr__(self) -> str:
        return "0"


_DEFAULT_RNG = _DefaultRng(0)
# numpy's casts from float64 (JAX casts numpy inputs as numpy does)
_NUMPY_DTYPES = {torch.float16: np.float16, torch.float32: np.float32,
                 torch.float64: np.float64}


def _normal_draws(config, rng, seed: Optional[int], scale: float, device):
    """``randn(*shape)`` for ``init_params``: normal draws times ``scale``,
    in ``config.dtype``, on ``device`` (resolved and returned beside it).

    With ``rng`` (an int or a ``np.random.Generator``) the draws are JAX's:
    numpy's ``standard_normal`` in float64, times ``scale``, cast on the
    host as JAX casts them. Otherwise a ``torch.Generator`` seeded with
    ``seed`` (0 when None) draws on the device, which is quicker at full
    width."""
    dev = resolve_device(device)
    if rng is not _DEFAULT_RNG:
        if seed is not None:
            raise ValueError("init_params takes rng (the JAX package's numpy draws) or seed "
                             "(a torch.Generator's), not both")
        if not isinstance(rng, np.random.Generator):
            rng = np.random.default_rng(rng)

        def randn(*shape):
            w = rng.standard_normal(shape) * scale
            np_dtype = _NUMPY_DTYPES.get(config.dtype)
            w = torch.from_numpy(w.astype(np_dtype) if np_dtype else w)
            return w.to(device=dev, dtype=config.dtype)

        return randn, dev
    gen = torch.Generator(device=dev)
    gen.manual_seed(0 if seed is None else seed)

    def randn(*shape):
        w = torch.randn(shape, generator=gen, device=dev, dtype=torch.float32)
        return (w * scale).to(config.dtype)

    return randn, dev


def init_params(
    config: LlamaConfig,
    rng=_DEFAULT_RNG,
    scale: float = 0.02,
    *,
    seed: Optional[int] = None,
    device=None,
) -> dict:
    """Dense random params (linear leaves ``[in, out]``) on ``device``.

    The parameters before ``*`` are JAX's ``init_params(config, rng=0,
    scale=0.02)``; ``seed`` and ``device`` are keyword-only. An ``rng``
    (an int or a ``np.random.Generator``) draws JAX's values: numpy on the
    host, in JAX's order. ``seed`` draws with a ``torch.Generator`` on the
    device instead, and so does a call that passes neither, as with
    ``seed=0``: that is the default, quick at full width. Passing both
    raises."""
    randn, dev = _normal_draws(config, rng, seed, scale, device)
    c = config
    qdim = c.num_heads * c.head_dim
    kvdim = c.num_kv_heads * c.head_dim

    def ones(n):
        return torch.ones((n,), dtype=c.dtype, device=dev)

    layers = []
    for _ in range(c.num_layers):
        layers.append(
            {
                "attn_norm": ones(c.hidden_size),
                "q": randn(c.hidden_size, qdim),
                "k": randn(c.hidden_size, kvdim),
                "v": randn(c.hidden_size, kvdim),
                "o": randn(qdim, c.hidden_size),
                "mlp_norm": ones(c.hidden_size),
                "gate": randn(c.hidden_size, c.intermediate_size),
                "up": randn(c.hidden_size, c.intermediate_size),
                "down": randn(c.intermediate_size, c.hidden_size),
            }
        )
    return {
        "embed": randn(c.vocab_size, c.hidden_size),
        "layers": layers,
        "final_norm": ones(c.hidden_size),
        "lm_head": None if c.tie_word_embeddings else randn(c.hidden_size, c.vocab_size),
    }


_PROJ_KEYS = ("q", "k", "v", "o", "gate", "up", "down")


HEAD_PAD = 2048  # a quantized head's out-features are padded to a multiple of this


def pad_rows(w: torch.Tensor, multiple: int = HEAD_PAD) -> torch.Tensor:
    """``w`` with zero rows appended up to a multiple of ``multiple``."""
    pad = (-w.shape[0]) % multiple
    return torch.nn.functional.pad(w, (0, 0, 0, pad)) if pad else w


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
    """Quantize the seven projections of every block (embeddings and norms
    stay dense) on ``device`` (``cuda`` unless named), each keyed for
    ``example_batch_size`` rows (:func:`~flute_tpu_torch.nn.quantize_linear`).

    ``fuse=True`` merges q/k/v into one ``qkv`` and gate/up into one
    ``gate_up`` projection: one kernel launch each.

    ``quantize_lm_head=True`` also quantizes a dense ``lm_head`` with the
    blocks' settings, its out-features (the vocabulary) padded with zero
    rows to a multiple of 2048 (128256 becomes 129024); ``forward`` slices
    the logits back to ``vocab_size``. A tied or absent head stays as it is.
    """
    dev = resolve_device(device)
    kw = {"device": dev, "example_batch_size": example_batch_size}
    if chunk is not None:
        kw["chunk"] = chunk
    if symmetric is not None:
        kw["symmetric"] = symmetric

    def quant(w):
        return quantize_linear(w.to(dev).T, num_bits, group_size, **kw)  # [out, in]

    out = dict(params)
    out["layers"] = []
    for layer in params["layers"]:
        new_layer = dict(layer)
        keys = _PROJ_KEYS
        if fuse:
            new_layer["qkv"] = quant(torch.cat([layer[k2] for k2 in ("q", "k", "v")], dim=1))
            new_layer["gate_up"] = quant(torch.cat([layer[k2] for k2 in ("gate", "up")], dim=1))
            for k2 in ("q", "k", "v", "gate", "up"):
                del new_layer[k2]
            keys = ("o", "down")
        for key in keys:
            w = layer[key]
            new_layer[key] = w if isinstance(w, QuantizedLinear) else quant(w)
        out["layers"].append(new_layer)
    head = params.get("lm_head")
    if quantize_lm_head and isinstance(head, torch.Tensor):
        # [hidden, vocab] -> [vocab, hidden], zero rows to the padded vocab
        out["lm_head"] = quantize_linear(pad_rows(head.to(dev).T), num_bits, group_size, **kw)
    return out
