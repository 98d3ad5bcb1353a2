"""Multi-token transformer forward through the paged block pool,
counterpart of ``flute_tpu/serving/paged_fwd.py``.

Used by the paged engine's pool-backed prefill (``PagedEngine`` with
``pool_prefill=True``): a prompt chunk of T tokens is written straight into
the slot's pool blocks and attends through the multi-query paged kernel
(``ops.paged_attention.paged_verify_attention``, K6), with no dense scratch
cache. Speculative verify (T = k+1) will use the same path.

Per layer the chunk's K/V are written into the pools in place (the JAX
package returns updated copies) before that layer's attention reads them.
``real_end`` sends the writes of right-padding positions to the trash block
(pool row 0); duplicate writes there are junk by design, never read.
``last_idx`` keeps one row of hidden states for the LM head.

Families: Llama and Gemma-2 (sandwich norms, GeGLU, embedding scale,
the attention softcap and the sliding window of even layers passed to the
kernels, the final logit softcap), told apart by the config as the JAX
package tells them.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from flute_tpu_torch.models import gemma2
from flute_tpu_torch.models.llama import (
    apply_linear,
    apply_rope,
    matmul_f32,
    rms_norm,
    rope_tables,
    split_fused_qkv,
)
from flute_tpu_torch.nn import QuantizedLinear
from flute_tpu_torch.ops.paged_attention import paged_verify_attention
from flute_tpu_torch.parallel.comm import all_reduce_

# what the Gemma-2 stack reads beyond Llama's fields
GEMMA2_FIELDS = ("attn_logit_softcap", "final_logit_softcap", "query_pre_attn_scalar",
                 "sliding_window")


def check_family(config) -> str:
    """The family the paged path serves ``config`` as: ``"gemma2"`` for a
    config with an attention logit softcap (the JAX package's test),
    ``"llama"`` otherwise. Raises for a softcapped config without the rest
    of Gemma-2's fields: no family the port serves."""
    if not hasattr(config, "attn_logit_softcap"):
        return "llama"
    missing = [f for f in GEMMA2_FIELDS if not hasattr(config, f)]
    if missing:
        raise NotImplementedError(
            f"a config with attn_logit_softcap but without {missing} is not Gemma-2; "
            "the paged path serves Llama and Gemma-2 only"
        )
    return "gemma2"


def make_paged_multitoken_forward(config, block_size: int) -> Callable:
    """``fwd(params, kp, vp, tables, lengths, toks, real_end=None,
    last_idx=None, group=None) -> (logits, kp, vp)``. ``toks`` is
    ``[B, T]``; token ``(b, j)`` sits at position ``lengths[b] + j``.
    Returns f32 logits ``[B, T, V]`` (``[B, 1, V]`` with ``last_idx``) and
    the pools, written in place. With a tp ``group`` the params and pools
    are this rank's slices (pools over KV heads)."""
    check_family(config)
    return _make_pool_forward(config, block_size)


def _scatter_rows(tables, positions, real_end, bs: int, mb: int):
    """Pool (row, offset) of each (slot, token); padding positions
    (``>= real_end``) go to the trash block (row 0)."""
    b = tables.shape[0]
    prow = torch.clamp(positions // bs, 0, mb - 1)
    rows = tables[torch.arange(b, device=tables.device)[:, None], prow]
    if real_end is not None:
        rows = torch.where(positions < real_end[:, None], rows, torch.zeros_like(rows))
    return rows.long(), (positions % bs).long()


def embed(params, cfg, toks: torch.Tensor) -> torch.Tensor:
    """The tokens' embeddings in the compute dtype (Gemma-2's scaled)."""
    x = params["embed"][toks.long()].to(cfg.dtype)
    if check_family(cfg) == "gemma2":
        x = x * gemma2.embed_scale(cfg)
    return x


def attention_options(cfg, li: int) -> dict:
    """Layer ``li``'s keywords of the paged kernels (none for Llama)."""
    return gemma2.attention_options(cfg, li) if check_family(cfg) == "gemma2" else {}


def _head_logits(params, cfg, x, last_idx: Optional[int]):
    """f32 logits of ``x`` (one row of it with ``last_idx``), Gemma-2's
    capped."""
    if last_idx is not None:
        x = x[:, last_idx:last_idx + 1]
    head = params["lm_head"] if params.get("lm_head") is not None else params["embed"].T
    if isinstance(head, QuantizedLinear):
        logits = head(x)[..., :cfg.vocab_size]
    else:
        logits = matmul_f32(x, head.to(x.dtype))
    if check_family(cfg) == "gemma2":
        return gemma2.capped_logits(cfg, logits)
    return logits.float()


def decoder_layers(params, cfg, x, cos, sin, attend, group=None) -> torch.Tensor:
    """The decoder stack of ``cfg``'s family over ``x`` ``[B, T, hidden]``,
    through the final norm; ``attend(li, q, k, v)`` writes layer ``li``'s
    K/V and returns its attention output ``[B, T, H, D]``. Gemma-2 adds the
    sandwich norms, its ``(1 + w)`` RMSNorm and GeGLU. With a tp ``group``
    the o and down outputs are all-reduced, as in ``llama._block``."""
    b, t, _ = x.shape
    d = cfg.head_dim
    eps = cfg.rms_norm_eps
    gemma = check_family(cfg) == "gemma2"
    norm = gemma2.rms_norm_gemma if gemma else rms_norm
    act = gemma2.gelu_tanh if gemma else torch.nn.functional.silu
    for li, layer in enumerate(params["layers"]):
        h = norm(x, layer["attn_norm"], eps)
        if "qkv" in layer:
            q, k, v = split_fused_qkv(apply_linear(layer["qkv"], h), cfg.num_heads,
                                      cfg.num_kv_heads, d)
        else:
            q = apply_linear(layer["q"], h).reshape(b, t, -1, d)
            k = apply_linear(layer["k"], h).reshape(b, t, -1, d)
            v = apply_linear(layer["v"], h).reshape(b, t, -1, d)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
        attn = attend(li, q, k, v)
        o = all_reduce_(apply_linear(layer["o"], attn.reshape(b, t, -1)), group)
        x = x + (norm(o, layer["post_attn_norm"], eps) if gemma else o)
        h2 = norm(x, layer["mlp_norm"], eps)
        if "gate_up" in layer:
            gu = apply_linear(layer["gate_up"], h2)
            inter = gu.shape[-1] // 2
            gate, up = gu[..., :inter], gu[..., inter:]
        else:
            gate = apply_linear(layer["gate"], h2)
            up = apply_linear(layer["up"], h2)
        down = all_reduce_(apply_linear(layer["down"], act(gate) * up), group)
        x = x + (norm(down, layer["post_mlp_norm"], eps) if gemma else down)
    return norm(x, params["final_norm"], eps)


def _make_pool_forward(cfg, bs: int):
    def fwd(params, kp, vp, tables, lengths, toks, real_end=None, last_idx=None, group=None):
        b, t = toks.shape
        mb = tables.shape[1]
        x = embed(params, cfg, toks)
        positions = lengths.long()[:, None] + torch.arange(t, device=toks.device)[None, :]
        cos, sin = rope_tables(cfg, positions)
        rows, offs = _scatter_rows(tables, positions, real_end, bs, mb)

        def attend(li, q, k, v):
            # T entries per slot: (row, offset) pairs are distinct within a
            # slot; across slots they meet only on the trash block
            kp[li][rows, :, offs, :] = k.to(kp[li].dtype)
            vp[li][rows, :, offs, :] = v.to(vp[li].dtype)
            return paged_verify_attention(q, kp[li], vp[li], tables, lengths,
                                          **attention_options(cfg, li))

        x = decoder_layers(params, cfg, x, cos, sin, attend, group)
        return _head_logits(params, cfg, x, last_idx), kp, vp

    return fwd
