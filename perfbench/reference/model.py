"""The plain reference of the benchmark's served models: a Mistral (Llama
architecture) decoder in float32 PyTorch, with TF32 off.

Token embedding; per layer RMSNorm, one fused q/k/v projection, rotary
embedding (half-split pairs, ``rope_theta``, no scaling), causal grouped-
query attention with softmax over ``1 / sqrt(head_dim)`` scaled scores, the
output projection and the residual; RMSNorm, a fused gate/up projection,
SiLU(gate) * up, the down projection and the residual; a final RMSNorm and
the untied head. Every product and sum is float32; no cache, no batching,
no kernel of the program.

The weights come from a ``layers`` object (``perfbench/harness/weights.py``
makes the benchmark's inputs from the seed) through the format's own
dequantization in ``reference/quant.py``, one layer at a time, so that the
whole model never sits on the device in float32. ``fp8=True`` is the
lower-precision control: every projection's input and weight rounded to
float8 e4m3 (per-row and per-column absmax scales), the sums in float32.
"""

from __future__ import annotations

import torch

from . import quant

FP8_MAX = 448.0


def no_tf32() -> None:
    """Plain float32 products: TF32 off for matmul and cuDNN."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _fp8(t: torch.Tensor, dim: int) -> torch.Tensor:
    """``t`` rounded to float8 e4m3 with an absmax scale along ``dim``."""
    amax = t.abs().amax(dim=dim, keepdim=True).clamp_min(1e-12)
    s = FP8_MAX / amax
    return (t * s).to(torch.float8_e4m3fn).float() / s


def linear(x: torch.Tensor, w: torch.Tensor, fp8: bool) -> torch.Tensor:
    """``x @ w`` in float32 (``w`` ``[in, out]``); with ``fp8`` both
    operands rounded to float8 first."""
    if fp8:
        x, w = _fp8(x, -1), _fp8(w, 0)
    return x @ w


def rms_norm(x: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt((x * x).mean(dim=-1, keepdim=True) + eps)


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding of ``x`` ``[T, H, D]`` at positions ``0 .. T-1``."""
    t, _, d = x.shape
    inv = 1.0 / (theta ** (torch.arange(0, d, 2, dtype=torch.float64, device=x.device) / d))
    ang = (torch.arange(t, dtype=torch.float64, device=x.device)[:, None] * inv).float()
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., :d // 2], x[..., d // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Causal GQA over one sequence: q ``[T, H, D]``, k and v ``[T, Hkv,
    D]``; returns ``[T, H * D]``. One KV head's query group at a time."""
    t, h, d = q.shape
    hkv = k.shape[1]
    rep = h // hkv
    causal = torch.ones((t, t), dtype=torch.bool, device=q.device).tril()
    out = torch.empty((t, h, d), dtype=torch.float32, device=q.device)
    for g in range(hkv):
        qg = q[:, g * rep:(g + 1) * rep].transpose(0, 1)  # [rep, T, D]
        s = (qg @ k[:, g].T) * d ** -0.5  # [rep, T, T]
        s = s.masked_fill(~causal, float("-inf"))
        out[:, g * rep:(g + 1) * rep] = (torch.softmax(s, dim=-1) @ v[:, g]).transpose(0, 1)
    return out.reshape(t, h * d)


def dense_layer(model: dict, layer: dict) -> dict:
    """A layer's float32 ``[in, out]`` weights in the format of ``model``
    (the configuration's ``quant`` group), from the benchmark's inputs."""
    q = model["quant"]
    g = q["group_size"]
    if q["format"] == "w4sym":
        return {name: quant.nf4_sym_dequantized(layer[name], g)
                for name in ("qkv", "o", "gate_up", "down")}
    if q["format"] == "higgs":
        return {name: quant.higgs_dequantized(layer[name]["codes"], layer["grid"],
                                              layer[name]["scales"], g)
                for name in ("qkv", "o", "gate_up", "down")}
    raise ValueError(f"unknown format {q['format']!r}")


@torch.no_grad()
def logits(model: dict, inputs, sequences: list, starts: list, fp8: bool = False) -> list:
    """Float32 logits ``[T - start, V]`` of each token sequence (a list of
    ints) at its positions from ``start`` on, every position causal from
    position 0. ``model`` is the configuration file's content, ``inputs``
    the benchmark's weight maker."""
    no_tf32()
    dev = inputs.device
    h, hkv, d = model["num_attention_heads"], model["num_key_value_heads"], model["head_dim"]
    eps, theta = model["rms_norm_eps"], model["rope_theta"]
    had = model["quant"].get("hadamard_size")
    embed = inputs.embed()
    xs = [embed[torch.tensor(s, device=dev)].float() for s in sequences]
    del embed

    def proj(x, w):
        return linear(quant.rotate(x, had) if had else x, w, fp8)

    for li in range(model["num_hidden_layers"]):
        w = dense_layer(model, inputs.layer(li))
        for i, x in enumerate(xs):
            t = x.shape[0]
            qkv = proj(rms_norm(x, eps), w["qkv"])
            q = rope(qkv[:, :h * d].reshape(t, h, d), theta)
            k = rope(qkv[:, h * d:(h + hkv) * d].reshape(t, hkv, d), theta)
            v = qkv[:, (h + hkv) * d:].reshape(t, hkv, d)
            x = x + proj(attention(q, k, v), w["o"])
            gu = proj(rms_norm(x, eps), w["gate_up"])
            inter = gu.shape[-1] // 2
            xs[i] = x + proj(torch.nn.functional.silu(gu[:, :inter]) * gu[:, inter:], w["down"])
        del w
    head = inputs.head()
    out = [linear(rms_norm(x[s:], eps), head.float(), fp8) for x, s in zip(xs, starts)]
    del head
    return out
