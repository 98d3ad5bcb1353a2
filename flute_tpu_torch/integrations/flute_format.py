"""Importer of reference-FLUTE checkpoints, counterpart of
``flute_tpu/integrations/flute_format.py``.

The reference publishes quantized models whose ``FluteLinear`` state holds
``weight int16 [P, K]`` (P = N * num_bits / 16) in a CUDA MMA-thread-mapped
bit layout, ``scales [N, K/group]``, ``tables [2^b]`` and ``tables2`` (the
pair table viewed as f32), beside a ``flute_config.json`` of ``{num_bits,
group_size, template_id}``. This module inverts that layout on the host
(numpy), and packs it for fixtures (:func:`pack_reference_weight`), so the
port ingests such checkpoints with no reference runtime:

* 4-bit: codes ``C[K, N]`` viewed as ``[K/2, 2, N/(4*tP), 4, tP]`` (tP =
  the template's tileP); int16 word ``(row=2a+j, col=b*tP+p)`` holds
  nibbles ``i = 0..3`` (LSB first), ``nibble_i = C[2a + 1 - (i & 1),
  b*4*tP + (2j + i//2)*tP + p]``; then ``[K, N/4] -> T -> [P, K]``.
* 2-bit: the same with eight 2-bit fields per word, ``field_i = C[2a + 1 -
  (i & 1), b*8*tP + (4j + i//2)*tP + p]``.
* 3-bit (tP = 32 only): two planes. Per ``[2, 512]``-code chunk the values
  are permuted to positions ``m = 0..31`` per ``p`` with ``q(m) = 3*((m//2)
  % 5) + (m//2)//5`` (m < 30, else 15) and row parity ``1 - (m & 1)``; the
  96 bits per (chunk, p) fill three 16-bit lanes, the odd row's 2-bit
  tails from bits 90..96; lane 0 is plane Q ``[K, N/16]``, lanes 1-2 plane
  Q2 ``[K, N/8]``, concatenated and transposed to ``[3N/16, K]``.

The template_id -> tileP rule: 2/3-bit take tileP 64 for template_id % 12
< 4, else 32; 4-bit take 64 for template_id % 48 < 16, else 32.

Converted layers are packed in the pair-plane layout (``packing.pack_np``,
as the JAX package packs them): W4 and W2 serve on K2
(``csrc/lut_gemm_plane.cu``), W3 on K2 at 3 bits (2+1 planes), and a layer
whose ``tables2`` holds a genuine vector grid (FLUTE-HIGGS) keeps it as
``pair_values`` and serves on K4 (``csrc/lut_gemm_pair.cu``).
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Optional

import numpy as np
import torch

from flute_tpu_torch import packing
from flute_tpu_torch.integrations import safetensors_io


def tile_p_for_template(num_bits: int, template_id: int) -> int:
    """tileP of a reference template id (see module docstring for the rule's
    provenance)."""
    if num_bits in (2, 3):
        return 64 if template_id % 12 < 4 else 32
    if num_bits == 4:
        return 64 if template_id % 48 < 16 else 32
    raise ValueError(f"unsupported num_bits: {num_bits}")


# ---------------------------------------------------------------------------
# 2/4-bit layout
# ---------------------------------------------------------------------------


def _fields_per_word(num_bits: int) -> int:
    return 16 // num_bits


def _pack_24(codes: np.ndarray, num_bits: int, tile_p: int) -> np.ndarray:
    """Forward reference layout for 2/4-bit: ``[K, N]`` codes -> int16
    ``[N*b/16, K]``."""
    k, n = codes.shape
    r = _fields_per_word(num_bits)  # 4 or 8
    half = r // 2
    cs1 = tile_p * r
    if k % 2 or n % cs1:
        raise ValueError(f"K={k} (even) and N={n} (multiple of {cs1}) required")
    t = codes.reshape(k // 2, 2, n // cs1, r, tile_p).transpose(0, 1, 2, 4, 3)
    out = np.empty_like(t)  # [a, j, b, p, i]
    for j in range(2):
        for i in range(r):
            out[:, j, :, :, i] = t[:, 1 - (i & 1), :, :, half * j + i // 2]
    q2d = out.reshape(k, n).astype(np.uint32)
    qr = q2d.reshape(k, n // r, r)
    shifts = (num_bits * np.arange(r, dtype=np.uint32))[None, None, :]
    words = (qr << shifts).sum(axis=-1).astype(np.uint16)
    return words.T.copy().view(np.int16)


def _unpack_24(packed: np.ndarray, num_bits: int, tile_p: int) -> np.ndarray:
    """Inverse of :func:`_pack_24`: int16 ``[N*b/16, K]`` -> codes [K, N]."""
    r = _fields_per_word(num_bits)
    half = r // 2
    p_, k = packed.shape
    n = p_ * 16 // num_bits
    cs1 = tile_p * r
    words = np.ascontiguousarray(packed.T).view(np.uint16)  # [K, N/r]
    mask = np.uint32((1 << num_bits) - 1)
    q2d = np.empty((k, n), np.uint8)
    w32 = words.astype(np.uint32)
    for i in range(r):
        q2d[:, i::r] = ((w32 >> (num_bits * i)) & mask).astype(np.uint8)
    out = q2d.reshape(k // 2, 2, n // cs1, tile_p, r)
    t = np.empty_like(out)  # [a, c0, b, p, q]
    for j in range(2):
        for i in range(r):
            t[:, 1 - (i & 1), :, :, half * j + i // 2] = out[:, j, :, :, i]
    return (
        t.transpose(0, 1, 2, 4, 3).reshape(k, n).astype(np.int32)
    )


# ---------------------------------------------------------------------------
# 3-bit layout
# ---------------------------------------------------------------------------


def _q_of_m(m: int) -> int:
    return 3 * ((m // 2) % 5) + (m // 2) // 5 if m < 30 else 15


def _pack_3(codes: np.ndarray, tile_p: int = 32) -> np.ndarray:
    """Forward reference 3-bit layout: ``[K, N]`` codes -> int16
    ``[3N/16, K]`` (plane Q ∥ plane Q2)."""
    if tile_p != 32:
        raise ValueError("reference 3-bit layout is specialized to tileP=32")
    k, n = codes.shape
    cs1 = tile_p * 16  # 512
    if k % 2 or n % cs1:
        raise ValueError(f"K={k} (even) and N={n} (multiple of {cs1}) required")
    nb = n // cs1
    t = codes.reshape(k // 2, 2, nb, 16, tile_p).transpose(0, 1, 2, 4, 3)
    # permuted positions m = 0..31 per (chunk, p)
    mvals = np.empty((k // 2, nb, tile_p, 32), np.uint8)
    for m in range(32):
        mvals[..., m] = t[:, 1 - (m & 1), :, :, _q_of_m(m)]
    # 96 bits per (chunk, p): LSB-first, 3 per value
    bits = (mvals[..., None] >> np.arange(3, dtype=np.uint8)) & 1
    flat = bits.reshape(k // 2, nb, tile_p, 96)
    lanes = np.zeros((k // 2, 2, nb, tile_p, 3, 16), np.uint8)
    lanes[:, 0, :, :, 0, :] = flat[..., 0:16]
    lanes[:, 1, :, :, 0, 0:14] = flat[..., 16:30]
    lanes[:, 0, :, :, 1, :] = flat[..., 30:46]
    lanes[:, 1, :, :, 1, 0:14] = flat[..., 46:60]
    lanes[:, 0, :, :, 2, :] = flat[..., 60:76]
    lanes[:, 1, :, :, 2, 0:14] = flat[..., 76:90]
    lanes[:, 1, :, :, 0, 14:16] = flat[..., 90:92]
    lanes[:, 1, :, :, 1, 14:16] = flat[..., 92:94]
    lanes[:, 1, :, :, 2, 14:16] = flat[..., 94:96]

    shifts = (np.arange(16, dtype=np.uint32))[None, :]

    def to_words(b):  # [..., 16] bits -> uint16 words
        return ((b.astype(np.uint32) << shifts).sum(-1)).astype(np.uint16)

    plane0 = to_words(lanes[:, :, :, :, 0, :].reshape(-1, 16)).reshape(k, n // 16)
    plane1 = to_words(
        lanes[:, :, :, :, 1:, :].transpose(0, 1, 2, 4, 3, 5).reshape(-1, 16)
    ).reshape(k, n // 8)
    q = np.concatenate([plane0, plane1], axis=-1)  # [K, 3N/16]
    return q.T.copy().view(np.int16)


def _unpack_3(packed: np.ndarray, tile_p: int = 32) -> np.ndarray:
    """Inverse of :func:`_pack_3`."""
    if tile_p != 32:
        raise ValueError("reference 3-bit layout is specialized to tileP=32")
    p_, k = packed.shape
    n = p_ * 16 // 3
    cs1 = tile_p * 16
    nb = n // cs1
    q = np.ascontiguousarray(packed.T).view(np.uint16)  # [K, 3N/16]
    plane0 = q[:, : n // 16].astype(np.uint32)
    plane1 = q[:, n // 16:].astype(np.uint32)

    shifts = np.arange(16, dtype=np.uint32)

    def to_bits(w):  # uint words [..., W] -> [..., W, 16]
        return ((w[..., None] >> shifts) & 1).astype(np.uint8)

    lanes = np.zeros((k // 2, 2, nb, tile_p, 3, 16), np.uint8)
    lanes[:, :, :, :, 0, :] = to_bits(plane0).reshape(
        k // 2, 2, nb, tile_p, 16
    )
    lanes[:, :, :, :, 1:, :] = (
        to_bits(plane1)
        .reshape(k // 2, 2, nb, 2, tile_p, 16)
        .transpose(0, 1, 2, 4, 3, 5)
    )
    flat = np.empty((k // 2, nb, tile_p, 96), np.uint8)
    flat[..., 0:16] = lanes[:, 0, :, :, 0, :]
    flat[..., 16:30] = lanes[:, 1, :, :, 0, 0:14]
    flat[..., 30:46] = lanes[:, 0, :, :, 1, :]
    flat[..., 46:60] = lanes[:, 1, :, :, 1, 0:14]
    flat[..., 60:76] = lanes[:, 0, :, :, 2, :]
    flat[..., 76:90] = lanes[:, 1, :, :, 2, 0:14]
    flat[..., 90:92] = lanes[:, 1, :, :, 0, 14:16]
    flat[..., 92:94] = lanes[:, 1, :, :, 1, 14:16]
    flat[..., 94:96] = lanes[:, 1, :, :, 2, 14:16]
    bits = flat.reshape(k // 2, nb, tile_p, 32, 3)
    mvals = (bits << np.arange(3, dtype=np.uint8)).sum(-1).astype(np.uint8)
    t = np.empty((k // 2, 2, nb, tile_p, 16), np.uint8)
    for m in range(32):
        t[:, 1 - (m & 1), :, :, _q_of_m(m)] = mvals[..., m]
    return t.transpose(0, 1, 2, 4, 3).reshape(k, n).astype(np.int32)


# ---------------------------------------------------------------------------
# Public API
# ---------------------------------------------------------------------------


def pack_reference_weight(
    codes: np.ndarray,
    num_bits: int,
    *,
    tile_p: Optional[int] = None,
    template_id: Optional[int] = None,
) -> np.ndarray:
    """Pack ``[K, N]`` codes into the reference's int16 ``[P, K]`` layout
    (fixtures, and checkpoints the reference runtime can load)."""
    if tile_p is None:
        tile_p = 32 if template_id is None else tile_p_for_template(num_bits, template_id)
    if num_bits == 3:
        return _pack_3(np.asarray(codes), tile_p)
    if num_bits in (2, 4):
        return _pack_24(np.asarray(codes), num_bits, tile_p)
    raise ValueError(f"unsupported num_bits: {num_bits}")


def unpack_reference_weight(
    packed: np.ndarray,
    num_bits: int,
    *,
    tile_p: Optional[int] = None,
    template_id: Optional[int] = None,
) -> np.ndarray:
    """``[K, N]`` int32 codes from a reference-packed int16 ``[P, K]``
    weight, the layout inverted on the host."""
    if tile_p is None:
        if template_id is None:
            raise ValueError("need tile_p or template_id to unpack")
        tile_p = tile_p_for_template(num_bits, template_id)
    if num_bits == 3:
        return _unpack_3(np.asarray(packed), tile_p)
    if num_bits in (2, 4):
        return _unpack_24(np.asarray(packed), num_bits, tile_p)
    raise ValueError(f"unsupported num_bits: {num_bits}")


def convert_reference_tensors(
    weight: np.ndarray,
    scales: np.ndarray,
    tables: np.ndarray,
    num_bits: int,
    group_size: int,
    *,
    template_id: Optional[int] = None,
    tile_p: Optional[int] = None,
    chunk: int = packing.DEFAULT_CHUNK,
):
    """One reference FluteLinear's tensors in the port's format.

    Args:
      weight: int16 ``[P, K]`` reference-packed codes.
      scales: ``[N, K/group_size]``.
      tables: ``[2^b]`` lookup table.

    Returns (planes, scales_kn, table): the pair-plane planes (numpy int32),
    the scales transposed to ``[K/g, N]`` in float32, the table in float32.
    """
    if tile_p is None and template_id is None:
        raise ValueError("need tile_p or template_id to convert")
    codes = unpack_reference_weight(weight, num_bits, tile_p=tile_p, template_id=template_id)
    k, n = codes.shape
    if tuple(scales.shape) != (n, k // group_size):
        raise ValueError(f"scales shape {tuple(scales.shape)} != expected [{n}, {k // group_size}]")
    planes = packing.pack_np(codes, num_bits, chunk=chunk)
    scales_kn = np.ascontiguousarray(np.asarray(scales, np.float32).T)
    return planes, scales_kn, np.asarray(tables, np.float32)


def _half_to_f32(u16: np.ndarray, dtype16: str) -> np.ndarray:
    if dtype16 == "float16":
        return u16.view(np.float16).astype(np.float32)
    if dtype16 == "bfloat16":
        return torch.from_numpy(u16.view(np.int16).copy()).view(torch.bfloat16).float().numpy()
    raise ValueError(f"unsupported 16-bit type {dtype16!r}")


def pair_values_from_tables2(
    tables2: np.ndarray, num_bits: int, *, dtype16: str = "float16"
) -> np.ndarray:
    """Decode a reference ``tables2`` buffer (``[E, E, 2]`` f16/bf16 pairs
    bit-viewed as f32) into a float32 ``pair_values [E, E, 2]``: the vector
    grid of ``pair_values`` layers (FLUTE-HIGGS keeps its grid here)."""
    e = 2**num_bits
    u32 = np.ascontiguousarray(tables2, dtype=np.float32).view(np.uint32).reshape(e, e)
    lo = _half_to_f32((u32 & 0xFFFF).astype(np.uint16), dtype16)
    hi = _half_to_f32((u32 >> 16).astype(np.uint16), dtype16)
    # little-endian: memory-order element 0 (the even K row) is the low half
    return np.stack([lo, hi], axis=-1)


def is_vector_tables2(
    tables2: np.ndarray, tables: np.ndarray, num_bits: int, *, dtype16: str = "float16",
) -> bool:
    """True when ``tables2`` holds a genuine 2-D vector grid rather than the
    outer product of the scalar table (``qmap2[i, j] = (qmap[i],
    qmap[j])``)."""
    pv = pair_values_from_tables2(tables2, num_bits, dtype16=dtype16)
    t = np.asarray(tables, np.float32)
    outer0 = np.broadcast_to(t[:, None], pv.shape[:2])
    outer1 = np.broadcast_to(t[None, :], pv.shape[:2])
    return not (
        np.allclose(pv[..., 0], outer0, rtol=1e-2, atol=1e-3)
        and np.allclose(pv[..., 1], outer1, rtol=1e-2, atol=1e-3)
    )


def read_flute_config(model_dir: str) -> dict:
    """The ``flute_config.json`` sidecar of a reference checkpoint."""
    with open(os.path.join(model_dir, "flute_config.json")) as f:
        cfg = json.load(f)
    for key in ("num_bits", "group_size"):
        if key not in cfg:
            raise ValueError(f"flute_config.json missing '{key}'")
    return cfg


_HF_LAYER_KEYS = {
    "input_layernorm": ("attn_norm", False),
    "self_attn.q_proj": ("q", True),
    "self_attn.k_proj": ("k", True),
    "self_attn.v_proj": ("v", True),
    "self_attn.o_proj": ("o", True),
    "post_attention_layernorm": ("mlp_norm", False),
    "mlp.gate_proj": ("gate", True),
    "mlp.up_proj": ("up", True),
    "mlp.down_proj": ("down", True),
}


def _bf16(t) -> torch.Tensor:
    return torch.as_tensor(t).to(torch.bfloat16)


def reference_to_model_checkpoint(
    model_dir: str,
    output_dir: str,
    *,
    tile_p: Optional[int] = None,
    template_id: Optional[int] = None,
) -> int:
    """Convert a reference-FLUTE Llama checkpoint into a servable checkpoint
    of the port's (and the JAX package's) format: HF module names map to
    ``layers/<i>/<q|k|v|o|gate|up|down>``, so it loads with
    ``load_quantized_model``. A layer with a vector ``tables2`` keeps it as
    ``pair_values`` (which the JAX package's converter leaves out).

    Returns the number of quantized layers converted.
    """
    from flute_tpu_torch.integrations.checkpoint import StreamingWriter

    converted = load_reference_checkpoint(model_dir, tile_p=tile_p, template_id=template_id)
    writer = StreamingWriter(output_dir)
    bits = group = None
    n_layers = 0
    saw_lm_head = False
    for name, val in sorted(converted.items()):
        is_q = isinstance(val, dict) and "planes" in val
        if name == "model.embed_tokens.weight":
            writer.add_array("embed", _bf16(val))
        elif name == "model.norm.weight":
            writer.add_array("final_norm", _bf16(val))
        elif name == "lm_head.weight":
            saw_lm_head = True
            writer.add_array("lm_head", _bf16(val).T.contiguous())
        elif name.startswith("model.layers."):
            li, sub = name[len("model.layers."):].split(".", 1)
            sub = sub[: -len(".weight")] if sub.endswith(".weight") else sub
            if sub not in _HF_LAYER_KEYS:
                continue
            key, is_linear = _HF_LAYER_KEYS[sub]
            if is_linear:
                if not is_q:
                    raise ValueError(f"expected quantized tensors at {name}")
                bits, group = val["num_bits"], val["group_size"]
                n_layers += 1
                writer.add_quantized(
                    f"layers/{li}/{key}", val["planes"], _bf16(torch.from_numpy(val["scales"])),
                    val["table"], num_bits=bits, group_size=group,
                    pair_values=val.get("pair_values"),
                )
            else:
                writer.add_array(f"layers/{li}/{key}", _bf16(val))
    if not saw_lm_head:
        writer.add_none("lm_head")
    writer.finish(
        model_config={"source": model_dir, "imported": "flute-reference"},
        num_bits=bits,
        group_size=group,
    )
    for fname in ("config.json", "tokenizer.json", "tokenizer_config.json"):
        src = os.path.join(model_dir, fname)
        if os.path.exists(src):
            shutil.copy(src, os.path.join(output_dir, fname))
    return n_layers


def load_reference_checkpoint(
    model_dir: str,
    *,
    tile_p: Optional[int] = None,
    template_id: Optional[int] = None,
) -> dict:
    """Load a reference-FLUTE HF checkpoint directory.

    Converts each FluteLinear's tensors (``<prefix>.weight`` int16 +
    ``.scales`` + ``.tables``) and passes dense tensors through (as the CPU
    tensors read). Returns ``{name: tensor or layer dict}``, a converted
    layer being ``{"planes", "scales", "table", "num_bits", "group_size"}``
    in numpy, plus ``"pair_values"`` where ``tables2`` holds a vector grid.
    """
    cfg = read_flute_config(model_dir)
    num_bits, group_size = cfg["num_bits"], cfg["group_size"]
    if template_id is None:
        template_id = cfg.get("template_id")
    if tile_p is None and template_id is None:
        raise ValueError(
            "reference checkpoints do not always record their pack tileP; "
            "pass tile_p= (32 or 64) or template_id= explicitly"
        )
    tensors = dict(safetensors_io.iter_dir(model_dir))
    out = {}
    done = set()
    for key, val in tensors.items():
        if key in done:
            continue
        if key.endswith(".weight") and val.dtype == torch.int16:
            prefix = key[: -len(".weight")]
            scales = tensors[prefix + ".scales"].float().numpy()
            tables = tensors[prefix + ".tables"].float().numpy()
            planes, s_kn, table = convert_reference_tensors(
                val.numpy(), scales, tables, num_bits, group_size,
                tile_p=tile_p, template_id=template_id,
            )
            out[prefix] = {
                "planes": planes,
                "scales": s_kn,
                "table": table,
                "num_bits": num_bits,
                "group_size": group_size,
            }
            t2 = tensors.get(prefix + ".tables2")
            if t2 is not None:
                t2 = t2.numpy()
                if is_vector_tables2(t2, tables, num_bits):
                    out[prefix]["pair_values"] = pair_values_from_tables2(t2, num_bits)
            done.update({prefix + ".scales", prefix + ".tables", prefix + ".tables2"})
        else:
            out[key] = val
    return out
