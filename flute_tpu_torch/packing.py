"""Packed weight layouts, bit for bit those of ``flute_tpu/packing.py``.

The packed int32 planes are the checkpoint contract shared with the JAX
package, so every packer here writes exactly the words the JAX packers
write. The numpy packers (``*_np``) are the reference; ``pack_plane``,
``pack_w3_wide`` and ``pack_w4_sym`` and their unpackers are torch twins
that run on the codes' own device, and ``pack``/``unpack`` use them.

Logical format: ``codes`` int ``[K, N]`` indexing a 2^b-entry table, and
``scales`` ``[K // group_size, N]``, so that
``y = x[M, K] @ (table[codes] * scales_expanded)``.

Pair-plane layout: codes are processed as K-adjacent pairs ``(2p, 2p+1)``.
Each bit-plane of ``pb`` bits (3-bit = 2+1 planes) stores the pair field
``ce | co << pb``. Fields are chunked along K (``chunk`` K rows =
``chunk/2`` pairs): within a chunk, word ``j`` holds in LSB-first field
``i`` the pair at pair-row ``i * Kc + j`` with ``Kc = chunk * pb / 32``.

w4sym layout (sign-symmetric 4-bit): codes are sign-magnitude,
``c = 8 s + m``, for tables with ``table[c + 8] == -table[c]``. The pair
field is one byte ``f = m_e | m_o << 3 | s_e << 6 | s_o << 7``, four per
word in the pair-plane arrangement above (plane ``[K/8, N]``). It has the
plane shape of classic W4, so the layout cannot be told from the shape and
travels as metadata.

w3wide layout (3-bit): 16 six-bit pair fields ``ce | co << 3`` fill three
words, laid out planar per chunk (all first words, then all second, then
all third); two fields straddle a word boundary.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from flute_tpu_torch import bitutils, native
from flute_tpu_torch.device import resolve_device
from flute_tpu_torch.ops.kernel_config import KernelConfig

DEFAULT_CHUNK = 256  # K rows per pack chunk (= 128 K-pairs)


@dataclasses.dataclass(frozen=True)
class PackFormat:
    """The packed layout of a quantized weight: bit-width and pack chunk."""

    num_bits: int
    chunk: int = DEFAULT_CHUNK

    def __post_init__(self):
        bitutils.planes_for_bits(self.num_bits)  # validate
        for pb in self.plane_bits:
            r = bitutils.WORD_BITS // (2 * pb)  # pair fields per word
            if (self.chunk // 2) % r != 0:
                raise ValueError(
                    f"chunk={self.chunk} incompatible with plane of {pb} bits"
                )

    @property
    def plane_bits(self) -> tuple[int, ...]:
        return bitutils.planes_for_bits(self.num_bits)

    def plane_rows(self, k: int, plane_index: int) -> int:
        pb = self.plane_bits[plane_index]
        return k * pb // bitutils.WORD_BITS

    def packed_shapes(self, k: int, n: int) -> list[tuple[int, int]]:
        return [(self.plane_rows(k, i), n) for i in range(len(self.plane_bits))]

    def validate_k(self, k: int) -> None:
        if k % self.chunk != 0:
            raise ValueError(
                f"K={k} must be a multiple of pack chunk {self.chunk} "
                f"(zero-pad K before packing)"
            )


# ---------------------------------------------------------------------------
# numpy packers (the reference path)
# ---------------------------------------------------------------------------


def _pack_pair_plane_np(
    pair_codes: np.ndarray, field_bits: int, chunk_pairs: int
) -> np.ndarray:
    """Pack ``[P, N]`` pair fields into ``[P*fb/32, N]`` int32 words."""
    p, n = pair_codes.shape
    r = bitutils.WORD_BITS // field_bits
    kc = chunk_pairs // r
    x = pair_codes.reshape(p // chunk_pairs, r, kc, n).astype(np.uint32)
    out = np.zeros((p // r, n), np.uint32)
    for c in range(p // chunk_pairs):
        w = np.zeros((kc, n), np.uint32)
        for i in range(r):
            w |= x[c, i] << (field_bits * i)
        out[c * kc:(c + 1) * kc] = w
    return out.view(np.int32)


def _unpack_pair_plane_np(
    words: np.ndarray, field_bits: int, chunk_pairs: int
) -> np.ndarray:
    """Inverse of :func:`_pack_pair_plane_np` -> ``[P, N]`` pair fields."""
    rows, n = words.shape
    r = bitutils.WORD_BITS // field_bits
    kc = chunk_pairs // r
    w = np.ascontiguousarray(words).view(np.uint32)
    mask = (1 << field_bits) - 1
    out = np.zeros((rows * r, n), np.int64)
    for c in range(rows // kc):
        blk = w[c * kc:(c + 1) * kc]
        for i in range(r):
            out[c * chunk_pairs + i * kc:c * chunk_pairs + (i + 1) * kc] = (
                (blk >> (field_bits * i)) & mask
            )
    return out


def pack_np(
    codes: np.ndarray, num_bits: int, *, chunk: int = DEFAULT_CHUNK, use_native: bool = True
) -> list[np.ndarray]:
    """Pack ``[K, N]`` b-bit codes into int32 pair-plane arrays, with the
    threaded C++ packer (:mod:`flute_tpu_torch.native`) where it is
    available; the numpy path is the reference it is held to."""
    fmt = PackFormat(num_bits=num_bits, chunk=chunk)
    k, n = codes.shape
    fmt.validate_k(k)
    if use_native and native.available():
        codes_i32 = np.ascontiguousarray(codes, dtype=np.int32)
        shifts = np.cumsum((0,) + fmt.plane_bits[:-1])
        return [native.pack_plane(codes_i32, int(sh), pb, chunk)
                for sh, pb in zip(shifts, fmt.plane_bits)]
    codes = np.asarray(codes).astype(np.int64)
    out = []
    shift = 0
    for pb in fmt.plane_bits:
        sub = (codes >> shift) & ((1 << pb) - 1)
        shift += pb
        pairs = sub[0::2] | (sub[1::2] << pb)  # [K/2, N] pair fields
        out.append(_pack_pair_plane_np(pairs, 2 * pb, chunk // 2))
    return out


def unpack_np(
    planes: Sequence[np.ndarray],
    num_bits: int,
    *,
    chunk: int = DEFAULT_CHUNK,
    use_native: bool = True,
) -> np.ndarray:
    """Recover ``[K, N]`` int32 codes from packed plane arrays (natively
    where the C++ packer is available)."""
    if num_bits == 3 and len(planes) == 1:
        # wide single-plane 3-bit layout (classic 3-bit always has 2 planes)
        return unpack_w3_wide_np(np.asarray(planes[0]), chunk=chunk, use_native=use_native)
    fmt = PackFormat(num_bits=num_bits, chunk=chunk)
    native_ok = use_native and native.available()
    acc = None
    shift = 0
    for plane, pb in zip(planes, fmt.plane_bits):
        if native_ok:
            sub = native.unpack_plane(np.asarray(plane), pb, chunk).astype(np.int64)
        else:
            pairs = _unpack_pair_plane_np(np.asarray(plane), 2 * pb, chunk // 2)
            p, n = pairs.shape
            sub = np.zeros((2 * p, n), np.int64)
            sub[0::2] = pairs & ((1 << pb) - 1)
            sub[1::2] = pairs >> pb
        acc = sub << shift if acc is None else acc | (sub << shift)
        shift += pb
    return acc.astype(np.int32)


def pack_w3_wide_np(
    codes: np.ndarray, *, chunk: int = DEFAULT_CHUNK, use_native: bool = True
) -> list[np.ndarray]:
    """Pack ``[K, N]`` 3-bit codes into the wide single-plane layout
    (int32 ``[3K/32, N]``), natively where the C++ packer is available."""
    k, n = codes.shape
    if k % chunk != 0:
        raise ValueError(f"K={k} must be a multiple of pack chunk {chunk}")
    if chunk % 256 != 0:
        raise ValueError(f"chunk={chunk} incompatible with wide 3-bit layout")
    if use_native and native.available():
        return [native.pack_w3_wide(codes, chunk)]
    cp = chunk // 2
    codes = np.asarray(codes)
    pairs = (codes[0::2] | (codes[1::2] << 3)).astype(np.uint64)  # [K/2, N]
    nch = (k // 2) // cp
    ntrip = cp // 16
    pr = pairs.reshape(nch, 16, ntrip, n)  # [c, j, t, n]
    grp = np.zeros((nch, 3, ntrip, n), np.uint64)
    for j in range(16):
        bit = 6 * j
        w, off = bit // 32, bit % 32
        grp[:, w] |= (pr[:, j] << off) & 0xFFFFFFFF
        if off + 6 > 32:
            grp[:, w + 1] |= pr[:, j] >> (32 - off)
    out = grp.reshape(k * 3 // 32, n).astype(np.uint32)
    return [out.view(np.int32)]


def unpack_w3_wide_np(
    plane: np.ndarray, *, chunk: int = DEFAULT_CHUNK, use_native: bool = True
) -> np.ndarray:
    """Inverse of :func:`pack_w3_wide_np` -> ``[K, N]`` int32 codes."""
    if use_native and native.available():
        return native.unpack_w3_wide(np.asarray(plane), chunk)
    plane = np.ascontiguousarray(plane)
    rows, n = plane.shape
    k = rows * 32 // 3
    cp = chunk // 2
    ntrip = cp // 16
    w = plane.view(np.uint32).reshape(k // chunk, 3, ntrip, n).astype(np.uint64)
    pf = np.empty((k // chunk, 16, ntrip, n), np.uint64)
    for j in range(16):
        bit = 6 * j
        a, off = bit // 32, bit % 32
        if off + 6 <= 32:
            pf[:, j] = (w[:, a] >> off) & 0x3F
        else:
            pf[:, j] = ((w[:, a] >> off) | (w[:, a + 1] << (32 - off))) & 0x3F
    pairs = pf.reshape(k // 2, n)
    codes = np.empty((k, n), np.int64)
    codes[0::2] = pairs & 7
    codes[1::2] = pairs >> 3
    return codes.astype(np.int32)


def pack_w4_sym_np(
    codes: np.ndarray, *, chunk: int = DEFAULT_CHUNK, use_native: bool = True
) -> list[np.ndarray]:
    """Pack ``[K, N]`` 4-bit sign-magnitude codes (c = s*8 + m) into the
    w4sym byte-field layout (single int32 plane ``[K/8, N]``), natively
    where the C++ packer is available."""
    k, n = codes.shape
    if k % chunk != 0:
        raise ValueError(f"K={k} must be a multiple of pack chunk {chunk}")
    if use_native and native.available():
        return [native.pack_w4_sym(codes, chunk)]
    c = np.asarray(codes).astype(np.uint32)
    ce, co = c[0::2], c[1::2]
    f = (ce & 7) | ((co & 7) << 3) | ((ce >> 3) << 6) | ((co >> 3) << 7)
    return [_pack_pair_plane_np(f, 8, chunk // 2)]


def unpack_w4_sym_np(
    plane: np.ndarray, *, chunk: int = DEFAULT_CHUNK, use_native: bool = True
) -> np.ndarray:
    """Inverse of :func:`pack_w4_sym_np` -> ``[K, N]`` int32 codes."""
    if use_native and native.available():
        return native.unpack_w4_sym(np.asarray(plane), chunk)
    f = _unpack_pair_plane_np(np.asarray(plane), 8, chunk // 2)
    p, n = f.shape
    codes = np.empty((2 * p, n), np.int64)
    codes[0::2] = (f & 7) | (((f >> 6) & 1) << 3)
    codes[1::2] = ((f >> 3) & 7) | (((f >> 7) & 1) << 3)
    return codes.astype(np.int32)


# ---------------------------------------------------------------------------
# torch twins (run on the tensor's own device)
# ---------------------------------------------------------------------------


def _to_int32_words(words: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) -> the int32 tensor with the same bits."""
    return torch.where(words >= 2**31, words - 2**32, words).to(torch.int32)


def _pack_fields(fields: torch.Tensor, field_bits: int, chunk: int) -> torch.Tensor:
    """Torch twin of :func:`_pack_pair_plane_np`: ``[K/2, N]`` pair fields
    into ``[K * field_bits / 64, N]`` int32 words (field ``i`` of chunk word
    ``j`` is pair-row ``i * kc + j``)."""
    p, n = fields.shape
    r = bitutils.WORD_BITS // field_bits
    x = fields.to(torch.int64).reshape(2 * p // chunk, r, chunk // 2 // r, n)
    shifts = field_bits * torch.arange(r, device=fields.device).reshape(1, r, 1, 1)
    words = (x << shifts).sum(dim=1)  # the fields' bits are disjoint: sum == OR
    return _to_int32_words(words.reshape(p // r, n))


def _unpack_fields(words: torch.Tensor, field_bits: int, chunk: int) -> torch.Tensor:
    """Inverse of :func:`_pack_fields` -> ``[K/2, N]`` int64 pair fields."""
    rows, n = words.shape
    r = bitutils.WORD_BITS // field_bits
    kc = chunk // 2 // r
    w = (words.to(torch.int64) & 0xFFFFFFFF).reshape(rows // kc, 1, kc, n)
    shifts = field_bits * torch.arange(r, device=words.device).reshape(1, r, 1, 1)
    return ((w >> shifts) & ((1 << field_bits) - 1)).reshape(rows * r, n)


def pack_w4_sym(codes: torch.Tensor, *, chunk: int = DEFAULT_CHUNK) -> torch.Tensor:
    """Torch twin of :func:`pack_w4_sym_np`: packs ``[K, N]`` sign-magnitude
    codes into the ``[K/8, N]`` int32 plane on the codes' device."""
    k, n = codes.shape
    if k % chunk != 0:
        raise ValueError(f"K={k} must be a multiple of pack chunk {chunk}")
    c = codes.to(torch.int64)
    ce, co = c[0::2], c[1::2]
    f = (ce & 7) | ((co & 7) << 3) | ((ce >> 3) << 6) | ((co >> 3) << 7)
    return _pack_fields(f, 8, chunk)


def unpack_w4_sym(plane: torch.Tensor, *, chunk: int = DEFAULT_CHUNK) -> torch.Tensor:
    """Torch twin of :func:`unpack_w4_sym_np` -> ``[K, N]`` int32 codes."""
    f = _unpack_fields(plane, 8, chunk)  # [K/2, N] pair fields
    ce = (f & 7) | (((f >> 6) & 1) << 3)
    co = ((f >> 3) & 7) | (((f >> 7) & 1) << 3)
    return torch.stack([ce, co], dim=1).reshape(2 * f.shape[0], -1).to(torch.int32)


def pack_plane(
    codes: torch.Tensor, num_bits: int, *, chunk: int = DEFAULT_CHUNK
) -> list[torch.Tensor]:
    """Torch twin of :func:`pack_np`: packs ``[K, N]`` b-bit codes into the
    pair-plane layout (int32 ``[K * pb / 32, N]`` per plane) on the codes'
    device."""
    fmt = PackFormat(num_bits=num_bits, chunk=chunk)
    fmt.validate_k(codes.shape[0])
    c = codes.to(torch.int64)
    out = []
    shift = 0
    for pb in fmt.plane_bits:
        sub = (c >> shift) & ((1 << pb) - 1)
        shift += pb
        out.append(_pack_fields(sub[0::2] | (sub[1::2] << pb), 2 * pb, chunk))
    return out


def unpack_plane(
    planes: Sequence[torch.Tensor], num_bits: int, *, chunk: int = DEFAULT_CHUNK
) -> torch.Tensor:
    """Torch twin of :func:`unpack_np` for the pair-plane layout -> ``[K, N]``
    int32 codes on the planes' device."""
    fmt = PackFormat(num_bits=num_bits, chunk=chunk)
    codes = None
    shift = 0
    for plane, pb in zip(planes, fmt.plane_bits):
        f = _unpack_fields(plane, 2 * pb, chunk)  # [K/2, N] pair fields
        sub = torch.stack([f & ((1 << pb) - 1), f >> pb], dim=1).reshape(2 * f.shape[0], -1)
        codes = sub if codes is None else codes | (sub << shift)
        shift += pb
    return codes.to(torch.int32)


# (j, word, offset) of the 16 six-bit pair fields of a wide 3-bit word
# triple: field j lies at bit 6 j of the 96 bits, from `offset` of `word`
# (fields 5 and 10 run on into the next word)
_W3_FIELDS = [(j, 6 * j // 32, 6 * j % 32) for j in range(16)]


def pack_w3_wide(codes: torch.Tensor, *, chunk: int = DEFAULT_CHUNK) -> torch.Tensor:
    """Torch twin of :func:`pack_w3_wide_np`: packs ``[K, N]`` 3-bit codes
    into the wide single plane (int32 ``[3K/32, N]``) on the codes' device."""
    k, n = codes.shape
    if k % chunk != 0:
        raise ValueError(f"K={k} must be a multiple of pack chunk {chunk}")
    if chunk % 256 != 0:
        raise ValueError(f"chunk={chunk} incompatible with wide 3-bit layout")
    c = codes.to(torch.int64)
    pairs = c[0::2] | (c[1::2] << 3)  # [K/2, N]
    ntrip = chunk // 32
    pr = pairs.reshape(k // chunk, 16, ntrip, n)
    grp = torch.zeros((k // chunk, 3, ntrip, n), dtype=torch.int64, device=codes.device)
    for j, w, off in _W3_FIELDS:
        grp[:, w] |= (pr[:, j] << off) & 0xFFFFFFFF
        if off + 6 > 32:
            grp[:, w + 1] |= pr[:, j] >> (32 - off)
    return _to_int32_words(grp.reshape(k * 3 // bitutils.WORD_BITS, n))


def unpack_w3_wide(plane: torch.Tensor, *, chunk: int = DEFAULT_CHUNK) -> torch.Tensor:
    """Torch twin of :func:`unpack_w3_wide_np` -> ``[K, N]`` int32 codes."""
    rows, n = plane.shape
    k = rows * bitutils.WORD_BITS // 3
    ntrip = chunk // 32
    w = (plane.to(torch.int64) & 0xFFFFFFFF).reshape(k // chunk, 3, ntrip, n)
    pf = []
    for _, a, off in _W3_FIELDS:
        v = w[:, a] >> off
        if off + 6 > 32:
            v = v | (w[:, a + 1] << (32 - off))
        pf.append(v & 0x3F)
    pairs = torch.stack(pf, dim=1).reshape(k // 2, n)
    return torch.stack([pairs & 7, pairs >> 3], dim=1).reshape(k, n).to(torch.int32)


def pack(
    codes,
    num_bits: int,
    *,
    chunk: int = DEFAULT_CHUNK,
    wide: bool = False,
    device=None,
) -> list[torch.Tensor]:
    """Pack ``[K, N]`` codes (numpy or tensor) into the pair-plane layout
    (or the wide 3-bit one) with the torch packers, on ``device``: the
    codes' device for a tensor; otherwise ``cuda`` unless named."""
    if isinstance(codes, torch.Tensor):
        dev = codes.device if device is None else torch.device(device)
    else:
        dev = resolve_device(device)
        codes = torch.from_numpy(np.ascontiguousarray(codes))
    codes = codes.to(dev)
    if wide:
        return [pack_w3_wide(codes, chunk=chunk)]
    return pack_plane(codes, num_bits, chunk=chunk)


def unpack(
    planes: Sequence[torch.Tensor],
    num_bits: int,
    *,
    chunk: int = DEFAULT_CHUNK,
    layout: str = "auto",
) -> torch.Tensor:
    """``[K, N]`` int32 codes of packed planes, on the planes' device."""
    if layout == "w4sym":
        return unpack_w4_sym(planes[0], chunk=chunk)
    if layout == "w3wide" or (num_bits == 3 and len(planes) == 1):
        return unpack_w3_wide(planes[0], chunk=chunk)
    return unpack_plane(planes, num_bits, chunk=chunk)


# ---------------------------------------------------------------------------
# Tables
# ---------------------------------------------------------------------------


def sym_code_order(table_ascending: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Map an ascending sign-symmetric table to sign-magnitude code order.

    Returns ``(table_sym, perm)``: ``table_sym[c]`` is the value of
    sign-magnitude code c (``table_sym[c + H] == -table_sym[c]``,
    H = 2^(b-1)) and ``code_sym = perm[code_ascending]``.
    """
    v = np.asarray(table_ascending, np.float32)
    e = v.shape[0]
    h = e // 2
    if not np.allclose(v[:h][::-1], -v[h:], rtol=0, atol=1e-6 * np.abs(v).max()):
        raise ValueError("table is not sign-symmetric (v[i] != -v[e-1-i])")
    table_sym = np.concatenate([v[h:], -v[h:]])
    perm = np.empty(e, np.int64)
    for a in range(e):
        perm[a] = (a - h) if a >= h else (h + (h - 1 - a))
    return table_sym.astype(np.float32), perm


def is_symmetric_table(table, num_bits: int) -> bool:
    """True when ``table`` (sign-magnitude order) satisfies the w4sym
    contract ``table[c + H] == -table[c]`` bit for bit."""
    t = np.ascontiguousarray(_as_numpy(table), np.float32)
    e = 2**num_bits
    if t.shape[-1] != e:
        return False
    h = e // 2
    lo = t[..., :h].view(np.uint32)
    hi = t[..., h:].view(np.uint32)
    return bool(np.all(hi == (lo ^ np.uint32(0x80000000))))


def is_ascending_symmetric_table(table, num_bits: int) -> bool:
    """True for an ascending table with ``v[i] == -v[2^b-1-i]`` exactly.
    Convert with :func:`sym_code_order` before packing w4sym."""
    t = np.ascontiguousarray(_as_numpy(table), np.float32)
    e = 2**num_bits
    if t.shape[-1] != e or np.any(np.diff(t) < 0):
        return False
    a = t.view(np.uint32)
    b = t[..., ::-1].copy().view(np.uint32)
    return bool(np.all(a == (b ^ np.uint32(0x80000000))))


def is_w3_wide(planes, num_bits: int, k: int) -> bool:
    """Detect the wide 3-bit layout from plane structure."""
    if num_bits != 3:
        return False
    return len(planes) == 1 and planes[0].shape[0] == k * 3 // bitutils.WORD_BITS


def _as_numpy(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().float().numpy()
    return np.asarray(a)


# ---------------------------------------------------------------------------
# The GEMM as its own inverse
# ---------------------------------------------------------------------------


def _plane_k(planes, num_bits: int) -> int:
    if num_bits == 3 and len(planes) == 1:
        return planes[0].shape[0] * bitutils.WORD_BITS // 3  # wide layout
    pb0 = bitutils.planes_for_bits(num_bits)[0]
    return planes[0].shape[0] * bitutils.WORD_BITS // pb0


def reconstruct(
    planes: Sequence[torch.Tensor],
    scales: torch.Tensor,
    table: torch.Tensor,
    num_bits: int,
    *,
    chunk: int = DEFAULT_CHUNK,
    use_kernel: bool = True,
    layout: str = "auto",
) -> torch.Tensor:
    """Dequantize packed weights to ``[K, N]`` by running the GEMM with an
    identity input (or, without the kernel, by unpacking the codes)."""
    from flute_tpu_torch.ops import lut_gemm  # imports this module

    k = _plane_k(planes, num_bits)
    if use_kernel:
        eye = torch.eye(k, dtype=scales.dtype, device=scales.device)
        return lut_gemm.lut_qgemm(
            eye, list(planes), scales, table, num_bits=num_bits,
            config=KernelConfig(chunk=chunk), layout=layout,
        )
    codes = unpack(planes, num_bits, chunk=chunk, layout=layout)
    return lut_gemm.dequantize_codes(codes, scales, table, scales.dtype)


def unpack_via_kernel(
    planes: Sequence[torch.Tensor],
    num_bits: int,
    n: int,
    k: int,
    *,
    chunk: int = DEFAULT_CHUNK,
    layout: str = "auto",
) -> torch.Tensor:
    """Recover codes by reconstructing with an identity table and unit
    scales. Exact because integers up to 256 are exact in bf16 and f32."""
    from flute_tpu_torch.ops import lut_gemm  # imports this module

    device = planes[0].device
    if layout == "auto":
        layout = "w3wide" if is_w3_wide(planes, num_bits, k) else "plane"
    ct = torch.bfloat16 if layout in ("w3wide", "w4sym") else torch.float32
    if layout == "w4sym":
        # sign-distinguishing identity table honouring the symmetric
        # contract: t[c] = c+1 for magnitudes, -(m+1) for the sign half
        h = 2 ** (num_bits - 1)
        mags = torch.arange(1, h + 1, dtype=torch.float32, device=device)
        table = torch.cat([mags, -mags])
    else:
        table = torch.arange(2**num_bits, dtype=torch.float32, device=device)
    scales = torch.ones((k // 64, n), dtype=ct, device=device)
    eye = torch.eye(k, dtype=ct, device=device)
    deq = lut_gemm.lut_qgemm(
        eye, list(planes), scales, table, num_bits=num_bits,
        config=KernelConfig(chunk=chunk), layout=layout,
    )
    v = torch.round(deq.float()).to(torch.int32)
    if layout == "w4sym":
        h = 2 ** (num_bits - 1)
        return torch.where(v > 0, v - 1, h - 1 - v)
    return v
