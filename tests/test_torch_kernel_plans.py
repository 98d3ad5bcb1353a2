"""The plans of the tensor-core kernels, held on the CPU.

* The loop (``csrc/lut_gemm_mma.cuh``) with its pair decoder
  (``csrc/lut_gemm_pair_decoder.cuh``) for K4 (``csrc/lut_gemm_pair.cu``),
  K1 (``csrc/lut_gemm_w4sym.cu``) and K2 (``csrc/lut_gemm_plane.cu``): the
  index map mirrored in ``lut_gemm.mma_k_order`` / ``mma_columns`` is a
  permutation of each pack chunk's K rows and of a block's columns; each
  kernel's table fill, mirrored in ``lut_gemm.pair_table``, gives K1 every
  w4sym byte's pair as ``dequantize_codes`` does, bit for bit; the product
  computed step by step through the index map, each B fragment decoded from
  the port's packed words and that table as the kernel decodes them, equals
  the JAX package's ``lut_qgemm`` (interpret mode: ``pair_values`` for K4,
  ``layout="w4sym"`` for K1, the plane layout in gather8 mode for K2) within
  the bf16 threshold, and every decoded B value equals the oracle
  (``dequantize_codes_pair`` or ``dequantize_codes``) bit for bit.
* The split-K planner (``kernel_config.mma_plan``) at the four
  Llama-3.1-8B projections: splits divide the chunk count, the grid has at
  least 132 blocks where one pass would not, the split is the same at every
  M (so a row's result does not depend on M), and the wrapper allocates
  exactly the planned workspace and passes the plan; the K1 and K2 wrappers
  pass a plan in bf16 and f16 and none (their SIMT kernel) in f32 or at a
  chunk the loop does not take.
* K6 (``verify_mma_kernel`` in ``csrc/paged_attention.cu``): a torch
  emulation of its numerics (64-row tiles of 16-row warps, online softmax
  over 16-position pieces with the warp's skips, P rounded to the input
  dtype before PV) against JAX ``paged_verify_attention`` (interpret mode)
  for every softcap/window option, bf16 and f16, within 1.1e-2 of the
  largest output.
"""

import contextlib
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flute_tpu.ops import lut_gemm as jlut
from flute_tpu.ops import paged_attention as jpa
from flute_tpu.ops.kernel_config import KernelConfig as JKernelConfig
from flute_tpu_torch import bitutils, packing
from flute_tpu_torch.ops import kernel_config, lut_gemm, paged_attention

K, N, G = 512, 256, 64
BF16_TOL = 1.1e-2


def rel_err(y, ref):
    y, ref = np.asarray(y, np.float64), np.asarray(ref, np.float64)
    return float(np.linalg.norm(y - ref) / np.linalg.norm(ref))


@pytest.mark.parametrize("bits", [2, 3, 4])
@pytest.mark.parametrize("chunk", [128, 256, 512])
def test_k4_index_map_is_a_permutation(bits, chunk):
    order = lut_gemm.mma_k_order(bits, chunk)
    pb0 = 4 if bits == 4 else 2
    kc = chunk * pb0 // bitutils.WORD_BITS
    assert tuple(order.shape) == (kc // 4, 32 // (2 * pb0) // 2, 16)
    assert sorted(order.flatten().tolist()) == list(range(chunk))
    # an mma step's two halves are 8 consecutive K rows each (one ldmatrix row)
    for half in (order[..., :8], order[..., 8:]):
        assert torch.equal(half - half[..., :1], torch.arange(8).expand_as(half))
    cols = lut_gemm.mma_columns()
    assert sorted(cols.flatten().tolist()) == list(range(kernel_config.MMA_BLOCK_N))


def w3wide_field(plane, c, j, i, kc):
    """Field i of triple row j of chunk c (``[N]``), as ``W3WideDecoder::pair``
    takes it from the three words at rows ``c * 3 kc + j``, ``+ kc``, ``+ 2 kc``:
    fields 5 and 10 join the top bits of one word to the low bits of the
    next with logical shifts."""
    a, b, c_ = ((plane[c * 3 * kc + j + r * kc].to(torch.int64) & 0xFFFFFFFF) for r in range(3))
    if i < 5:
        f = a >> (6 * i)
    elif i == 5:
        f = (a >> 30) | (b << 2)
    elif i < 10:
        f = b >> (6 * i - 32)
    elif i == 10:
        f = (b >> 28) | (c_ << 4)
    else:
        f = c_ >> (6 * i - 64)
    return f & 63


def decode_step_b(planes, ptab, scales, bits, chunk, c, q, s, dtype, layout="pair", g=G):
    """The B fragment of mma step (q, s) of chunk c as the kernel forms it:
    ``[16, N]``, slot ``2t + r`` (+ 8 for field 2s + 1) is row r of the pair
    that field i of word row 4q + t names in the pair table ``ptab``
    (``lut_gemm.pair_table``, already in ``dtype``) times its scale, the
    product rounded once. The index is the w4sym byte itself for K1, the
    six-bit field of a word triple for K3, else ``ce | co << bits`` (at 3
    bits with the 1-bit plane's bits)."""
    pb0 = 4 if bits == 4 else 2
    kc0 = kernel_config.mma_word_rows(bits, chunk, layout)
    kc1 = chunk // bitutils.WORD_BITS
    e = 2**bits
    w0 = planes[0].to(torch.int64) & 0xFFFFFFFF
    out = torch.empty((16, planes[0].shape[1]), dtype=dtype)
    order = lut_gemm.mma_k_order(bits, chunk, layout)
    for slot in range(16):
        t, r, i = (slot % 8) // 2, slot % 2, 2 * s + slot // 8
        j = 4 * q + t
        if layout == "w3wide":
            index = w3wide_field(planes[0], c, j, i, kc0)
            k_row = c * chunk + int(order[q, s, slot])
            out[slot] = ptab[index, r] * scales[k_row // g].to(dtype)
            continue
        f = (w0[c * kc0 + j] >> (2 * pb0 * i)) & ((1 << 2 * pb0) - 1)
        if layout == "w4sym":
            index = f
        else:
            ce, co = f & ((1 << pb0) - 1), f >> pb0
            if bits == 3:
                w1 = planes[1].to(torch.int64) & 0xFFFFFFFF
                h = (w1[c * kc1 + j % kc1] >> (2 * (2 * i + j // kc1))) & 3
                ce, co = ce | ((h & 1) << 2), co | ((h >> 1) << 2)
            assert int(ce.max()) < e and int(co.max()) < e
            index = ce | (co << bits)
        k_row = c * chunk + int(order[q, s, slot])
        out[slot] = ptab[index, r] * scales[k_row // g].to(dtype)
    return out


def product_through_the_index_map(x, planes, ptab, scales, deq, bits, chunk, dtype, layout,
                                  g=G):
    """``x @ W`` summed mma step by mma step through ``mma_k_order``, each B
    fragment decoded as the kernel decodes it and held to the oracle's
    ``deq`` bit for bit; f32 sums."""
    order = lut_gemm.mma_k_order(bits, chunk, layout)
    y = torch.zeros((x.shape[0], deq.shape[1]), dtype=torch.float32)
    for c in range(x.shape[1] // chunk):
        for q in range(order.shape[0]):
            for s in range(order.shape[1]):
                rows = c * chunk + order[q, s]
                b = decode_step_b(planes, ptab, scales, bits, chunk, c, q, s, dtype, layout, g)
                assert torch.equal(b.view(torch.int16), deq[rows].view(torch.int16))
                y += x[:, rows].float() @ b.float()
    return y


@pytest.mark.parametrize("bits", [2, 3, 4])
@pytest.mark.parametrize("chunk", [128, 256])
def test_k4_product_through_the_index_map_matches_jax(bits, chunk):
    rng = np.random.default_rng(40 + bits + chunk)
    e = 2**bits
    codes = rng.integers(0, e, (K, N), dtype=np.int32)
    planes_np = packing.pack_np(codes, bits, chunk=chunk)
    pv_np = rng.standard_normal((e, e, 2)).astype(np.float32)
    scales_np = rng.uniform(0.5, 1.5, (K // G, N)).astype(np.float32)
    x_np = rng.standard_normal((5, K)).astype(np.float32)
    dtype = torch.bfloat16
    planes = [torch.from_numpy(p) for p in planes_np]
    pv = torch.from_numpy(pv_np)
    scales = torch.from_numpy(scales_np).to(dtype)
    x = torch.from_numpy(x_np).to(dtype)
    deq = lut_gemm.dequantize_codes_pair(torch.from_numpy(codes), scales, pv, dtype)
    y = product_through_the_index_map(x, planes, lut_gemm.pair_table("pair", pv, dtype), scales,
                                      deq, bits, chunk, dtype, "pair")

    want = jlut.lut_qgemm(
        jnp.asarray(x_np, jnp.bfloat16), [jnp.asarray(p) for p in planes_np],
        jnp.asarray(scales_np, jnp.bfloat16), jnp.zeros((e,), jnp.float32), num_bits=bits,
        config=JKernelConfig(block_m=8, block_n=128, block_k=256, lut_mode="pair_lut",
                             chunk=chunk),
        pair_values=jnp.asarray(pv_np), interpret=True)
    assert rel_err(y.to(dtype).float(), np.asarray(want, np.float32)) < BF16_TOL


def w4sym_table(rng, mixed_signs):
    """8 magnitudes (sorted and positive, or of either sign) and their
    negations: the w4sym table contract ``table[c + 8] == -table[c]``."""
    mags = rng.standard_normal(8).astype(np.float32)
    if not mixed_signs:
        mags = np.sort(np.abs(mags))
    return np.concatenate([mags, -mags])


@pytest.mark.parametrize("mixed_signs", [False, True])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_k1_every_byte_decodes_to_the_oracles_pair(dtype, mixed_signs):
    table = torch.from_numpy(w4sym_table(np.random.default_rng(50 + mixed_signs), mixed_signs))
    f = torch.arange(256)
    even = (f & 7) + 8 * ((f >> 6) & 1)  # code 8 s + m of each K row of the pair
    odd = ((f >> 3) & 7) + 8 * (f >> 7)
    want = lut_gemm.dequantize_codes(torch.stack([even, odd]), torch.ones((1, 256), dtype=dtype),
                                     table, dtype)  # [2, 256]: rows (even, odd)
    got = lut_gemm.pair_table("w4sym", table, dtype)
    assert tuple(got.shape) == (256, 2)
    assert torch.equal(got.T.contiguous().view(torch.int16), want.view(torch.int16))


@pytest.mark.parametrize("layout,bits", [("w4sym", 4), ("plane", 2), ("plane", 3), ("plane", 4)])
@pytest.mark.parametrize("chunk", [128, 256])
def test_k1_k2_product_through_the_index_map_matches_jax(layout, bits, chunk):
    rng = np.random.default_rng(60 + bits + chunk + (layout == "w4sym"))
    e = 2**bits
    codes = rng.integers(0, e, (K, N), dtype=np.int32)
    if layout == "w4sym":
        planes_np = packing.pack_w4_sym_np(codes, chunk=chunk)
        table_np = w4sym_table(rng, mixed_signs=True)
    else:
        planes_np = packing.pack_np(codes, bits, chunk=chunk)
        table_np = rng.standard_normal(e).astype(np.float32)
    scales_np = rng.uniform(0.5, 1.5, (K // G, N)).astype(np.float32)
    x_np = rng.standard_normal((5, K)).astype(np.float32)
    dtype = torch.bfloat16
    planes = [torch.from_numpy(p) for p in planes_np]
    table = torch.from_numpy(table_np)
    scales = torch.from_numpy(scales_np).to(dtype)
    x = torch.from_numpy(x_np).to(dtype)
    deq = lut_gemm.dequantize_codes(torch.from_numpy(codes), scales, table, dtype)
    y = product_through_the_index_map(x, planes, lut_gemm.pair_table(layout, table, dtype),
                                      scales, deq, bits, chunk, dtype, layout)

    want = jlut.lut_qgemm(
        jnp.asarray(x_np, jnp.bfloat16), [jnp.asarray(p) for p in planes_np],
        jnp.asarray(scales_np, jnp.bfloat16), jnp.asarray(table_np), num_bits=bits,
        config=JKernelConfig(block_m=8, block_n=128, block_k=256, lut_mode="gather8",
                             chunk=chunk),
        layout=layout, interpret=True)
    assert rel_err(y.to(dtype).float(), np.asarray(want, np.float32)) < BF16_TOL


@pytest.mark.parametrize("chunk", [256, 512, 768])
def test_k3_index_map_is_a_permutation(chunk):
    """K3's loop geometry: chunk / 32 triple rows of 16 fields, items of 4
    rows, each mma half 8 consecutive K rows."""
    order = lut_gemm.mma_k_order(3, chunk, "w3wide")
    kc = chunk // 32
    assert kernel_config.mma_word_rows(3, chunk, "w3wide") == kc
    assert tuple(order.shape) == (kc // 4, 8, 16)
    assert sorted(order.flatten().tolist()) == list(range(chunk))
    for half in (order[..., :8], order[..., 8:]):
        assert torch.equal(half - half[..., :1], torch.arange(8).expand_as(half))


@pytest.mark.parametrize("chunk", [256, 512])
def test_k3_every_field_is_its_pair_of_codes(chunk):
    """Field i of triple row j of chunk c, the straddling fields 5 and 10
    included, is ``ce | co << 3`` of pair-row ``c * chunk / 2 + i * kc + j``;
    the pair table names ``(table[ce], table[co])`` as ``dequantize_codes``
    rounds them."""
    rng = np.random.default_rng(80 + chunk)
    codes = rng.integers(0, 8, (2 * chunk, N), dtype=np.int32)
    plane = torch.from_numpy(packing.pack_w3_wide_np(codes, chunk=chunk)[0])
    kc = chunk // 32
    pairs = torch.from_numpy(codes[0::2] | (codes[1::2] << 3)).long()
    for c in range(2):
        for j in range(kc):
            for i in range(16):
                want = pairs[c * chunk // 2 + i * kc + j]
                assert torch.equal(w3wide_field(plane, c, j, i, kc), want), (c, j, i)
    table = torch.from_numpy(rng.standard_normal(8).astype(np.float32))
    for dtype in (torch.bfloat16, torch.float16):
        f = torch.arange(64)
        want = lut_gemm.dequantize_codes(torch.stack([f & 7, f >> 3]),
                                         torch.ones((1, 64), dtype=dtype), table, dtype)
        got = lut_gemm.pair_table("w3wide", table, dtype)
        assert torch.equal(got.T.contiguous().view(torch.int16), want.view(torch.int16))


@pytest.mark.parametrize("g", [32, 64, 128])
@pytest.mark.parametrize("chunk", [256, 512])
def test_k3_product_through_the_index_map_matches_jax(chunk, g):
    """K3 on the loop: every decoded B value equals ``dequantize_codes`` bit
    for bit, and the product through the index map equals JAX's w3wide
    kernel (interpret mode) within the bf16 threshold."""
    rng = np.random.default_rng(90 + chunk + g)
    codes = rng.integers(0, 8, (K, N), dtype=np.int32)
    planes_np = packing.pack_w3_wide_np(codes, chunk=chunk)
    table_np = rng.standard_normal(8).astype(np.float32)
    scales_np = rng.uniform(0.5, 1.5, (K // g, N)).astype(np.float32)
    x_np = rng.standard_normal((5, K)).astype(np.float32)
    dtype = torch.bfloat16
    planes = [torch.from_numpy(p) for p in planes_np]
    table = torch.from_numpy(table_np)
    scales = torch.from_numpy(scales_np).to(dtype)
    x = torch.from_numpy(x_np).to(dtype)
    deq = lut_gemm.dequantize_codes(torch.from_numpy(codes), scales, table, dtype)
    y = product_through_the_index_map(x, planes, lut_gemm.pair_table("w3wide", table, dtype),
                                      scales, deq, 3, chunk, dtype, "w3wide", g)

    want = jlut.lut_qgemm(
        jnp.asarray(x_np, jnp.bfloat16), [jnp.asarray(p) for p in planes_np],
        jnp.asarray(scales_np, jnp.bfloat16), jnp.asarray(table_np), num_bits=3,
        config=JKernelConfig(block_m=8, block_n=128, block_k=chunk, lut_mode="gather8",
                             chunk=chunk),
        layout="w3wide", interpret=True)
    assert rel_err(y.to(dtype).float(), np.asarray(want, np.float32)) < BF16_TOL


LLAMA_8B = [("qkv", 6144, 4096), ("o", 4096, 4096), ("gate_up", 28672, 4096),
            ("down", 4096, 14336)]


@pytest.mark.parametrize("m", [1, 8, 512])
@pytest.mark.parametrize("name,n,k", LLAMA_8B)
def test_split_k_planner(monkeypatch, name, n, k, m):
    chunk = 256
    plan = kernel_config.mma_plan(m, n, k, chunk)
    nchunks = k // chunk
    assert nchunks % plan.splits == 0
    assert m <= 16 * plan.m_tiles or plan.m_tiles == max(kernel_config.MMA_M_TILES)
    cols = -(-n // kernel_config.MMA_BLOCK_N)
    rows = -(-m // (16 * plan.m_tiles))
    assert plan.grid == (cols, plan.splits, rows)
    one_pass = cols * rows
    if one_pass < 132:
        assert plan.blocks >= 132
    # the same split at every M: a row's sums run in one order in any batch
    for other in (1, 8, 64, 512):
        assert kernel_config.mma_plan(other, n, k, chunk).splits == plan.splits

    # the wrapper allocates exactly the planned workspace and passes the plan
    allocated, calls = [], []
    empty = torch.empty

    def recording_empty(*shape, **kw):
        t = empty(*shape, **kw)
        if kw.get("dtype") == torch.float32:
            allocated.append(tuple(t.shape))
        return t

    def fake_entry(*args):
        calls.append(args)
        return 0

    monkeypatch.setattr(lut_gemm, "_kernel_fn", lambda kernel: (fake_entry, None))
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev: types.SimpleNamespace(cuda_stream=0))
    monkeypatch.setattr(torch.cuda, "device", lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch, "empty", recording_empty)
    x = torch.zeros((m, k), dtype=torch.bfloat16)
    scales = torch.zeros((k // G, n), dtype=torch.bfloat16)
    pv = torch.zeros((16, 16, 2))
    lut_gemm._launch("pair", x, [0, None], scales, pv, group_size=G, chunk=chunk,
                     extra=(4,), plan=plan)
    want = plan.workspace_shape(m, n)
    assert allocated == ([] if want is None else [want])
    assert want is None or want == (plan.splits, m, n)
    (args,) = calls
    assert (args[6] is None) == (plan.splits == 1)  # the workspace pointer
    assert args[-4:-1] == (plan.m_tiles, plan.splits, 1)


@pytest.mark.parametrize("chunk", ["loop", "simt"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16, torch.float32])
@pytest.mark.parametrize("layout,bits", [("w4sym", 4), ("plane", 2), ("plane", 3), ("plane", 4)])
def test_k1_k2_wrappers_pick_the_path_before_the_launch(monkeypatch, layout, bits, dtype, chunk):
    """bf16 and f16 at a chunk the loop takes pass mma_plan's plan (and its
    workspace); f32, or a chunk whose first plane has no multiple of 4 word
    rows, pass m_tiles 0 (the SIMT kernel) and no workspace. One launch is
    counted either way."""
    m, n, k = 8, 256, 512
    chunk = 256 if chunk == "loop" else (16 if bits == 4 else 32)
    rng = np.random.default_rng(70 + bits)
    codes = rng.integers(0, 2**bits, (k, n), dtype=np.int32)
    if layout == "w4sym":
        planes = packing.pack_w4_sym_np(codes, chunk=chunk)
    else:
        planes = packing.pack_np(codes, bits, chunk=chunk)
    planes = [torch.from_numpy(p) for p in planes]
    table = torch.zeros(16 if layout == "w4sym" else 2**bits)
    x = torch.zeros((m, k), dtype=dtype)
    scales = torch.zeros((k // G, n), dtype=dtype)
    calls = []

    def fake_entry(*args):
        calls.append(args)
        return 0

    monkeypatch.setattr(lut_gemm, "_kernel_fn", lambda kernel: (fake_entry, None))
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev: types.SimpleNamespace(cuda_stream=0))
    monkeypatch.setattr(torch.cuda, "device", lambda dev: contextlib.nullcontext())
    before = lut_gemm.LAUNCHES[layout]
    kw = dict(group_size=G, chunk=chunk)
    if layout == "w4sym":
        lut_gemm.lut_qgemm_w4sym_cuda(x, planes[0], scales, table, **kw)
    else:
        lut_gemm.lut_qgemm_plane_cuda(x, planes, scales, table, num_bits=bits, **kw)
    assert lut_gemm.LAUNCHES[layout] == before + 1

    loop = dtype != torch.float32 and chunk == 256
    assert lut_gemm.lut_path(dtype, bits, chunk) == ("mma" if loop else "simt")
    (args,) = calls
    block_m, m_tiles, splits, vec = args[-5:-1]
    work = args[5 if layout == "w4sym" else 6]
    assert block_m == kernel_config.launch_config(m).block_m
    if loop:
        plan = kernel_config.mma_plan(m, n, k, chunk)
        assert (m_tiles, splits, vec) == (plan.m_tiles, plan.splits, 1)
        assert (work is None) == (plan.splits == 1)
    else:
        assert (m_tiles, splits, vec, work) == (0, 1, 0, None)


@pytest.mark.parametrize("chunk", [256, 512, 1024])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16, torch.float32])
def test_k3_wrapper_picks_the_path_before_the_launch(monkeypatch, dtype, chunk):
    """K3 takes the tensor cores in bf16 and f16 at chunk 256 and 512
    (mma_plan's split, the same at every M: the loop with its workspace
    below MID_MIN_M rows, the wide-M kernel with none from WIDE_MIN_M) and
    the SIMT
    kernel in f32 and at chunk 1024, whose x ring would not fit shared
    memory. One launch is counted either way."""
    n, k = 256, 2048
    loop = dtype != torch.float32 and chunk != 1024
    assert kernel_config.mma_takes_chunk(3, chunk, "w3wide") == (chunk != 1024)
    assert lut_gemm.lut_path(dtype, 3, chunk, "w3wide") == ("mma" if loop else "simt")
    rng = np.random.default_rng(75)
    codes = rng.integers(0, 8, (k, n), dtype=np.int32)
    plane = torch.from_numpy(packing.pack_w3_wide_np(codes, chunk=chunk)[0])
    calls = []

    def fake_entry(*args):
        calls.append(args)
        return 0

    monkeypatch.setattr(lut_gemm, "_kernel_fn", lambda kernel: (fake_entry, None))
    monkeypatch.setattr(lut_gemm, "_entry", lambda *a: (lambda *args: fake_entry(a[1], *args),
                                                        None))
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev: types.SimpleNamespace(cuda_stream=0))
    monkeypatch.setattr(torch.cuda, "device", lambda dev: contextlib.nullcontext())
    splits = set()
    for m in (1, 8, 512):
        before = lut_gemm.LAUNCHES["w3wide"]
        lut_gemm.lut_qgemm_w3wide_cuda(torch.zeros((m, k), dtype=dtype), plane,
                                       torch.zeros((k // G, n), dtype=dtype), torch.zeros(8),
                                       group_size=G, chunk=chunk)
        assert lut_gemm.LAUNCHES["w3wide"] == before + 1
        if loop and kernel_config.mma_route(m, 3, chunk, "w3wide", G) == "wide":
            assert m >= kernel_config.WIDE_MIN_M
            entry, *args = calls[-1]
            assert entry == "flute_lut_qgemm_w3wide_wide"
            plan = kernel_config.wide_plan(m, n, k, chunk)
            assert args[-4:] == [lut_gemm._DTYPE_TAG[dtype], plan.splits, 1, 0]
            splits.add(plan.splits)
            continue
        block_m, m_tiles, n_splits, vec = calls[-1][-5:-1]
        work = calls[-1][5]
        assert block_m == kernel_config.launch_config(m).block_m
        if loop:
            plan = kernel_config.mma_plan(m, n, k, chunk)
            assert (m_tiles, n_splits, vec) == (plan.m_tiles, plan.splits, 1)
            assert (work is None) == (plan.splits == 1)
            splits.add(n_splits)
        else:
            assert (m_tiles, n_splits, vec, work) == (0, 1, 0, None)
    assert len(splits) <= 1  # a row's sums run in one order at every M


# K6: B sequences, 8 query heads on 2 KV heads (rep 4), blocks of 16
B, H, HKV, D, BS = 2, 8, 2, 64, 16
ROWS, WARP_ROWS, PIECE = 64, 16, 16
K6_OPTIONS = [(None, None), (30.0, None), (None, 24), (30.0, 24)]


def k6_emulation(q, kp, vp, tables, lengths, scale, softcap, window):
    """K6's arithmetic in torch: per (sequence, KV head, 64-row tile) and
    per 16-row warp, 16-position pieces from the tile's first stage on,
    skipping pieces no row of the warp may attend; f32 scores of the
    16-bit products, softcap, window, the -1e30 mask; online softmax; P
    rounded to the input dtype before PV; out = o / max(l, 1e-30)."""
    b_, t_, h_, d_ = q.shape
    rep = h_ // HKV
    r_all = t_ * rep
    out = torch.zeros_like(q)
    for b in range(b_):
        length = int(lengths[b])
        pos_all = torch.arange(tables.shape[1] * BS)
        blk = tables[b].long()[pos_all // BS]
        for kvh in range(HKV):
            kk = kp[blk, kvh, pos_all % BS].float()  # [S, D]
            vv = vp[blk, kvh, pos_all % BS]
            for r0 in range(0, r_all, ROWS):
                def att(r, r0=r0):
                    return length + min(r0 + r, r_all - 1) // rep + 1

                hi = att(ROWS - 1)
                lo = max(0, att(0) - window) if window is not None else 0
                s0 = lo // 64 * 64
                for w in range(ROWS // WARP_ROWS):
                    rr = [min(r0 + w * WARP_ROWS + i, r_all - 1) for i in range(WARP_ROWS)]
                    qrows = torch.stack([q[b, r // rep, kvh * rep + r % rep] for r in rr]).float()
                    atts = torch.tensor([length + r // rep + 1 for r in rr])
                    w_hi = att(w * WARP_ROWS + WARP_ROWS - 1)
                    w_lo = att(w * WARP_ROWS) - window if window is not None else 0
                    m = torch.full((WARP_ROWS,), -1e30)
                    l_ = torch.zeros(WARP_ROWS)
                    o = torch.zeros((WARP_ROWS, d_))
                    for pp in range(s0, hi, PIECE):
                        if pp >= w_hi or (window is not None and pp + PIECE <= w_lo):
                            continue
                        pos = torch.arange(pp, pp + PIECE)
                        live = (pos >= lo) & (pos < hi)  # staged, else zero-filled
                        at = pos.clamp(max=len(pos_all) - 1)
                        kpc = torch.where(live[:, None], kk[at], 0.0)
                        vpc = torch.where(live[:, None], vv[at], torch.zeros_like(vv[at]))
                        s = (qrows @ kpc.T) * scale
                        if softcap is not None:
                            s = torch.tanh(s / softcap) * softcap
                        valid = pos[None, :] < atts[:, None]
                        if window is not None:
                            valid &= pos[None, :] >= atts[:, None] - window
                        s = torch.where(valid, s, torch.tensor(-1e30))
                        m_new = torch.maximum(m, s.amax(dim=1))
                        alpha = torch.exp(m - m_new)
                        p = torch.exp(s - m_new[:, None])
                        l_ = l_ * alpha + p.sum(dim=1)
                        o = o * alpha[:, None] + p.to(q.dtype).float() @ vpc.float()
                        m = m_new
                    res = (o / l_.clamp_min(1e-30)[:, None]).to(q.dtype)
                    for i in range(WARP_ROWS):
                        r = r0 + w * WARP_ROWS + i
                        if r < r_all:
                            out[b, r // rep, kvh * rep + r % rep] = res[i]
    return out


@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
@pytest.mark.parametrize("softcap,window", K6_OPTIONS)
def test_k6_numerics_match_jax(softcap, window, dtype):
    rng = np.random.default_rng(7)
    t, mb, nb = 20, 5, 12  # 80 rows: a full tile and a ragged one per KV head
    q = rng.standard_normal((B, t, H, D)).astype(np.float32)
    kp, vp = (rng.standard_normal((nb, HKV, BS, D)).astype(np.float32) for _ in range(2))
    tables = rng.permutation(nb)[: B * mb].reshape(B, mb).astype(np.int32)
    lengths = np.array([3, 50], np.int32)  # T over 3 and over 50 cached positions
    jdt = getattr(jnp, dtype)
    want = jpa.paged_verify_attention(
        jnp.asarray(q, jdt), jnp.asarray(kp, jdt), jnp.asarray(vp, jdt), jnp.asarray(tables),
        jnp.asarray(lengths), softcap=softcap, window=window, interpret=True)
    tdt = getattr(torch, dtype)
    got = k6_emulation(torch.from_numpy(q).to(tdt), torch.from_numpy(kp).to(tdt),
                       torch.from_numpy(vp).to(tdt), torch.from_numpy(tables),
                       torch.from_numpy(lengths), D**-0.5, softcap, window)
    want = np.asarray(want, np.float32)
    err = float(np.abs(got.float().numpy() - want).max() / np.abs(want).max())
    assert np.isfinite(got.float().numpy()).all()
    assert err < BF16_TOL


# K5: 8 query heads on 2 KV heads (rep 4), head dim 64, blocks of 32
SPAN = paged_attention.DECODE_SPAN
K5_STAGE, K5_PIECE, K5_WARPS = 64, 16, 4
K5_OPTIONS = [(None, None), (30.0, None), (None, 300), (30.0, 300)]


def k5_emulation(q, kp, vp, tables, lengths, scale, softcap, window, span=SPAN):
    """K5's arithmetic in bf16/f16 (``decode_span_kernel`` and
    ``decode_merge_kernel``) in torch: per (sequence, KV head), the spans of
    ``span`` positions that hold a position it attends; in a span, 16-position
    pieces from the span's first 64-position stage on, piece p to warp p % 4,
    skipping pieces with nothing to attend; per warp f32 scores of the
    16-bit products, softcap, the -inf mask, online softmax, P rounded to
    the input dtype before PV; the warps merged in warp order, the spans in
    span order (the first span's weight a product, the rest fused adds); one
    span in the table is divided directly. Returns ``[B, H, D]``."""
    b_, h_, d_ = q.shape
    _, hkv, bs, _ = kp.shape
    mb = tables.shape[1]
    rep = h_ // hkv
    n_spans = -(-mb * bs // span)
    out = torch.empty_like(q)
    inf = float("inf")
    for b in range(b_):
        end = min(int(lengths[b]), mb * bs)
        first = max(0, end - window) if window is not None else 0
        pos_all = torch.arange(mb * bs)
        blk = tables[b].long()[pos_all // bs]
        for kvh in range(hkv):
            kk = kp[blk, kvh, pos_all % bs].float()
            vv = vp[blk, kvh, pos_all % bs]
            qr = q[b, kvh * rep:(kvh + 1) * rep].float()
            spans = []
            for sp in range(n_spans):
                start = sp * span
                lo, hi = max(start, first), min(start + span, end)
                if lo >= hi:
                    continue
                m = [torch.full((rep,), -inf) for _ in range(K5_WARPS)]
                l_ = [torch.zeros(rep) for _ in range(K5_WARPS)]
                o = [torch.zeros((rep, d_)) for _ in range(K5_WARPS)]
                s0 = start + (lo - start) // K5_STAGE * K5_STAGE
                for pp in range(s0, hi, K5_PIECE):
                    if pp + K5_PIECE <= lo:
                        continue
                    w = (pp - start) // K5_PIECE % K5_WARPS
                    pos = torch.arange(pp, pp + K5_PIECE)
                    live = (pos >= lo) & (pos < hi)
                    at = pos.clamp(max=mb * bs - 1)
                    kpc = torch.where(live[:, None], kk[at], 0.0)
                    vpc = torch.where(live[:, None], vv[at], torch.zeros_like(vv[at]))
                    sc = (qr @ kpc.T) * scale
                    if softcap is not None:
                        sc = torch.tanh(sc / softcap) * softcap
                    sc = torch.where(live[None, :], sc, torch.tensor(-inf))
                    m_new = torch.maximum(m[w], sc.amax(dim=1))
                    alpha = torch.exp(m[w] - m_new)
                    p = torch.exp(sc - m_new[:, None])
                    l_[w] = l_[w] * alpha + p.sum(dim=1)
                    o[w] = o[w] * alpha[:, None] + p.to(q.dtype).float() @ vpc.float()
                    m[w] = m_new
                mx = torch.stack(m).amax(dim=0)
                num, den = torch.zeros((rep, d_)), torch.zeros(rep)
                for w in range(K5_WARPS):
                    f = torch.where(m[w] == -inf, 0.0, torch.exp(m[w] - mx))
                    num = num + f[:, None] * o[w]
                    den = den + f * l_[w]
                spans.append((mx, num, den))
            if n_spans == 1 and spans:
                _, num, den = spans[0]
            elif spans:
                mx = torch.stack([sp_[0] for sp_ in spans]).amax(dim=0)
                num, den = None, None
                for m_s, num_s, den_s in spans:
                    f = torch.where(m_s == -inf, 0.0, torch.exp(m_s - mx))
                    num = f[:, None] * num_s if num is None else num + f[:, None] * num_s
                    den = f * den_s if den is None else den + f * den_s
            else:
                num, den = torch.zeros((rep, d_)), torch.zeros(rep)
            out[b, kvh * rep:(kvh + 1) * rep] = (num / den.clamp_min(1e-30)[:, None]).to(q.dtype)
    return out


def k5_case(rng, lengths, mb, dtype, bs=32, hkv=2, h=8, d=64):
    nb = len(lengths) * mb + 1
    q = rng.standard_normal((len(lengths), h, d)).astype(np.float32)
    kp, vp = (rng.standard_normal((nb, hkv, bs, d)).astype(np.float32) for _ in range(2))
    tables = rng.permutation(nb)[: len(lengths) * mb].reshape(len(lengths), mb).astype(np.int32)
    tdt = getattr(torch, dtype)
    return (q, kp, vp, tables, np.array(lengths, np.int32),
            [torch.from_numpy(a).to(tdt) for a in (q, kp, vp)])


@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
@pytest.mark.parametrize("softcap,window", K5_OPTIONS)
def test_k5_span_and_merge_numerics_match_jax(softcap, window, dtype):
    """Lengths 0, 1, P - 1, P, P + 1 and 4096 (16 spans) in a table wider
    than the longest sequence, against JAX ``paged_decode_attention``
    (interpret mode) within 1.1e-2 of the largest output; a slot of length 0
    gives 0 (JAX's softmax gives NaN there: ROADMAP queue 3 item 13)."""
    rng = np.random.default_rng(8)
    lengths = [0, 1, SPAN - 1, SPAN, SPAN + 1, 4096]
    q, kp, vp, tables, lens, (tq, tk, tv) = k5_case(rng, lengths, 4096 // 32 + 2, dtype)
    jdt = getattr(jnp, dtype)
    want = jpa.paged_decode_attention(
        jnp.asarray(q, jdt), jnp.asarray(kp, jdt), jnp.asarray(vp, jdt), jnp.asarray(tables),
        jnp.asarray(lens), softcap=softcap, window=window, interpret=True)
    got = k5_emulation(tq, tk, tv, torch.from_numpy(tables), torch.from_numpy(lens), 64**-0.5,
                       softcap, window)
    want = np.asarray(want, np.float32)[1:]
    assert not got[0].float().any()
    got = got[1:].float().numpy()
    assert np.isfinite(got).all()
    assert float(np.abs(got - want).max() / np.abs(want).max()) < BF16_TOL


@pytest.mark.parametrize("softcap,window", K5_OPTIONS)
@pytest.mark.parametrize("length", [1, SPAN - 1, SPAN + 1, 4096])
def test_k5_sequence_alone_equals_it_in_a_batch(length, softcap, window):
    """K5's spans depend on positions alone: a sequence in a batch of 8 with
    a table wider than its own has the bits it has alone with a table just
    wide enough (one span, divided directly, where it fits in one)."""
    rng = np.random.default_rng(9 + length)
    lengths = [length, 7, 4096, 0, SPAN, 300, 1, 1000]
    q, kp, vp, tables, lens, (tq, tk, tv) = k5_case(rng, lengths, 4096 // 32 + 3, "bfloat16")
    batch = k5_emulation(tq, tk, tv, torch.from_numpy(tables), torch.from_numpy(lens), 0.125,
                         softcap, window)
    mb = -(-length // 32)
    alone = k5_emulation(tq[:1], tk, tv, torch.from_numpy(tables[:1, :mb]),
                         torch.from_numpy(lens[:1]), 0.125, softcap, window)
    assert torch.equal(alone.view(torch.int16), batch[:1].view(torch.int16))


# ---------------------------------------------------------------------------
# The wide-M kernel (csrc/lut_gemm_wide_m.cuh): K1 and K2 at prefill M
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("bits", [2, 3, 4])
@pytest.mark.parametrize("chunk", [128, 256])
def test_wide_operand_map_is_the_loops_step_order(bits, chunk):
    """The K rows of each k16 step, taken as the wide-M kernel takes them on
    its x side (8-row stretches, the second a constant kc / 4 stretches
    after the first), cover the chunk once and equal the loop's step order;
    its A registers (the decoded pairs) name the same K rows at the k-slots
    where wgmma's A layout puts them."""
    order = lut_gemm.wide_k_order(bits, chunk)
    assert sorted(order.flatten().tolist()) == list(range(chunk))
    assert torch.equal(order, lut_gemm.mma_k_order(bits, chunk))
    a = lut_gemm.wide_a_rows(bits, chunk)
    q = torch.arange(order.shape[0])[:, None, None, None, None]
    s = torch.arange(order.shape[1])[None, :, None, None, None]
    t = torch.arange(4)[None, None, :, None, None]
    r = torch.arange(4)[None, None, None, :, None]
    h = torch.arange(2)[None, None, None, None, :]
    assert torch.equal(a, order[q, s, 2 * t + 8 * (r // 2) + h])


@pytest.mark.parametrize("splits", [1, 2])
@pytest.mark.parametrize("layout,bits", [("w4sym", 4), ("plane", 2), ("plane", 3), ("plane", 4),
                                         ("w3wide", 3), ("pair", 2), ("pair", 3), ("pair", 4)])
def test_wide_product_through_the_operand_map_matches_jax(layout, bits, splits):
    """``x @ W`` summed as the wide-M kernel sums it (its steps in
    ``wide_k_order``'s order, each step's A tile decoded from the packed
    words and the pair table as the kernel decodes it and held to the
    oracle bit for bit, an f32 accumulator a split added in split order)
    against JAX's weight-side branch (interpret mode, 128-row blocks) at a
    ragged M: K1, K2, K3 (its word triples at chunk 256) and K4 (the joint
    pair table, JAX's ``pair_lut`` mode)."""
    chunk, m = (256 if layout == "w3wide" else 128), 130
    rng = np.random.default_rng(80 + bits + splits + (layout == "w4sym")
                                + 20 * (layout in ("w3wide", "pair")))
    e = 2**bits
    codes = rng.integers(0, e, (K, N), dtype=np.int32)
    pv_np = None
    if layout == "w4sym":
        planes_np = packing.pack_w4_sym_np(codes, chunk=chunk)
        table_np = w4sym_table(rng, mixed_signs=True)
    elif layout == "w3wide":
        planes_np = packing.pack_w3_wide_np(codes, chunk=chunk)
        table_np = rng.standard_normal(e).astype(np.float32)
    else:
        planes_np = packing.pack_np(codes, bits, chunk=chunk)
        table_np = rng.standard_normal(e).astype(np.float32)
        if layout == "pair":
            pv_np = rng.standard_normal((e, e, 2)).astype(np.float32)
    scales_np = rng.uniform(0.5, 1.5, (K // G, N)).astype(np.float32)
    x_np = rng.standard_normal((m, K)).astype(np.float32)
    dtype = torch.bfloat16
    planes = [torch.from_numpy(p) for p in planes_np]
    table = torch.from_numpy(table_np)
    scales = torch.from_numpy(scales_np).to(dtype)
    x = torch.from_numpy(x_np).to(dtype).float()
    if pv_np is None:
        deq = lut_gemm.dequantize_codes(torch.from_numpy(codes), scales, table, dtype)
        ptab = lut_gemm.pair_table(layout, table, dtype)
    else:
        pv = torch.from_numpy(pv_np)
        deq = lut_gemm.dequantize_codes_pair(torch.from_numpy(codes), scales, pv, dtype)
        ptab = lut_gemm.pair_table("pair", pv, dtype)
    order = lut_gemm.wide_k_order(bits, chunk, layout)
    nchunks = K // chunk
    total = torch.zeros((m, N), dtype=torch.float32)
    for sp in range(splits):
        acc = torch.zeros_like(total)
        for c in range(sp * nchunks // splits, (sp + 1) * nchunks // splits):
            for q in range(order.shape[0]):
                for s in range(order.shape[1]):
                    rows = c * chunk + order[q, s]
                    a = decode_step_b(planes, ptab, scales, bits, chunk, c, q, s, dtype, layout)
                    assert torch.equal(a.view(torch.int16), deq[rows].view(torch.int16))
                    acc += x[:, rows] @ a.float()
        total += acc

    mode = dict(lut_mode="pair_lut") if pv_np is not None else {}
    want = jlut.lut_qgemm(
        jnp.asarray(x_np, jnp.bfloat16), [jnp.asarray(p) for p in planes_np],
        jnp.asarray(scales_np, jnp.bfloat16), jnp.asarray(table_np), num_bits=bits,
        config=JKernelConfig(block_m=128, block_n=256, block_k=256, chunk=chunk, **mode),
        layout="plane" if layout == "pair" else layout, interpret=True,
        pair_values=None if pv_np is None else jnp.asarray(pv_np))
    assert rel_err(total.to(dtype).float(), np.asarray(want, np.float32)) < BF16_TOL


@pytest.mark.parametrize("layout,bits", [("w4sym", 4), ("plane", 2), ("plane", 3), ("plane", 4),
                                         ("w3wide", 3), ("pair", 2), ("pair", 3), ("pair", 4)])
def test_wide_route_depends_on_m_alone(layout, bits):
    """Every layout (K1-K4) takes the wide-M kernel from WIDE_MIN_M rows at
    a chunk it takes (K3 at 256, 512 and 768); below, the mid route from
    MID_MIN_M rows, the loop under that. For a layer the route is a
    function of M alone."""
    assert layout in kernel_config.WIDE_LAYOUTS
    for chunk in (256, 512):
        assert kernel_config.wide_takes_chunk(bits, chunk, G, layout)
        for m in (1, 8, 40, 64, kernel_config.WIDE_MIN_M - 1, kernel_config.WIDE_MIN_M, 512,
                  2047, 4094):
            # below WIDE_MIN_M: from MID_MIN_M rows on the mid route
            mid = layout in kernel_config.MID_LAYOUTS and m >= kernel_config.MID_MIN_M
            want = "wide" if m >= kernel_config.WIDE_MIN_M else "mid" if mid else "loop"
            assert kernel_config.mma_route(m, bits, chunk, layout) == want
    # a layer whose ring would not fit shared memory (a long chunk in groups
    # of 2: hundreds of scale rows a stage) stays on the loop
    chunk = 768
    assert kernel_config.mma_takes_chunk(bits, chunk, layout)
    assert kernel_config.wide_takes_chunk(bits, chunk, 64, layout)
    assert not kernel_config.wide_takes_chunk(bits, chunk, 2, layout)
    assert kernel_config.mma_route(2047, bits, chunk, layout, 2) == "loop"
    # a chunk the loop does not take (K3: not a multiple of 256), or whose
    # stage holds one item of 4 or 8 fields (units that do not pair up)
    small = {"w3wide": 128, "pair": 32 if bits == 4 else 64}.get(layout)
    if small:
        assert kernel_config.mma_route(2047, bits, small, layout) == "loop"


@pytest.mark.parametrize("bits", [2, 3, 4])
@pytest.mark.parametrize("chunk", [128, 256, 512])
def test_k4_ring_is_k2s(bits, chunk):
    """K4's joint table has K2's size ((2^b)^2 pairs in 8 copies, 32 bits
    each: the pair decoder's Table), so its ring and its route are K2's at
    every chunk and group size."""
    for g in (2, 8, 32, 64, 128):
        if chunk % g == 0:
            assert (kernel_config.wide_ring(bits, chunk, g, "pair")
                    == kernel_config.wide_ring(bits, chunk, g, "plane"))
            assert (kernel_config.wide_takes_chunk(bits, chunk, g, "pair")
                    == kernel_config.wide_takes_chunk(bits, chunk, g, "plane"))


@pytest.mark.parametrize("g,chunk,want", [
    (64, 256, (1, 40576, 4)), (32, 256, (1, 41600, 4)), (128, 256, (1, 40064, 4)),
    (64, 512, (1, 41600, 4)), (128, 512, (1, 40576, 4)), (8, 512, (1, 55936, 4))])
def test_k3_wide_ring(g, chunk, want):
    """K3's ring (``csrc/lut_gemm_wide_m.cuh::Geometry`` for 16 fields and
    three planar words a triple row): a stage is one item (two would leave
    room for two stages only), 16 fields of 2 KB of x, each planar word's 4
    rows of 136 words, the chunk's scale rows; four stages beside its 64 x
    8-word table; an item's two halves pair up as the kernel's two sets of
    A registers."""
    q, stage, stages = kernel_config.wide_ring(3, chunk, g, "w3wide")
    assert (q, stage, stages) == want
    srows = -(-chunk // g) + 1
    x_bytes, words = 16 * q * 128 * 16, 3 * 4 * q * 136 * 4
    assert stage == -(-(-(-(x_bytes + words) // 128) * 128 + srows * 256) // 128) * 128
    assert stages * stage + 64 * 8 * 4 + 64 <= kernel_config.MAX_SMEM_BYTES
    assert (kernel_config.mma_word_rows(3, chunk, "w3wide") // 4) % q == 0


@pytest.mark.parametrize("chunk", [256, 512, 768])
def test_k3_wide_operand_map_is_the_loops_step_order(chunk):
    """K3's triples on the wide-M kernel: its x side (8-row stretches, the
    second kc / 4 stretches after the first) and its A registers (16 fields
    a triple row, an item's 8 steps in two halves) name the K rows of the
    loop's step order, which covers the chunk once."""
    order = lut_gemm.wide_k_order(3, chunk, "w3wide")
    assert tuple(order.shape) == (chunk // 128, 8, 16)
    assert sorted(order.flatten().tolist()) == list(range(chunk))
    assert torch.equal(order, lut_gemm.mma_k_order(3, chunk, "w3wide"))
    a = lut_gemm.wide_a_rows(3, chunk, "w3wide")
    q = torch.arange(order.shape[0])[:, None, None, None, None]
    s = torch.arange(order.shape[1])[None, :, None, None, None]
    t = torch.arange(4)[None, None, :, None, None]
    r = torch.arange(4)[None, None, None, :, None]
    h = torch.arange(2)[None, None, None, None, :]
    assert torch.equal(a, order[q, s, 2 * t + 8 * (r // 2) + h])


@pytest.mark.parametrize("m", [128, 130, 512, 2047, 4094])
@pytest.mark.parametrize("name,n,k", LLAMA_8B)
def test_wide_plan_keeps_the_split_and_needs_no_workspace(name, n, k, m):
    """The wide-M kernel's plan: the decode loop's split of K (the same at
    every M, so both routes sum a row in one order), one block a 128 x 128
    tile, no workspace; its ring at chunk 256 fits beside the pair table at
    every bit width."""
    chunk = 256
    plan = kernel_config.wide_plan(m, n, k, chunk)
    for other in (1, 8, 64, m):
        assert plan.splits == kernel_config.mma_plan(other, n, k, chunk).splits
    assert (k // chunk) % plan.splits == 0
    assert plan.grid == (-(-m // 128), -(-n // 128))
    assert plan.workspace_shape(m, n) is None
    # the ring (csrc/lut_gemm_wide_m.cuh::Geometry) at group size 64: four
    # stages of 4 items at 4 bits, three at 2, and at 3 bits (the 1-bit
    # plane's rows in every stage) four of 2 items
    want = {4: (4, 42752, 4), 2: (4, 75520, 3), 3: (2, 42752, 4)}
    for bits in (2, 3, 4):
        q, stage, stages = kernel_config.wide_ring(bits, chunk, G)
        assert (q, stage, stages) == want[bits]
        table = (2**bits) ** 2 * 8 * 4
        assert stages * stage + table + 64 <= kernel_config.MAX_SMEM_BYTES
        assert (kernel_config.mma_word_rows(bits, chunk) // 4) % q == 0


def _fake_launch(monkeypatch):
    """Record the C entries' arguments instead of calling them, and every
    float32 allocation (a split-K workspace)."""
    calls, allocated = [], []

    def fake_entry(*args):
        calls.append(args)
        return 0

    empty = torch.empty

    def recording_empty(*shape, **kw):
        t = empty(*shape, **kw)
        if kw.get("dtype") == torch.float32:
            allocated.append(tuple(t.shape))
        return t

    monkeypatch.setattr(lut_gemm, "_kernel_fn", lambda kernel: (fake_entry, None))
    monkeypatch.setattr(lut_gemm, "_entry", lambda *a: (lambda *args: calls.append(
        (a[1],) + args) or 0, None))
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev: types.SimpleNamespace(cuda_stream=0))
    monkeypatch.setattr(torch.cuda, "device", lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch, "empty", recording_empty)
    return calls, allocated


@pytest.mark.parametrize("m", [8, 130, 2047])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16, torch.float32])
@pytest.mark.parametrize("layout,bits", [("w4sym", 4), ("plane", 2), ("plane", 3), ("plane", 4)])
def test_k1_k2_wrappers_take_the_route_of_m(monkeypatch, layout, bits, dtype, m):
    """bf16 and f16 from WIDE_MIN_M rows launch the wide-M C entry with the
    plan's split and no workspace, counted in LAUNCHES and WIDE_LAUNCHES;
    below it the mid route from MID_MIN_M rows and the loop under that; f32
    the SIMT kernel at every M, wherever the crossover lies."""
    n, k, chunk = 256, 512, 256
    rng = np.random.default_rng(110 + bits)
    codes = rng.integers(0, 2**bits, (k, n), dtype=np.int32)
    if layout == "w4sym":
        planes = packing.pack_w4_sym_np(codes, chunk=chunk)
    else:
        planes = packing.pack_np(codes, bits, chunk=chunk)
    planes = [torch.from_numpy(p) for p in planes]
    table = torch.zeros(16 if layout == "w4sym" else 2**bits)
    x = torch.zeros((m, k), dtype=dtype)
    scales = torch.zeros((k // G, n), dtype=dtype)
    calls, allocated = _fake_launch(monkeypatch)
    kw = dict(group_size=G, chunk=chunk)

    def launch():
        if layout == "w4sym":
            return lut_gemm.lut_qgemm_w4sym_cuda(x, planes[0], scales, table, **kw)
        return lut_gemm.lut_qgemm_plane_cuda(x, planes, scales, table, num_bits=bits, **kw)

    for wide_min_m in (kernel_config.WIDE_MIN_M, 1, 1 << 30):
        monkeypatch.setattr(kernel_config, "WIDE_MIN_M", wide_min_m)
        calls.clear()
        allocated.clear()
        before, wide_before = dict(lut_gemm.LAUNCHES), dict(lut_gemm.WIDE_LAUNCHES)
        launch()
        route = ("simt" if dtype == torch.float32
                 else kernel_config.mma_route(m, bits, chunk, layout))
        assert route != "wide" or m >= wide_min_m
        assert lut_gemm.LAUNCHES[layout] == before[layout] + 1
        assert lut_gemm.WIDE_LAUNCHES[f"{layout}_wide"] == (
            wide_before[f"{layout}_wide"] + (route == "wide"))
        (args,) = calls
        if route == "wide":
            assert args[0] == f"flute_lut_qgemm_{layout}_wide"
            plan = kernel_config.wide_plan(m, n, k, chunk)
            extra = () if layout == "w4sym" else (bits,)
            want = (m, n, k, G, chunk, *extra, lut_gemm._DTYPE_TAG[dtype], plan.splits, 1)
            assert args[-len(want) - 1:-1] == want
            assert allocated == []
        elif route == "mid":  # below WIDE_MIN_M, from MID_MIN_M rows
            assert args[0] == f"flute_lut_qgemm_{layout}_mid"
            plan = kernel_config.mid_plan(m, n, k, chunk)
            assert args[-4:-1] == (plan.rows, plan.splits, 1)
            assert allocated == ([] if plan.splits == 1 else [(plan.splits, m, n)])
        else:
            assert args[0] != f"flute_lut_qgemm_{layout}_wide"
            assert args[-4] == (0 if route == "simt" else kernel_config.mma_plan(m, n, k,
                                                                                  chunk).m_tiles)


# ---------------------------------------------------------------------------
# The wide-M kernel's mid route (K1-K4 at 17-127 rows)
# ---------------------------------------------------------------------------

MID_CASES = [("w4sym", 4), ("plane", 2), ("plane", 3), ("plane", 4)]
ALL_LAYOUTS = MID_CASES + [("w3wide", 3), ("pair", 2), ("pair", 3), ("pair", 4)]


@pytest.mark.parametrize("m", [16, 17, 40, 48, 64, 65, 100, 127])
@pytest.mark.parametrize("name,n,k", LLAMA_8B)
def test_mid_plan_keeps_the_split(name, n, k, m):
    """The mid route's plan: the decode loop's split at every M (so every
    route sums a row in one order), the fewest row tiles of at most 64
    rows (40 rows: one of 48), grid (M / R, N / 128, splits), at least two
    blocks an SM, the loop's workspace [splits, M, N]; its ring at every
    row tile and bit width fits two blocks an SM beside the pair table,
    and 227 KB a block."""
    chunk = 256
    plan = kernel_config.mid_plan(m, n, k, chunk)
    for other in (1, 8, 40, 512, m):
        assert plan.splits == kernel_config.mma_plan(other, n, k, chunk).splits
    tiles = -(-m // 64)
    assert plan.rows in kernel_config.MID_ROWS and tiles * plan.rows >= m
    assert all(tiles * r < m for r in kernel_config.MID_ROWS if r < plan.rows)
    assert kernel_config.mid_plan(40, n, k, chunk).rows == 48
    assert plan.grid == (tiles, -(-n // 128), plan.splits)
    assert plan.blocks >= 2 * 132
    assert plan.workspace_shape(m, n) == ((plan.splits, m, n) if plan.splits > 1 else None)
    for bits in (2, 3, 4):
        table = (2**bits) ** 2 * 8 * 4
        for rows in kernel_config.MID_ROWS:
            q, stage, stages = kernel_config.wide_ring(bits, chunk, G, "plane", rows,
                                                       kernel_config.MID_BLOCKS)
            assert stages >= 2 and (kernel_config.mma_word_rows(bits, chunk) // 4) % q == 0
            smem = stages * stage + table + 64
            assert smem <= kernel_config.MAX_SMEM_BYTES
            assert kernel_config.MID_BLOCKS * (smem + 1024) <= kernel_config.SM_SMEM_BYTES
            x_bytes = (16 // (4 if bits == 4 else 2)) * q * rows * 16
            assert stage >= x_bytes


@pytest.mark.parametrize("layout,bits", ALL_LAYOUTS)
def test_mid_route_is_a_function_of_m(layout, bits):
    """Three routes by M alone, at chunks 256 and 512, for every layout
    (K1-K4): the loop below MID_MIN_M, the mid route from it to WIDE_MIN_M
    (a chunk and group size ``mid_takes_chunk`` takes), the wide-M kernel
    from WIDE_MIN_M. A
    layer whose ring would not fit the blocks an SM its instantiation is
    built for stays on the loop; K3 with the per-field scale cache (g = 8,
    not a multiple of 2 kc) takes the mid route at one block an SM."""
    assert layout in kernel_config.MID_LAYOUTS
    mid_min_m, wide_min_m = kernel_config.MID_MIN_M, kernel_config.WIDE_MIN_M
    # the verify's 40 rows and the paged admissions of 17-64 rows take the
    # mid route
    assert 1 <= mid_min_m <= 17 and 64 < wide_min_m
    for chunk in (256, 512):
        assert kernel_config.mid_takes_chunk(bits, chunk, G, layout)
        assert kernel_config.mid_blocks(bits, chunk, G, layout) == kernel_config.MID_BLOCKS
        if layout == "w3wide":
            assert kernel_config.mid_takes_chunk(bits, chunk, 8, layout)
            assert kernel_config.mid_blocks(bits, chunk, 8, layout) == 1
        for m in (1, 8, 15, 16, 17, 40, 48, 64, 96, 100, 127, 128, 192, 256, 512):
            if m >= wide_min_m:
                want = "wide"
            elif m >= mid_min_m:
                want = "mid"
            else:
                want = "loop"
            assert kernel_config.mma_route(m, bits, chunk, layout) == want, (m, chunk)
    assert not kernel_config.mid_takes_chunk(bits, 768, 2, layout)
    assert kernel_config.mma_route(40, bits, 768, layout, 2) == "loop"


def mid_product(x, planes, ptab, scales, deq, bits, chunk, dtype, layout, n, k):
    """``x @ W`` summed as the mid route sums it: row tiles of
    ``mid_rows(M)`` rows (ragged M zero-padded), each split of ``mma_plan``
    an f32 accumulator over its chunks' k16 steps in ``wide_k_order``'s
    order (each step's A tile decoded from the packed words and the pair
    table as the kernel decodes it, held to the oracle bit for bit),
    written to a workspace [splits, M, N] that is added in split order from
    0. numpy f32."""
    m = x.shape[0]
    plan = kernel_config.mid_plan(m, n, k, chunk)
    order = lut_gemm.wide_k_order(bits, chunk, layout)
    steps = []  # (K rows, A tile) of each k16 step, chunk by chunk
    for c in range(k // chunk):
        for q in range(order.shape[0]):
            for s in range(order.shape[1]):
                rows = c * chunk + order[q, s]
                a = decode_step_b(planes, ptab, scales, bits, chunk, c, q, s, dtype, layout)
                assert torch.equal(a.view(torch.int16), deq[rows].view(torch.int16))
                steps.append((rows.numpy(), a.float().numpy()))
    per_split = len(steps) // plan.splits
    xs = np.zeros((plan.grid[0] * plan.rows, k), np.float32)
    xs[:m] = x.float().numpy()
    work = np.zeros((plan.splits, xs.shape[0], n), np.float32)
    for tile in range(plan.grid[0]):
        xt = xs[tile * plan.rows:(tile + 1) * plan.rows]
        for sp in range(plan.splits):
            acc = np.zeros((plan.rows, n), np.float32)
            for rows, a in steps[sp * per_split:(sp + 1) * per_split]:
                acc += xt[:, rows] @ a
            work[sp, tile * plan.rows:(tile + 1) * plan.rows] = acc
    y = np.zeros((xs.shape[0], n), np.float32)
    for sp in range(plan.splits):
        y += work[sp]
    return y[:m], plan


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("m", [16, 40, 64])
@pytest.mark.parametrize("layout,bits", ALL_LAYOUTS)
def test_mid_product_through_the_operand_map_matches_jax(layout, bits, m, dtype):
    """The mid route's operand map (k16 steps in the loop's order, R-row
    tiles, ragged M, one split a block added in split order) in numpy
    against JAX's group-accumulating decode branch (interpret mode, which
    the TPU kernel takes for blocks of at most ``group_acc_max_bm`` rows):
    K1 (w4sym), K2 at 2, 3 and 4 bits, K3's word triples (16 six-bit
    fields a triple row, chunk 256) and K4's joint pair index map
    (``ce | co << b`` into the pair table, JAX's ``pair_lut`` mode), bf16
    and f16, within the reference thresholds."""
    chunk = 256 if layout == "w3wide" else 128
    tol = {torch.bfloat16: BF16_TOL, torch.float16: 2e-3}[dtype]
    rng = np.random.default_rng(120 + bits + m + (layout == "w4sym") + 7 * (layout == "pair")
                                + 11 * (layout == "w3wide"))
    codes = rng.integers(0, 2**bits, (K, N), dtype=np.int32)
    pv_np = None
    if layout == "w4sym":
        planes_np = packing.pack_w4_sym_np(codes, chunk=chunk)
        table_np = w4sym_table(rng, mixed_signs=True)
    elif layout == "w3wide":
        planes_np = packing.pack_w3_wide_np(codes, chunk=chunk)
        table_np = rng.standard_normal(8).astype(np.float32)
    else:
        planes_np = packing.pack_np(codes, bits, chunk=chunk)
        table_np = rng.standard_normal(2**bits).astype(np.float32)
        if layout == "pair":
            pv_np = rng.standard_normal((2**bits, 2**bits, 2)).astype(np.float32)
    scales_np = rng.uniform(0.5, 1.5, (K // G, N)).astype(np.float32)
    x_np = rng.standard_normal((m, K)).astype(np.float32)
    planes = [torch.from_numpy(p) for p in planes_np]
    table = torch.from_numpy(table_np)
    scales = torch.from_numpy(scales_np).to(dtype)
    x = torch.from_numpy(x_np).to(dtype)
    codes_t = torch.from_numpy(codes)
    if pv_np is None:
        deq = lut_gemm.dequantize_codes(codes_t, scales, table, dtype)
        ptab = lut_gemm.pair_table(layout, table, dtype)
    else:
        pv = torch.from_numpy(pv_np)
        deq = lut_gemm.dequantize_codes_pair(codes_t, scales, pv, dtype)
        ptab = lut_gemm.pair_table("pair", pv, dtype)
    y, plan = mid_product(x, planes, ptab, scales, deq, bits, chunk, dtype, layout, N, K)
    assert plan.splits > 1 and plan.rows == kernel_config.mid_rows(m)

    bm = 16 if m <= 16 else 64
    assert bm <= jlut._group_acc_max_bm()
    jd = {torch.bfloat16: jnp.bfloat16, torch.float16: jnp.float16}[dtype]
    want = jlut.lut_qgemm(
        jnp.asarray(x_np, jd), [jnp.asarray(p) for p in planes_np], jnp.asarray(scales_np, jd),
        jnp.asarray(table_np), num_bits=bits,
        config=JKernelConfig(block_m=bm, block_n=128, block_k=256, chunk=chunk,
                             **({} if pv_np is None else dict(lut_mode="pair_lut"))),
        layout="plane" if layout == "pair" else layout, interpret=True,
        pair_values=None if pv_np is None else jnp.asarray(pv_np))
    got = torch.from_numpy(y).to(dtype).float().numpy()
    assert rel_err(got, np.asarray(want, np.float32)) < tol


@pytest.mark.parametrize("m", [17, 40, 100])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("layout,bits", ALL_LAYOUTS)
def test_k1_k2_wrappers_launch_the_mid_entry(monkeypatch, layout, bits, dtype, m):
    """K1-K4 (K3's triples, K4's joint pair table) in bf16 and f16 from
    MID_MIN_M rows below WIDE_MIN_M launch the mid C entry with the
    plan's row tile and split and the planned workspace (K = 2048: several
    splits), counted once in LAUNCHES and MID_LAUNCHES; at the plan's
    crossover and with the crossover moved to one row."""
    n, k, chunk = 256, 2048, 256
    rng = np.random.default_rng(130 + bits + 7 * (layout == "pair") + 11 * (layout == "w3wide"))
    codes = rng.integers(0, 2**bits, (k, n), dtype=np.int32)
    if layout == "w4sym":
        planes = packing.pack_w4_sym_np(codes, chunk=chunk)
    elif layout == "w3wide":
        planes = packing.pack_w3_wide_np(codes, chunk=chunk)
    else:
        planes = packing.pack_np(codes, bits, chunk=chunk)
    planes = [torch.from_numpy(p) for p in planes]
    e = 2**bits
    table = {"w4sym": torch.zeros(16), "w3wide": torch.zeros(8),
             "pair": torch.zeros((e, e, 2))}.get(layout, torch.zeros(e))
    x = torch.zeros((m, k), dtype=dtype)
    scales = torch.zeros((k // G, n), dtype=dtype)
    calls, allocated = _fake_launch(monkeypatch)
    for mid_min_m in (kernel_config.MID_MIN_M, 1):
        monkeypatch.setattr(kernel_config, "MID_MIN_M", mid_min_m)
        calls.clear()
        allocated.clear()
        before, mid_before = dict(lut_gemm.LAUNCHES), dict(lut_gemm.MID_LAUNCHES)
        kw = dict(group_size=G, chunk=chunk)
        if layout == "w4sym":
            lut_gemm.lut_qgemm_w4sym_cuda(x, planes[0], scales, table, **kw)
        elif layout == "w3wide":
            lut_gemm.lut_qgemm_w3wide_cuda(x, planes[0], scales, table, **kw)
        elif layout == "pair":
            lut_gemm.lut_qgemm_pair_cuda(x, planes, scales, table, num_bits=bits, **kw)
        else:
            lut_gemm.lut_qgemm_plane_cuda(x, planes, scales, table, num_bits=bits, **kw)
        assert kernel_config.mma_route(m, bits, chunk, layout) == "mid"
        assert lut_gemm.LAUNCHES[layout] == before[layout] + 1
        assert lut_gemm.MID_LAUNCHES[f"{layout}_mid"] == mid_before[f"{layout}_mid"] + 1
        (args,) = calls
        plan = kernel_config.mid_plan(m, n, k, chunk)
        assert plan.splits > 1
        extra = () if layout in ("w4sym", "w3wide") else (bits,)
        want = (m, n, k, G, chunk, *extra, lut_gemm._DTYPE_TAG[dtype], plan.rows, plan.splits, 1)
        assert args[0] == f"flute_lut_qgemm_{layout}_mid"
        assert args[-len(want) - 1:-1] == want
        assert args[-len(want) - 2] is not None  # the workspace
        assert allocated == [(plan.splits, m, n)]
        # x, the planes (null where the layout has fewer than the entry
        # takes), scales, table, y and the workspace: the entry's pointers
        assert len(args) - 1 - len(want) - 1 == lut_gemm._MID[layout][2]


@pytest.mark.parametrize("layout,bits", [("w3wide", 3), ("pair", 2), ("pair", 3), ("pair", 4)])
@pytest.mark.parametrize("chunk", [256, 512])
def test_k3_k4_mid_ring(layout, bits, chunk):
    """K3's and K4's mid ring (``csrc/lut_gemm_wide_m.cuh::Geometry`` at the
    row tiles of MID_ROWS): K4's is K2's at every row tile and group size
    (its joint table has K2's size); K3's is one item a stage at 48 and 64
    rows (two at 16 and 32) with three TMA boxes of plane rows, 4 stages of
    24 192 B at 64 rows and g 64, chunk 256, sized for two blocks an SM
    with a chunk's scales (g a multiple of 2 kc) and for one with the
    per-field cache (g 8 at chunk 256, 8 and 16 at 512); at every row
    tile a stage's half-item units
    pair up and the ring fits its blocks' share of the SM."""
    for g in (8, 16, 32, 64, 128):
        if chunk % g:
            continue
        blocks = kernel_config.mid_blocks(bits, chunk, g, layout)
        for rows in kernel_config.MID_ROWS:
            ring = kernel_config.wide_ring(bits, chunk, g, layout, rows, blocks)
            if layout == "pair":
                assert blocks == kernel_config.MID_BLOCKS
                assert ring == kernel_config.wide_ring(bits, chunk, g, "plane", rows, blocks)
                continue
            q, stage, stages = ring
            per_field = g % (2 * chunk // 32) != 0
            assert blocks == (1 if per_field else 2)
            assert stages >= 2 and (chunk // 32 // 4) % q == 0
            table = 64 * 8 * 4
            assert blocks * (stages * stage + table + 64 + 1024) <= kernel_config.SM_SMEM_BYTES
            srows = -(-chunk // g) + 1
            x_bytes, words = 16 * q * rows * 16, 3 * 4 * q * 136 * 4
            assert stage == -(-(-(-(x_bytes + words) // 128) * 128 + srows * 256) // 128) * 128
    if layout == "w3wide" and chunk == 256:
        assert kernel_config.wide_ring(3, 256, 64, "w3wide", 64, 2) == (1, 24192, 4)
        assert [kernel_config.wide_ring(3, 256, 64, "w3wide", r, 2)[0]
                for r in kernel_config.MID_ROWS] == [2, 2, 1, 1]
