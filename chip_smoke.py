#!/usr/bin/env python3
"""End-to-end check of the PyTorch / CUDA port (flute_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero):
  1. print the card's name and power limit; build the seven kernel sources
     from flute_tpu_torch/csrc into build/flute_tpu_torch/, one nvcc process
     each, all at once: K1 (w4sym), K2 (plane, 2/3/4 bits), K3 (w3wide), K4
     (joint pair lookup, lut_gemm_pair.cu), K5/K6 (paged decode and verify
     attention, paged_attention.cu), L1-L6 (the Hopper lab, kernel_lab.cu)
     and L7-L12 (its second half, kernel_lab2.cu); print ptxas registers
     and spill;
  2. hold each kernel against its plain PyTorch version on the card:
     the LUT-GEMMs at the Llama-3.1-8B decoder-layer shapes, M in
     {1, 8, 128, 512}, bf16 and f16 (relative Frobenius error under 1.1e-2 /
     2e-3): K1, K2 at 4, 3 and 2 bits with a general table, K3, K4 at 4, 3
     and 2 bits with a general joint table; identity input bit-exact against
     the oracle (K1 and K2 in bf16/f16/f32 at chunk 128 and 256, K3 at 256
     and 512, K4 in bf16/f16 at 128 and 256) and unpack_via_kernel
     round-tripping the codes; lut_mode="pair_lut" without pair_values
     launching K4 once and K2 not at all; qgemm_hadamard (rotation 512) against its
     plain version; K5 at B=8, 32/8 heads, D=128, blocks of 16, ragged
     lengths 0..4096, and K6 at T in {5, 64, 256} over 0 and 1024 cached
     positions, each with softcap, window and both, bf16 and f16 (max error
     relative to the largest output < 1.1e-2). Time each kernel, its plain
     version and a yardstick that the port never calls (LUT-GEMMs: a
     torch.matmul on the pre-dequantized weight; K5/K6: one
     scaled_dot_product_attention on K/V gathered beforehand), L2-cold, in
     CUDA graphs;
  2b. the Hopper lab (L1-L6 of csrc/kernel_lab.cu): its entry point,
     flute_tpu_torch.lab.kernel_lab.main, runs every variant at the JAX lab's
     reference shape (M16 N28672 K8192, bk 1024, g64, bf16) with the launch
     counts set to 0 just before and read just after (each function exactly
     its variants' calls: a check call, bench_op's first calls and its graph's
     launches; gather8 and pairlut as many of K2 and K4, no other package
     kernel), and no lab kernel launched in phases 3 and 4; then each of its 12
     cases is held against its plain version on the card at that shape and
     at bk 256 on a narrow N (relative Frobenius error under 1.1e-2; floor on
     planes masked to finite bf16 halves; unpack_only, whose operand is
     subnormal, to 1.1e-2 of the largest output) and with an identity x bit
     for bit; the plain versions and a yardstick (one bf16 torch.matmul of x
     on the pre-dequantized [8192, 28672] weight) are timed beside the
     kernels, L2-cold, in CUDA graphs;
  2c. the lab's second half (L7-L12 of csrc/kernel_lab2.cu): its entry
     point, flute_tpu_torch.lab.kernel_lab2.main, runs every variant at the
     JAX lab2's default shape (M16 N28672 K8192, bn 2048, bk 2048, g64,
     bf16) with the launch counts set to 0 just before and read just after
     (each function exactly its variants' calls, sep for sep and sep1, L7
     2 x 4002; prod as many of K2, no other package kernel, no L1-L6), and
     no L7-L12 kernel launched in phases 3 and 4; then the six GEMM
     functions (seven cases with sep1) are held against their plain
     versions on the card at that shape and at bk 256 on a narrow N
     (relative Frobenius error under 1.1e-2) and with an identity x bit for
     bit (the sign of a zero aside), L7 bit for bit at nops 2 and 8; the
     plain versions and a yardstick (one bf16 torch.matmul on the
     pre-dequantized weight: phase 2b's for the 4-bit cases, its own for
     L12's 3-bit weight) are timed beside the kernels, L2-cold, in CUDA
     graphs;
  3. logits of a 2-layer model at Llama-3.1-8B widths (fused) quantized at
     w4sym, W3 (w3wide) and general-table W4 (plane), and with every
     projection a HIGGS W4 layer (rotation 512, then K4): one prefill and one
     decode step on the card against the same params on the CPU plain path
     (max error relative to the largest logit < 1.1e-2); the W3 and the
     HIGGS models saved with save_quantized and loaded back give the same
     logits bit for bit;
  4. serve 8 ragged prompts for 16 new tokens through Engine.generate on
     the full 32-layer Llama-3.1-8B-width model (random weights from a seed,
     quantized on the card) at w4sym, W3 and general W4, each run through
     exactly its kernel: steps x 32 layers x 4 launches, none of the others;
     then through PagedEngine: the w4sym model with dense prefill, held to
     Engine's tokens and first-token logits, and the HIGGS-W4 model with
     pool prefill, 12 requests (4 sharing a 32-token prefix, 2 sampled) on a
     pool small enough that admission waits, with exact launch counts: K4
     forward calls x 32 x 4, K5 decode steps x 32, K6 prefill chunks x 32,
     K1-K3 none.

Prints a {"kernels": [...]} line, then as its last line
{"ok": true, "device": {...}}. Writes the full results to
chiprun_out/chip_smoke.json. Needs a CUDA device; exits non-zero without one.
"""

import contextlib
import dataclasses
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
BF16_OPS_PER_S = 989e12  # H100 SXM dense bf16/f16 tensor rate
# the data sheet's f32 rate outside the tensor cores, taken for L7's int32
# shifts and xors: no int32 rate is published, and a higher rate only
# lowers the bound
ALU_OPS_PER_S = 67e12
THRESHOLDS = {torch.bfloat16: 1.1e-2, torch.float16: 2.0e-3, torch.float32: 1e-5}
# (name, N = out features, K = in features): one Llama-3.1-8B decoder layer,
# fused qkv and gate_up
LAYER_SHAPES = [
    ("qkv", 6144, 4096),
    ("o", 4096, 4096),
    ("gate_up", 28672, 4096),
    ("down", 4096, 14336),
]
GROUP = 64
# decode rows (1 sequence, the served batch of 8), a mid size, and the served
# prefill block (8 prompts x 64-token bucket)
M_CASES = (1, 8, 128, 512)
REPLACES = "flute_tpu/ops/lut_gemm.py:454 (_lut_qgemm_kernel[{}], pallas_call :828)"
# kernel id -> (wrapper name, source, launch counter key, what it replaces)
KERNELS = {
    "K1": ("lut_qgemm_w4sym", "lut_gemm_w4sym.cu", "w4sym", REPLACES.format("w4sym")),
    "K2": ("lut_qgemm_plane", "lut_gemm_plane.cu", "plane",
           REPLACES.format("plane, gather8/select")),
    "K3": ("lut_qgemm_w3wide", "lut_gemm_w3wide.cu", "w3wide", REPLACES.format("w3wide")),
    "K4": ("lut_qgemm_pair", "lut_gemm_pair.cu", "pair",
           "flute_tpu/ops/lut_gemm.py:454 (_lut_qgemm_kernel[plane, pair_lut: "
           "_lookup_payload_lane :279, :533-538, _table_tile_pair :680], pallas_call :828)"),
    "K5": ("paged_decode_attention", "paged_attention.cu", "paged_decode",
           "flute_tpu/ops/paged_attention.py:354 (paged_decode_attention -> _kernel :74, "
           "pallas_call :402)"),
    "K6": ("paged_verify_attention", "paged_attention.cu", "paged_verify",
           "flute_tpu/ops/paged_attention.py:262 (paged_verify_attention -> _verify_kernel "
           ":171, pallas_call :311)"),
}
LAB_REPLACES = "scripts/kernel_lab.py:{} (pallas_call of {})"
# the Hopper lab: kernel id -> (lab function, the variant its line reports,
# what it replaces); L4-L6 take flags, their other variants are in the JSON
LAB = {
    "L1": ("floor", "floor", LAB_REPLACES.format(79, "run_floor :75")),
    "L2": ("unpack_only", "unpack", LAB_REPLACES.format(124, "run_unpack :120")),
    "L3": ("gather16", "gather16", LAB_REPLACES.format(212, "run_gather16 :202")),
    "L4": ("g8_ablate", "g8_full", LAB_REPLACES.format(413, "run_g8_ablate :406")),
    "L5": ("g8_rs", "g8_groupacc", LAB_REPLACES.format(501, "run_g8_rs :494")),
    "L6": ("g8_hoist", "g8_hoist_ga", LAB_REPLACES.format(590, "run_g8_hoist :583")),
}
for _kid, (_fn, _, _replaces) in LAB.items():
    KERNELS[_kid] = (f"lab.{_fn}", "kernel_lab.cu", _fn, _replaces)
LAB2_REPLACES = "scripts/kernel_lab2.py:{} (pallas_call of {})"
# the lab's second half: kernel id -> (lab function, the variant its line
# reports, what it replaces); sep1 is in L9's variants
LAB2 = {
    "L7": ("vmembw", "vmembw", LAB2_REPLACES.format(72, "run_vmembw :69")),
    "L8": ("pfdirect", "pfdirect", LAB2_REPLACES.format(135, "run_pfdirect :130")),
    "L9": ("sep", "sep", LAB2_REPLACES.format(234, "run_sep :228")),
    "L10": ("int4", "int4", LAB2_REPLACES.format(290, "run_int4 :286")),
    "L11": ("slabstream", "slabstream", LAB2_REPLACES.format(483, "run_slabstream :478")),
    "L12": ("w3wide", "w3wide", LAB2_REPLACES.format(585, "run_w3wide :575")),
}
for _kid, (_fn, _, _replaces) in LAB2.items():
    KERNELS[_kid] = (f"lab2.{_fn}", "kernel_lab2.cu", _fn, _replaces)
LUT_KERNELS = ("K1", "K2", "K3", "K4")
# phase-2 cases: (kernel id, bits, M values that are timed, dtypes timed;
# every M and both dtypes are checked). K2 and K4 read the plane layout;
# K4 looks its weights up in a joint pair table.
KERNEL_CASES = [
    ("K1", 4, M_CASES, ("bfloat16", "float16")),
    ("K2", 4, M_CASES, ("bfloat16", "float16")),
    ("K2", 3, (1, 8, 512), ("bfloat16", "float16")),
    ("K2", 2, (1, 8, 512), ("bfloat16", "float16")),
    ("K3", 3, M_CASES, ("bfloat16", "float16")),
    ("K4", 4, (1, 8, 512), ("bfloat16",)),
    ("K4", 3, (1, 8, 512), ("bfloat16",)),
    ("K4", 2, (1, 8, 512), ("bfloat16",)),
]
LAYOUT = {"K1": "w4sym", "K2": "plane", "K3": "w3wide", "K4": "plane"}
HIGGS_HADAMARD = 512  # the rotation of the HIGGS layers (phases 2-4)
# served models: name -> (quantize_model arguments, kernel id)
SERVED = {
    "w4sym": (dict(num_bits=4), "K1"),
    "w3wide": (dict(num_bits=3), "K3"),
    "w4_general": (dict(num_bits=4, symmetric=False), "K2"),
}


def log(*a):
    print(*a, flush=True)


def rel_err(y, ref) -> float:
    y, ref = y.double(), ref.double()
    return float(torch.linalg.norm(y - ref) / torch.linalg.norm(ref))


def make_table(rng, layout, bits, mixed_signs=False) -> np.ndarray:
    """A sign-symmetric table for w4sym; any 2^b values for the others."""
    if layout != "w4sym":
        return rng.standard_normal(2**bits).astype(np.float32)
    mags = rng.standard_normal(8).astype(np.float32)
    if not mixed_signs:
        mags = np.sort(np.abs(mags))
    return np.concatenate([mags, -mags])


def make_weight(rng, gen, layout, bits, n, k, dtype, dev, chunk=256, mixed_signs=False):
    """Random codes, their planes packed on the card, scales and a table."""
    from flute_tpu_torch import packing

    codes = torch.randint(0, 2**bits, (k, n), generator=gen, device=dev, dtype=torch.int32)
    if layout == "w4sym":
        planes = [packing.pack_w4_sym(codes, chunk=chunk)]
    elif layout == "w3wide":
        planes = [packing.pack_w3_wide(codes, chunk=chunk)]
    else:
        planes = packing.pack_plane(codes, bits, chunk=chunk)
    scales = (torch.rand((k // GROUP, n), generator=gen, device=dev) + 0.5).to(dtype)
    table = torch.from_numpy(make_table(rng, layout, bits, mixed_signs)).to(dev)
    return codes, planes, scales, table


def phase_kernel(dev, results):
    from flute_tpu_torch import packing
    from flute_tpu_torch.ops import lut_gemm
    from flute_tpu_torch.ops.kernel_config import KernelConfig
    from flute_tpu_torch.utils.benchmark import bench_op, cold_copies

    rng = np.random.default_rng(0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    cases = []
    for kid, bits, timed, timed_dtypes in KERNEL_CASES:
        layout = LAYOUT[kid]
        log(f"  {kid} ({layout}{', joint pair table' if kid == 'K4' else ''}, {bits}-bit)")
        for name, n, k in LAYER_SHAPES:
            for dtype in (torch.bfloat16, torch.float16):
                codes, planes, scales, table = make_weight(rng, gen, layout, bits, n, k,
                                                           dtype, dev)
                pv = make_pair_table(rng, bits, dev) if kid == "K4" else None
                deq = (lut_gemm.dequantize_codes(codes, scales, table, dtype) if pv is None
                       else lut_gemm.dequantize_codes_pair(codes, scales, pv, dtype))
                del codes
                wbytes = sum(p.numel() * 4 for p in planes) + scales.numel() * scales.element_size()
                copies = cold_copies(wbytes)
                args = [([p.clone() for p in planes], scales.clone()) for _ in range(copies)]
                deq_c = [deq.clone() for _ in range(cold_copies(deq.numel() * deq.element_size()))]
                kw = dict(num_bits=bits, layout=layout, config=KernelConfig(chunk=256),
                          pair_values=pv)
                for m in M_CASES:
                    x = torch.randn((m, k), generator=gen, device=dev).to(dtype)
                    y = lut_gemm.lut_qgemm(x, planes, scales, table, **kw)
                    y_plain = lut_gemm.lut_qgemm_plain(x, planes, scales, table, num_bits=bits,
                                                       chunk=256, layout=layout, pair_values=pv)
                    torch.cuda.synchronize()
                    err = rel_err(y, y_plain)
                    max_abs = float((y.float() - y_plain.float()).abs().max())
                    if not err < THRESHOLDS[dtype]:
                        raise AssertionError(f"{kid} {bits}-bit {name} M={m} {dtype}: rel err {err}")
                    case = dict(kernel=kid, bits=bits, name=name, n=n, k=k, m=m,
                                dtype=str(dtype).split(".")[-1], rel_err=err,
                                max_abs_err=max_abs)
                    cases.append(case)
                    if m not in timed or case["dtype"] not in timed_dtypes:
                        continue

                    def kern(p, s, x=x, table=table):
                        return lut_gemm.lut_qgemm(x, p, s, table, **kw)

                    def plain(p, s, x=x, table=table, pv=pv):
                        return lut_gemm.lut_qgemm_plain(x, p, s, table, num_bits=bits,
                                                        chunk=256, layout=layout, pair_values=pv)

                    def library(w, x=x):
                        return torch.matmul(x, w)

                    t_k = bench_op(kern, args)
                    t_p = bench_op(plain, args[:2], min_launches=2)
                    t_l = bench_op(library, [(w,) for w in deq_c])
                    esz = torch.tensor([], dtype=dtype).element_size()
                    lut = table if pv is None else pv
                    nbytes = wbytes + lut.numel() * 4 + m * k * esz + m * n * esz
                    t_bytes = nbytes / HBM_BYTES_PER_S
                    t_ops = 2 * m * n * k / BF16_OPS_PER_S
                    case.update(
                        bytes=nbytes, us=t_k * 1e6, plain_us=t_p * 1e6, library_us=t_l * 1e6,
                        bound_us=max(t_bytes, t_ops) * 1e6,
                        bound_by="bytes" if t_bytes >= t_ops else "operations",
                    )
                    case["share_of_bound"] = case["bound_us"] / case["us"]
                    log(
                        f"    {name:8s} M={m:<4d} {case['dtype']:9s} err={err:.2e} "
                        f"kernel {case['us']:9.1f} us  bound {case['bound_us']:7.1f} us "
                        f"({case['bound_by']}, {100 * case['share_of_bound']:5.1f}%)  "
                        f"plain {case['plain_us']:9.1f} us  matmul {case['library_us']:7.1f} us"
                    )
                del args, deq_c, deq, planes
    results["kernel_cases"] = cases
    check_identity(dev, rng, gen, results)
    check_pair_lut_routing(dev, rng, gen, results)
    check_qgemm_hadamard(dev, rng, gen, results)
    return cases


def check_pair_lut_routing(dev, rng, gen, results):
    """lut_mode="pair_lut" with a scalar table and no pair_values: one K4
    launch, no K2 launch, and the scalar lookup's product."""
    from flute_tpu_torch.ops import lut_gemm
    from flute_tpu_torch.ops.kernel_config import KernelConfig

    _, n, k = LAYER_SHAPES[0]
    _, planes, scales, table = make_weight(rng, gen, "plane", 4, n, k, torch.bfloat16, dev)
    x = torch.randn((8, k), generator=gen, device=dev).bfloat16()
    before = dict(lut_gemm.LAUNCHES)
    got = lut_gemm.lut_qgemm(x, planes, scales, table, num_bits=4,
                             config=KernelConfig(lut_mode="pair_lut"))
    added = {kk: v - before[kk] for kk, v in lut_gemm.LAUNCHES.items() if v != before[kk]}
    want = lut_gemm.lut_qgemm_plain(x, planes, scales, table, num_bits=4, chunk=256,
                                    layout="plane")
    err = rel_err(got, want)
    if added != {"pair": 1} or not err < THRESHOLDS[torch.bfloat16]:
        raise AssertionError(f"pair_lut without pair_values: launches {added}, rel err {err}")
    log(f"  lut_mode='pair_lut' without pair_values: launches {added} (K4), "
        f"rel err {err:.2e} against the scalar plain version")
    results["pair_lut_routing"] = dict(launches=added, rel_err=err)


def make_pair_table(rng, bits, dev) -> torch.Tensor:
    """A general joint pair table [2^b, 2^b, 2] (a HIGGS grid's values)."""
    e = 2**bits
    return torch.from_numpy(rng.standard_normal((e, e, 2)).astype(np.float32)).to(dev)


def check_identity(dev, rng, gen, results):
    from flute_tpu_torch import packing
    from flute_tpu_torch.ops import lut_gemm
    from flute_tpu_torch.ops.kernel_config import KernelConfig

    # identity input: bit-exact against the oracle at two pack chunks per
    # layout; unpack_via_kernel returns the codes
    n, k = 256, 512
    identity = [("K1", 4, (128, 256)), ("K2", 4, (128, 256)), ("K2", 3, (128, 256)),
                ("K2", 2, (128, 256)), ("K3", 3, (256, 512))]
    for kid, bits, chunks in identity:
        layout = LAYOUT[kid]
        for chunk in chunks:
            cfg = KernelConfig(chunk=chunk)
            for dtype in (torch.bfloat16, torch.float16, torch.float32):
                for mixed in ((False, True) if layout == "w4sym" else (False,)):
                    codes, planes, scales, table = make_weight(
                        rng, gen, layout, bits, n, k, dtype, dev, chunk=chunk, mixed_signs=mixed)
                    eye = torch.eye(k, dtype=dtype, device=dev)
                    got = lut_gemm.lut_qgemm(eye, planes, scales, table, num_bits=bits,
                                             layout=layout, config=cfg)
                    want = lut_gemm.dequantize_codes(codes, scales, table, dtype)
                    if not torch.equal(got.float(), want.float()):
                        raise AssertionError(
                            f"identity not bit-exact: {kid} {bits}-bit {dtype} chunk={chunk}")
            back = packing.unpack_via_kernel(planes, bits, n, k, chunk=chunk, layout=layout)
            if not torch.equal(back, codes):
                raise AssertionError(
                    f"unpack_via_kernel does not round-trip: {kid} {bits}-bit chunk={chunk}")
    for bits in (4, 3, 2):  # K4: 16-bit compute only
        for chunk in (128, 256):
            for dtype in (torch.bfloat16, torch.float16):
                codes, planes, scales, _ = make_weight(rng, gen, "plane", bits, n, k, dtype, dev,
                                                       chunk=chunk)
                pv = make_pair_table(rng, bits, dev)
                eye = torch.eye(k, dtype=dtype, device=dev)
                got = lut_gemm.lut_qgemm(eye, planes, scales, None, num_bits=bits,
                                         config=KernelConfig(chunk=chunk), pair_values=pv)
                want = lut_gemm.dequantize_codes_pair(codes, scales, pv, dtype)
                if not torch.equal(got.float(), want.float()):
                    raise AssertionError(
                        f"identity not bit-exact: K4 {bits}-bit {dtype} chunk={chunk}")
    log("  identity bit-exact (bf16/f16/f32; K1 and K2 at chunk 128/256, K1 with a "
        "mixed-sign table, K3 at 256/512; K4 in bf16/f16 at 2/3/4 bits, chunk 128/256); "
        "unpack_via_kernel round-trips")
    results["identity_bit_exact"] = True


def check_qgemm_hadamard(dev, rng, gen, results):
    """The rotation and K4 through qgemm_hadamard against the plain version
    of both, at the qkv projection's shape."""
    from flute_tpu_torch.ops import hadamard, lut_gemm

    _, n, k = LAYER_SHAPES[0]
    codes, planes, scales, table = make_weight(rng, gen, "plane", 4, n, k, torch.bfloat16, dev)
    pv = make_pair_table(rng, 4, dev)
    x = torch.randn((8, k), generator=gen, device=dev).bfloat16()
    got = hadamard.qgemm_hadamard(x, planes, scales, table, 4, GROUP, HIGGS_HADAMARD,
                                  pair_values=pv)
    xr = hadamard.grouped_hadamard_transform(x, HIGGS_HADAMARD)
    want = lut_gemm.lut_qgemm_plain(xr, planes, scales, table, num_bits=4, chunk=256,
                                    layout="plane", pair_values=pv)
    rot_err = rel_err(xr.cpu(), hadamard.grouped_hadamard_transform(x.cpu(), HIGGS_HADAMARD))
    err = rel_err(got, want)
    if not (err < THRESHOLDS[torch.bfloat16] and rot_err < THRESHOLDS[torch.bfloat16]):
        raise AssertionError(f"qgemm_hadamard: rel err {err}, rotation vs CPU {rot_err}")
    log(f"  qgemm_hadamard (rotation {HIGGS_HADAMARD}, K4) vs plain: rel err {err:.2e}; "
        f"rotation on the card vs the CPU: {rot_err:.2e}")
    results["qgemm_hadamard_rel_err"] = err


# K5/K6: one decode batch at Llama-3.1-8B's attention widths
ATTN = dict(h=32, hkv=8, d=128, bs=16)
ATTN_OPTIONS = [(None, None), (50.0, None), (None, 1000), (30.0, 333)]


def paged_inputs(rng, gen, dev, dtype, lengths, t=0):
    """q, pools and tables for sequences of ``lengths`` cached positions (and
    ``t`` more queries each): every live block its own pool row, a random
    permutation of them; dead table entries point at row 0. Returns also
    the number of live blocks."""
    h, hkv, d, bs = ATTN["h"], ATTN["hkv"], ATTN["d"], ATTN["bs"]
    need = [-(-(n + t) // bs) for n in lengths]
    mb = max(max(need), 1)
    nb = sum(need) + 1
    rows = rng.permutation(np.arange(1, nb))
    tables = np.zeros((len(lengths), mb), np.int32)
    start = 0
    for i, k in enumerate(need):
        tables[i, :k] = rows[start:start + k]
        start += k
    shape = (len(lengths), h, d) if t == 0 else (len(lengths), t, h, d)
    q = torch.randn(shape, generator=gen, device=dev).to(dtype)
    kp, vp = (torch.randn((nb, hkv, bs, d), generator=gen, device=dev).to(dtype)
              for _ in range(2))
    lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
    return q, kp, vp, torch.from_numpy(tables).to(dev), lens, sum(need)


def phase_attention(dev, results):
    """K5 and K6 against their plain versions with every option; timed at
    the decode batch (every length 1024, every length 4096) and at a pool
    prefill chunk (T = 256 over 1024 cached positions)."""
    import torch.nn.functional as F

    from flute_tpu_torch.ops import paged_attention as pa
    from flute_tpu_torch.utils.benchmark import bench_op, cold_copies

    rng = np.random.default_rng(4)
    gen = torch.Generator(device=dev)
    gen.manual_seed(4)
    h, hkv, d, bs = ATTN["h"], ATTN["hkv"], ATTN["d"], ATTN["bs"]
    cases = []

    def check(kid, fn, ref, q, kp, vp, tables, lens, label):
        for softcap, window in ATTN_OPTIONS:
            kw = dict(softcap=softcap, window=window)
            got = fn(q, kp, vp, tables, lens, **kw)
            want = ref(q, kp, vp, tables, lens, **kw)
            torch.cuda.synchronize()
            if not torch.isfinite(got.float()).all():
                raise AssertionError(f"{kid} {label} {kw}: non-finite output")
            err = float((got.float() - want.float()).abs().max() / want.float().abs().max())
            max_abs = float((got.float() - want.float()).abs().max())
            if not err < THRESHOLDS[torch.bfloat16]:
                raise AssertionError(f"{kid} {label} {kw}: max rel err {err}")
            cases.append(dict(kernel=kid, case=label, dtype=str(q.dtype).split(".")[-1],
                              softcap=softcap, window=window, rel_err=err,
                              max_abs_err=max_abs))
        return got

    for dtype in (torch.bfloat16, torch.float16):
        lengths = [0, 1, 37, 100, 515, 1000, 2049, 4096]
        q, kp, vp, tables, lens, _ = paged_inputs(rng, gen, dev, dtype, lengths)
        got = check("K5", pa.paged_decode_attention, pa.paged_gqa_reference, q, kp, vp,
                    tables, lens, f"decode B=8 lengths {lengths}")
        if got[0].float().any():
            raise AssertionError("K5: a slot of length 0 must give zeros")
        for t in (5, 64, 256):
            q, kp, vp, tables, lens, _ = paged_inputs(rng, gen, dev, dtype, [0, 1024], t=t)
            check("K6", pa.paged_verify_attention, pa.paged_verify_reference, q, kp, vp,
                  tables, lens, f"verify T={t} over [0, 1024]")
        del q, kp, vp
    log(f"  K5 (ragged lengths 0..4096) and K6 (T 5/64/256 over 0 and 1024) agree with "
        f"their plain versions with softcap, window and both, bf16/f16: max rel err "
        f"{max(c['rel_err'] for c in cases):.2e}")

    timed = []
    dtype = torch.bfloat16
    esz = 2
    for kid, lengths, t in (("K5", [1024] * 8, 0), ("K5", [4096] * 8, 0), ("K6", [1024], 256)):
        q, kp, vp, tables, lens, live = paged_inputs(rng, gen, dev, dtype, lengths, t=t)
        kv_bytes = 2 * kp.numel() * esz
        pools = [(kp.clone(), vp.clone()) for _ in range(cold_copies(kv_bytes))]
        b = len(lengths)
        s_len = lengths[0] + t
        # the yardstick: K/V gathered into [B, Hkv, S, D] beforehand
        kg = kp[tables.long()].permute(0, 2, 1, 3, 4).reshape(b, hkv, -1, d)[:, :, :s_len]
        vg = vp[tables.long()].permute(0, 2, 1, 3, 4).reshape(b, hkv, -1, d)[:, :, :s_len]
        dense = [(kg.contiguous(), vg.contiguous())
                 for _ in range(cold_copies(2 * kg.numel() * esz))]
        if kid == "K5":
            def kern(k, v):
                return pa.paged_decode_attention(q, k, v, tables, lens)

            def plain(k, v):
                return pa.paged_gqa_reference(q, k, v, tables, lens)

            q4, mask = q[:, :, None], None
            att = [n for n in lengths]
        else:
            def kern(k, v):
                return pa.paged_verify_attention(q, k, v, tables, lens)

            def plain(k, v):
                return pa.paged_verify_reference(q, k, v, tables, lens)

            q4 = q.permute(0, 2, 1, 3)
            mask = (torch.arange(s_len, device=dev)[None, :]
                    <= lengths[0] + torch.arange(t, device=dev)[:, None])
            att = [lengths[0] + j + 1 for j in range(t)]

        def library(k, v):
            return F.scaled_dot_product_attention(q4, k, v, attn_mask=mask, enable_gqa=True)

        t_k = bench_op(kern, pools)
        t_p = bench_op(plain, pools[:2], min_launches=2)
        t_l = bench_op(library, dense)
        nbytes = live * hkv * bs * d * esz * 2 + 2 * q.numel() * esz
        flops = 4 * h * d * sum(att)
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / BF16_OPS_PER_S
        case = dict(kernel=kid, case=f"B={b} T={max(t, 1)} cached {lengths[0]}", dtype="bfloat16",
                    bytes=nbytes, flops=flops, us=t_k * 1e6, plain_us=t_p * 1e6,
                    library_us=t_l * 1e6, bound_us=max(t_bytes, t_ops) * 1e6,
                    bound_by="bytes" if t_bytes >= t_ops else "operations")
        case["share_of_bound"] = case["bound_us"] / case["us"]
        timed.append(case)
        log(f"    {kid} {case['case']:28s} kernel {case['us']:9.1f} us  bound "
            f"{case['bound_us']:7.1f} us ({case['bound_by']}, "
            f"{100 * case['share_of_bound']:5.1f}%)  plain {case['plain_us']:9.1f} us  "
            f"sdpa {case['library_us']:7.1f} us")
        del pools, dense, kg, vg, q, kp, vp
    torch.cuda.empty_cache()
    results["attention_cases"] = cases
    results["attention_timed"] = timed
    return cases, timed


# the JAX lab's reference shape (scripts/kernel_lab.py:233-243)
LAB_SHAPE = dict(m=16, n=28672, k=8192, bk=1024, g=64)
LAB_NARROW_N = 2048  # the bk 256 checks
LAB_ITERS = 24  # the lab's --iters: launches per timed CUDA graph (at least)


def lab_check(fn, flags, x, planes, scales, table, bn, bk, name, label):
    """One lab case against its plain version on the card: relative
    Frobenius error (unpack_only: largest error over the largest output)."""
    from flute_tpu_torch.lab import ops as lab

    g = LAB_SHAPE["g"]
    m = x.shape[0]
    got = lab.run(fn, x, planes, scales, table, m, bn, bk, g, **flags)
    want = lab.plain(fn, x, planes, scales, table, m, bn, bk, g, **flags)
    torch.cuda.synchronize()
    if not torch.isfinite(got.float()).all():
        raise AssertionError(f"lab {name} {label}: non-finite output")
    max_abs = float((got.float() - want.float()).abs().max())
    if fn == "unpack_only":
        err = max_abs / float(want.float().abs().max())
    else:
        err = rel_err(got, want)
    if not err < THRESHOLDS[torch.bfloat16]:
        raise AssertionError(f"lab {name} {label}: error {err}")
    return dict(variant=name, function=fn, case=label, rel_err=err, max_abs_err=max_abs)


def phase_lab(dev, results):
    """The Hopper lab: its entry point over every variant (counted), then
    each case against its plain version, an identity x bit for bit, and the
    plain versions and a bf16 matmul timed beside the kernels."""
    from flute_tpu_torch.lab import kernel_lab
    from flute_tpu_torch.lab import ops as lab
    from flute_tpu_torch.ops import lut_gemm
    from flute_tpu_torch.utils.benchmark import bench_op, cold_copies

    sh = LAB_SHAPE
    m, n, k, bk, g = sh["m"], sh["n"], sh["k"], sh["bk"], sh["g"]
    for d in (lab.LAUNCHES, lut_gemm.LAUNCHES):
        for kk in d:
            d[kk] = 0
    t0 = time.perf_counter()
    rows = kernel_lab.main(["--m", str(m), "--n", str(n), "--k", str(k), "--bk", str(bk),
                            "--iters", str(LAB_ITERS), "--variants", ",".join(kernel_lab.ORDER)])
    launches = dict(lab.LAUNCHES)
    gemm = dict(lut_gemm.LAUNCHES)
    main_s = time.perf_counter() - t0
    # calls per variant: one check call, then bench_op's first call on each
    # input copy and its whole passes over the copies in the graph
    copies = cold_copies(n * k // 2 + (k // g) * n * 2)
    per_variant = 1 + copies + -(-LAB_ITERS // copies) * copies
    fns = [kernel_lab.VARIANTS[v][0] for v in kernel_lab.ORDER if v in kernel_lab.VARIANTS]
    want = {fn: fns.count(fn) * per_variant for fn in lab.LAUNCHES}
    want_gemm = {kk: per_variant if kk in ("plane", "pair") else 0 for kk in lut_gemm.LAUNCHES}
    if launches != want or gemm != want_gemm:
        raise AssertionError(f"the lab's run launched {launches} and {gemm}, "
                             f"expected {want} and {want_gemm}")
    log(f"  the lab's entry point ran {len(rows)} variants in {main_s:.1f} s; launches {launches}, "
        f"package kernels {gemm}")
    by_name = {r["name"]: r for r in rows}

    codes, planes, scales, table, x = kernel_lab.make_inputs(m, n, k, 4, g, device=dev)
    finite = [lab.finite_halves(planes[0])]
    checks = []
    for name, (fn, flags) in kernel_lab.VARIANTS.items():
        p = finite if fn == "floor" else planes
        checks.append(lab_check(fn, flags, x, p, scales, table, n, bk, name,
                                f"M{m} N{n} K{k} bk {bk}"))
        narrow = [q[:, :LAB_NARROW_N].contiguous() for q in p]
        checks.append(lab_check(fn, flags, x, narrow, scales[:, :LAB_NARROW_N].contiguous(),
                                table, LAB_NARROW_N, 256, name,
                                f"M{m} N{LAB_NARROW_N} K{k} bk 256"))
        # identity x: every output one product, bit for bit
        eye = torch.eye(512, dtype=torch.bfloat16, device=dev)
        small = [q[:64, :256].contiguous() for q in p]
        s_small = scales[:512 // g, :256].contiguous()
        got = lab.run(fn, eye, small, s_small, table, 16, 256, 256, g, **flags)
        want = lab.plain(fn, eye, small, s_small, table, 16, 256, 256, g, **flags)
        if not torch.equal(got.view(torch.int16), want.view(torch.int16)):
            raise AssertionError(f"lab {name}: identity x not bit-exact")
        if fn == "unpack_only" and not torch.equal(
                got.view(torch.int16), lab.unpack_weight(small[0]).view(torch.int16)):
            raise AssertionError("lab unpack: identity x does not give its operand")
    log(f"  L1-L6: 12 cases agree with their plain versions at M{m} N{n} K{k} bk {bk} and at "
        f"N{LAB_NARROW_N} bk 256 (largest error {max(c['rel_err'] for c in checks):.2e}), "
        "identity x bit-exact (unpack_only: its subnormal operand)")

    # plain versions and the yardstick, timed beside the kernels
    args = [([q.clone() for q in planes], scales.clone()) for _ in range(2)]
    w_ref = lut_gemm.dequantize_codes(torch.from_numpy(codes).to(dev), scales, table,
                                      torch.bfloat16)
    del codes
    dense = [(w_ref.clone(),) for _ in range(cold_copies(w_ref.numel() * 2))]
    t_lib = bench_op(lambda w: torch.matmul(x, w), dense)
    del dense, w_ref
    cases = []
    xy_bytes = x.numel() * 2 + m * n * 2
    t_ops = 2 * m * n * k / BF16_OPS_PER_S
    for name, (fn, flags) in kernel_lab.VARIANTS.items():
        def plain(q, s, fn=fn, flags=flags):
            return lab.plain(fn, x, q, s, table, m, n, bk, g, **flags)

        t_p = bench_op(plain, args, min_launches=2)
        # what the function reads: floor and unpack_only read no scales or table
        nbytes = sum(q.numel() * 4 for q in planes) + xy_bytes
        if fn not in ("floor", "unpack_only"):
            nbytes += scales.numel() * 2 + table.numel() * 4
        t_bytes = nbytes / HBM_BYTES_PER_S
        row = by_name[name]
        case = dict(variant=name, function=fn, us=row["us"], gbps=row["gbps"],
                    lab_share_of_hbm=row["share_of_hbm"], plain_us=t_p * 1e6,
                    library_us=t_lib * 1e6, bytes=nbytes, bound_us=max(t_bytes, t_ops) * 1e6,
                    bound_by="bytes" if t_bytes >= t_ops else "operations")
        case["share_of_bound"] = case["bound_us"] / case["us"]
        cases.append(case)
        log(f"    {name:12s} kernel {case['us']:8.1f} us {case['gbps']:7.1f} GB/s  bound "
            f"{case['bound_us']:6.1f} us ({case['bound_by']}, {100 * case['share_of_bound']:5.1f}%)"
            f"  plain {case['plain_us']:8.1f} us  matmul {case['library_us']:6.1f} us")
    # floor as the lab times it reads real planes (65% of its outputs are
    # not finite); the same kernel on planes masked to finite halves
    fin = [([lab.finite_halves(q[0])], s) for q, s in args]
    t_fin = bench_op(lambda q, s: lab.floor(x, q, s, m, n, bk, g), fin, min_launches=24)
    next(c for c in cases if c["variant"] == "floor")["finite_planes_us"] = t_fin * 1e6
    log(f"    floor on finite planes: kernel {t_fin * 1e6:8.1f} us")
    del fin
    for name in kernel_lab.PACKAGE_VARIANTS:
        row = by_name[name]
        log(f"    {name:12s} kernel {row['us']:8.1f} us {row['gbps']:7.1f} GB/s "
            f"({100 * row['share_of_hbm']:5.1f}% of 3.35 TB/s, the lab's byte count)"
            + (f", rel {row['rel']:.2e}" if "rel" in row else ""))
    del args, planes, finite, x
    torch.cuda.empty_cache()
    results["lab"] = dict(shape=sh, main_s=main_s, rows=rows, launches=launches,
                          package_launches=gemm, checks=checks, cases=cases)
    return cases, checks, launches


def lab_line(kid, lab, cases, checks, launches, served):
    """The {"kernels": [...]} entry of lab kernel ``kid`` (of ``LAB`` or
    ``LAB2``, given as ``lab``): its reporting variant's numbers, the other
    variants' times beside them. ``launches`` counts the lab's run,
    ``served`` the launches in phases 3 and 4 (none: no served path runs a
    lab kernel)."""
    wrapper, source, fn, replaces = KERNELS[kid]
    row = [c for c in cases if c["variant"] == lab[kid][1]][0]
    return dict(
        name=wrapper,
        route="cuda",
        source=f"flute_tpu_torch/csrc/{source}",
        replaces=replaces,
        launches=launches[fn],
        max_abs_err=max(c["max_abs_err"] for c in checks if c["function"] == fn),
        ms=row["us"] / 1e3,
        plain_ms=row["plain_us"] / 1e3,
        bound_ms=row["bound_us"] / 1e3,
        bound_by=row["bound_by"],
        library_ms=None if row["library_us"] is None else row["library_us"] / 1e3,
        checked=True,
        served_launches=served[fn],
        variants={c["variant"]: c["us"] / 1e3 for c in cases if c["function"] == fn},
        **({"finite_planes_ms": row["finite_planes_us"] / 1e3} if "finite_planes_us" in row
           else {}),
    )


# the JAX lab2's default shape and tiles (scripts/kernel_lab2.py:313-321)
LAB2_SHAPE = dict(m=16, n=28672, k=8192, bn=2048, bk=2048, g=64)


def _cut(weights, k, k_rows, cols):
    """The weight operands (planes and scales, whose rows are proportional
    to K) cut to their first ``k_rows`` K rows and ``cols`` columns."""
    def cut(t):
        return t[: t.shape[0] * k_rows // k, :cols].contiguous()

    return tuple([cut(p) for p in w] if isinstance(w, list) else cut(w) for w in weights)


def _same_bits(got, want) -> bool:
    """Bit for bit, the sign of a zero aside."""
    same = (got.view(torch.int16) == want.view(torch.int16)) | ((got == 0) & (want == 0))
    return bool(same.all())


def lab2_check(name, inp, weights, bn, bk, label):
    """One lab2 GEMM case against its plain version on the card (relative
    Frobenius error)."""
    from flute_tpu_torch.lab import kernel_lab2, ops2

    fn, args = kernel_lab2.lab_call(name, inp, weights, inp.x.shape[0], bn, bk)
    got = ops2.FUNCTIONS[fn](*args)
    want = ops2.plain(fn, *args)
    torch.cuda.synchronize()
    if not torch.isfinite(got.float()).all():
        raise AssertionError(f"lab2 {name} {label}: non-finite output")
    err = rel_err(got, want)
    if not err < THRESHOLDS[torch.bfloat16]:
        raise AssertionError(f"lab2 {name} {label}: error {err}")
    return dict(variant=name, function=fn, case=label, rel_err=err,
                max_abs_err=float((got.float() - want.float()).abs().max()))


def phase_lab2(dev, results, library_us_w4):
    """The lab's second half (L7-L12): its entry point over every variant
    (counted), then each case against its plain version, an identity x bit
    for bit, L7 bit for bit, and the plain versions and a bf16 matmul timed
    beside the kernels. ``library_us_w4`` is phase 2b's yardstick, a bf16
    matmul at this shape."""
    from types import SimpleNamespace

    from flute_tpu_torch.lab import kernel_lab2, ops2
    from flute_tpu_torch.lab import ops as lab
    from flute_tpu_torch.ops import lut_gemm
    from flute_tpu_torch.utils.benchmark import bench_op, cold_copies

    sh = LAB2_SHAPE
    m, n, k, bn, bk, g = sh["m"], sh["n"], sh["k"], sh["bn"], sh["bk"], sh["g"]
    for d in (ops2.LAUNCHES, lab.LAUNCHES, lut_gemm.LAUNCHES):
        for kk in d:
            d[kk] = 0
    t0 = time.perf_counter()
    rows = kernel_lab2.main(["--iters", str(LAB_ITERS), "--variants", ",".join(kernel_lab2.ORDER)])
    launches, gemm, lab1 = dict(ops2.LAUNCHES), dict(lut_gemm.LAUNCHES), dict(lab.LAUNCHES)
    main_s = time.perf_counter() - t0

    # calls per GEMM variant: one check call, then bench_op's first call on
    # each input copy and its whole passes over the copies in the graph
    def calls(weight_bytes):
        copies = cold_copies(weight_bytes)
        return 1 + copies + -(-LAB_ITERS // copies) * copies

    scale_bytes = (k // g) * n * 2
    w4_bytes = n * k // 2 + scale_bytes  # one 4-bit plane, or two 2-bit ones
    want = {fn: 0 for fn in ops2.LAUNCHES}
    for v in kernel_lab2.LAB_GEMMS:
        fn = "sep" if v == "sep1" else v
        want[fn] += calls(n * k * 3 // 8 + scale_bytes if v == "w3wide" else w4_bytes)
    # vmembw: per chain length a check call, bench_op's first call, the graph
    want["vmembw"] = len(kernel_lab2.VMEMBW_NOPS) * (2 + kernel_lab2.VMEMBW_ITERS)
    want_gemm = {kk: calls(w4_bytes) if kk == "plane" else 0 for kk in lut_gemm.LAUNCHES}
    if launches != want or gemm != want_gemm or any(lab1.values()):
        raise AssertionError(f"the lab2 run launched {launches}, {gemm} and {lab1}, "
                             f"expected {want}, {want_gemm} and no L1-L6")
    log(f"  the lab2 entry point ran {len(rows)} variants in {main_s:.1f} s; launches {launches}, "
        f"package kernels {gemm}")
    by_name = {r["name"]: r for r in rows}

    inp = kernel_lab2.make_inputs(m, n, k, g, device=dev)
    eye = SimpleNamespace(**{**vars(inp), "x": torch.eye(512, dtype=torch.bfloat16, device=dev)})
    checks = []
    for name in kernel_lab2.LAB_GEMMS:
        weights = kernel_lab2.operands(name, inp)
        checks.append(lab2_check(name, inp, weights, bn, bk, f"M{m} N{n} K{k} bk {bk}"))
        checks.append(lab2_check(name, inp, _cut(weights, k, k, LAB_NARROW_N), LAB_NARROW_N, 256,
                                 f"M{m} N{LAB_NARROW_N} K{k} bk 256"))
        # identity x: every output one product, bit for bit
        fn, args = kernel_lab2.lab_call(name, eye, _cut(weights, k, 512, 256), 16, 256, 256)
        if not _same_bits(ops2.FUNCTIONS[fn](*args), ops2.plain(fn, *args)):
            raise AssertionError(f"lab2 {name}: identity x not bit-exact")
    block = kernel_lab2.vmembw_block(dev)
    for nops in kernel_lab2.VMEMBW_NOPS:
        got = ops2.vmembw(block, nops)
        if not torch.equal(got, ops2.plain("vmembw", block, nops)):
            raise AssertionError(f"lab2 vmembw: nops {nops} not bit-exact")
        checks.append(dict(variant="vmembw", function="vmembw", case=f"nops {nops}", rel_err=0.0,
                           max_abs_err=0.0))
    log(f"  L7-L12: 6 GEMM cases and sep1 agree with their plain versions at M{m} N{n} K{k} "
        f"bk {bk} and at N{LAB_NARROW_N} bk 256 (largest error "
        f"{max(c['rel_err'] for c in checks):.2e}), identity x bit-exact (the sign of a zero "
        "aside); vmembw bit-exact at nops 2 and 8")

    # plain versions and the yardsticks, timed beside the kernels: phase 2b's
    # bf16 matmul for the 4-bit cases, its own for L12's 3-bit weight
    w3 = lut_gemm.dequantize_codes(torch.from_numpy(inp.codes3).to(dev), inp.scales, inp.table3,
                                   torch.bfloat16)
    dense = [(w3.clone(),) for _ in range(cold_copies(w3.numel() * 2))]
    library_us_w3 = bench_op(lambda w: torch.matmul(inp.x, w), dense) * 1e6
    del dense, w3
    cases = []
    xy_bytes = m * k * 2 + m * n * 2
    t_ops = 2 * m * n * k / BF16_OPS_PER_S
    table_bytes = {"pfdirect": 16 * 4, "slabstream": 16 * 4, "sep": 8 * 4, "sep1": 8 * 4,
                   "int4": 0, "w3wide": 8 * 4}
    for name in kernel_lab2.LAB_GEMMS:
        weights = kernel_lab2.operands(name, inp)
        sets = [kernel_lab2.clone_weights(weights) for _ in range(2)]

        def plain(*ws, name=name):
            fn, args = kernel_lab2.lab_call(name, inp, ws, m, bn, bk)
            return ops2.plain(fn, *args)

        t_p = bench_op(plain, sets, min_launches=2)
        del sets
        nbytes = kernel_lab2.weight_bytes(weights) + table_bytes[name] + xy_bytes
        t_bytes = nbytes / HBM_BYTES_PER_S
        row = by_name[name]
        case = dict(variant=name, function="sep" if name == "sep1" else name, us=row["us"],
                    gbps=row["gbps"], lab_share_of_hbm=row["share_of_hbm"], rel=row["rel"],
                    plain_us=t_p * 1e6,
                    library_us=library_us_w3 if name == "w3wide" else library_us_w4,
                    bytes=nbytes, bound_us=max(t_bytes, t_ops) * 1e6,
                    bound_by="bytes" if t_bytes >= t_ops else "operations")
        case["share_of_bound"] = case["bound_us"] / case["us"]
        cases.append(case)
        log(f"    {name:12s} kernel {case['us']:8.1f} us {case['gbps']:7.1f} GB/s  bound "
            f"{case['bound_us']:6.1f} us ({case['bound_by']}, {100 * case['share_of_bound']:5.1f}%)"
            f"  plain {case['plain_us']:8.1f} us  matmul {case['library_us']:6.1f} us  "
            f"rel {case['rel']:.2e}")
    # L7 at its longer chain: the block read once and written once, two
    # int32 operations per element and step
    row = by_name["vmembw"]
    nops = max(kernel_lab2.VMEMBW_NOPS)
    t_p = bench_op(lambda w: ops2.plain("vmembw", w, nops), [(block,)], min_launches=LAB_ITERS)
    t_bytes = 2 * block.numel() * 4 / HBM_BYTES_PER_S
    t_alu = 2 * nops * block.numel() / ALU_OPS_PER_S
    cases += [dict(variant=f"vmembw nops {kk}", function="vmembw", us=v)
              for kk, v in row["t_us"].items() if kk != nops]
    case = dict(variant="vmembw", function="vmembw", us=row["t_us"][nops], nops=nops,
                ns_per_op_per_1024=row["ns_per_op_per_1024"], plain_us=t_p * 1e6,
                library_us=None, bytes=2 * block.numel() * 4,
                bound_us=max(t_bytes, t_alu) * 1e6,
                bound_by="bytes" if t_bytes >= t_alu else "operations")
    case["share_of_bound"] = case["bound_us"] / case["us"]
    cases.append(case)
    log(f"    vmembw       kernel {case['us']:8.2f} us at nops {nops} "
        f"({', '.join(f'nops {kk}: {v:.2f} us' for kk, v in row['t_us'].items())}; slope "
        f"{case['ns_per_op_per_1024']:.4f} ns per 1024 elements per op)  bound "
        f"{case['bound_us']:6.2f} us ({case['bound_by']})  plain {case['plain_us']:8.2f} us")
    row = by_name["prod"]
    log(f"    prod (K2)    kernel {row['us']:8.1f} us {row['gbps']:7.1f} GB/s "
        f"({100 * row['share_of_hbm']:5.1f}% of 3.35 TB/s, the lab's byte count), "
        f"rel {row['rel']:.2e}")
    del inp, eye, block
    torch.cuda.empty_cache()
    results["lab2"] = dict(shape=sh, main_s=main_s, rows=rows, launches=launches,
                           package_launches=gemm, checks=checks, cases=cases)
    return cases, checks, launches


def model_logits(params, config, dev, tokens, offsets, nxt):
    from flute_tpu_torch.models import llama

    b, t = tokens.shape
    with torch.inference_mode():
        cache = llama.init_cache(config, b, 32, device=dev)
        pre, cache = llama.forward(params, config, tokens.to(dev), cache, 0, offsets.to(dev))
        dec, _ = llama.forward(params, config, nxt.to(dev), cache, t, offsets.to(dev))
    return pre.cpu(), dec.cpu()


def higgs_params(config, dev, seed):
    """Random params (a seeded generator on the card) whose every projection
    is a HIGGS-W4 layer: codes, a standard-normal 256-point grid and scales
    of about 0.02 (so the weights have init_params' spread and the logits
    stay finite over 32 layers), group 64, rotation HIGGS_HADAMARD, fused
    qkv and gate_up."""
    from flute_tpu_torch.models import llama
    from flute_tpu_torch.quantize import higgs

    params = llama.init_params(dataclasses.replace(config, num_layers=0), seed=seed, device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    grid = np.random.default_rng(seed).standard_normal((256, 2)).astype(np.float32)
    c = config
    shapes = {  # name -> (K, N)
        "qkv": (c.hidden_size, (c.num_heads + 2 * c.num_kv_heads) * c.head_dim),
        "o": (c.num_heads * c.head_dim, c.hidden_size),
        "gate_up": (c.hidden_size, 2 * c.intermediate_size),
        "down": (c.intermediate_size, c.hidden_size),
    }
    ones = torch.ones((c.hidden_size,), dtype=c.dtype, device=dev)
    for _ in range(c.num_layers):
        layer = {"attn_norm": ones.clone(), "mlp_norm": ones.clone()}
        for name, (k, n) in shapes.items():
            codes = torch.randint(0, 256, (k // 2, n), generator=gen, device=dev)
            scales = (0.015 + 0.01 * torch.rand((k // GROUP, n), generator=gen, device=dev))
            layer[name] = higgs.from_higgs(codes, grid, scales.to(c.dtype), num_bits=4,
                                           group_size=GROUP, hadamard_size=HIGGS_HADAMARD)
        params["layers"].append(layer)
    return params


def check_round_trip(name, qparams, config, dev, tokens, offsets, nxt, out, results, bits):
    """Save, load and run again: the logits must not change."""
    from flute_tpu_torch.integrations import checkpoint

    os.makedirs(os.path.join(HERE, "build"), exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_ckpt_", dir=os.path.join(HERE, "build"))
    try:
        t0 = time.perf_counter()
        checkpoint.save_quantized(tmp, qparams, num_bits=bits, group_size=GROUP)
        size = sum(os.path.getsize(os.path.join(tmp, f)) for f in os.listdir(tmp))
        t1 = time.perf_counter()
        loaded, _ = checkpoint.load_quantized(tmp, device=dev)
        t2 = time.perf_counter()
    finally:
        shutil.rmtree(tmp)
    again = model_logits(loaded, config, dev, tokens, offsets, nxt)
    if not all(torch.equal(a, c) for a, c in zip(out, again)):
        raise AssertionError(f"{name} logits changed across save_quantized/load_quantized")
    log(f"  {name} checkpoint ({size / 1e9:.2f} GB): saved in {t1 - t0:.1f} s, loaded in "
        f"{t2 - t1:.1f} s; logits bit-exact after the round trip")
    results.setdefault("checkpoint_round_trip", {})[name] = dict(
        bytes=size, save_s=t1 - t0, load_s=t2 - t1, bit_exact=True)


@contextlib.contextmanager
def other_sum_order():
    """lut_qgemm_plain with its K sum split in two halves: the same product
    with another f32 summation order. The logits it gives show how far the
    bf16 roundings alone move a model's logits."""
    from flute_tpu_torch.ops import lut_gemm

    plain = lut_gemm.lut_qgemm_plain

    def halves(x2, planes, scales, table, *, num_bits, chunk, layout, pair_values=None):
        codes = lut_gemm._packing.unpack(list(planes), num_bits, chunk=chunk, layout=layout)
        deq = (lut_gemm.dequantize_codes(codes, scales, table, x2.dtype) if pair_values is None
               else lut_gemm.dequantize_codes_pair(codes, scales, pair_values, x2.dtype)).float()
        h = x2.shape[1] // 2
        y = x2[:, :h].float() @ deq[:h] + x2[:, h:].float() @ deq[h:]
        return y.to(x2.dtype)

    lut_gemm.lut_qgemm_plain = halves
    try:
        yield
    finally:
        lut_gemm.lut_qgemm_plain = plain


def phase_logits(dev, results):
    from flute_tpu_torch.interop import move_params
    from flute_tpu_torch.models import llama

    config = dataclasses.replace(llama.LlamaConfig.llama31_8b(), num_layers=2)
    params = llama.init_params(config, seed=1, device=dev)
    cpu = torch.device("cpu")
    rng = np.random.default_rng(1)
    b, t = 2, 16
    tokens = torch.from_numpy(rng.integers(0, config.vocab_size, (b, t)))
    offsets = torch.tensor([0, 5])
    nxt = torch.from_numpy(rng.integers(0, config.vocab_size, (b, 1)))
    results["logits_rel_err"] = {}
    for name in (*SERVED, "higgs_w4"):
        if name == "higgs_w4":
            qparams = higgs_params(config, dev, seed=1)
        else:
            qparams = llama.quantize_model(params, group_size=GROUP, fuse=True, device=dev,
                                           **SERVED[name][0])
        out = model_logits(qparams, config, dev, tokens, offsets, nxt)
        qcpu = move_params(qparams, cpu)
        ref = model_logits(qcpu, config, cpu, tokens, offsets, nxt)
        limit = {step: THRESHOLDS[torch.bfloat16] for step in ("prefill", "decode")}
        floor = None
        if name == "higgs_w4":
            # the rotation adds a bf16 rounding before every projection, and
            # a change of f32 summation order alone moves this model's logits
            # by about the bf16 threshold: the card may differ from the CPU by
            # twice what two CPU orders differ by, if that is more
            with other_sum_order():
                ref2 = model_logits(qcpu, config, cpu, tokens, offsets, nxt)
            floor = {step: float((a - b).abs().max() / b.abs().max())
                     for step, a, b in zip(("prefill", "decode"), ref2, ref)}
            limit = {step: max(limit[step], 2 * floor[step]) for step in limit}
        del qcpu
        errs = {}
        for step, a, want in zip(("prefill", "decode"), out, ref):
            if not torch.isfinite(a).all():
                raise AssertionError(f"{name}: non-finite {step} logits")
            errs[step] = float((a - want).abs().max() / want.abs().max())
            if not errs[step] < limit[step]:
                raise AssertionError(
                    f"{name} {step} logits differ from the CPU plain path: {errs[step]} "
                    f"(limit {limit[step]})")
        log(f"  2-layer 8B-width {name} logits vs CPU plain path: prefill "
            f"{errs['prefill']:.2e}, decode {errs['decode']:.2e}"
            + ("" if floor is None else
               f" (another CPU summation order alone: prefill {floor['prefill']:.2e}, "
               f"decode {floor['decode']:.2e})"))
        results["logits_rel_err"][name] = dict(errs, sum_order_floor=floor)
        if name in ("w3wide", "higgs_w4"):
            # a save/load round trip through the checkpoint format changes nothing
            check_round_trip(name, qparams, config, dev, tokens, offsets, nxt, out, results,
                             bits=3 if name == "w3wide" else 4)
        del qparams
    del params
    torch.cuda.empty_cache()


def serve(dev, name, quant_kw, kernel_layout):
    """Quantize the 32-layer model on the card and serve the prompts once;
    returns the run's numbers, the engine (which keeps the model) and the
    tokens with the logits that chose them (one [B, V] row block per step)."""
    from flute_tpu_torch.models import llama
    from flute_tpu_torch.ops import lut_gemm
    from flute_tpu_torch.serving import Engine

    config = llama.LlamaConfig.llama31_8b()
    held = torch.cuda.memory_allocated(dev)  # models served earlier
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    params = llama.init_params(config, seed=0, device=dev)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    qparams = llama.quantize_model(params, group_size=GROUP, fuse=True, device=dev, **quant_kw)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    del params
    torch.cuda.empty_cache()
    log(f"  [{name}] init {t1 - t0:.1f} s, quantize {t2 - t1:.1f} s, "
        f"{(torch.cuda.memory_allocated(dev) - held) / 2**30:.2f} GiB allocated after "
        "quantization")

    prompts = serving_prompts(config)
    lengths = [len(p) for p in prompts]
    new_tokens = NEW_TOKENS
    eng = Engine(params=qparams, config=config, batch_size=8, max_len=256, device=dev)

    logits_seen = []
    step_logits = []
    forward = eng.forward

    def checked_forward(*a, **kw):
        logits, cache = forward(*a, **kw)
        logits_seen.append(bool(torch.isfinite(logits).all()))
        step_logits.append(logits[:, -1].float())
        return logits, cache

    eng.forward = checked_forward
    for k in lut_gemm.LAUNCHES:
        lut_gemm.LAUNCHES[k] = 0
    out = eng.generate(prompts, max_new_tokens=new_tokens)
    launches = dict(lut_gemm.LAUNCHES)
    eng.forward = forward

    steps = len(logits_seen)  # one prefill + the decode steps
    expected = {k: 0 for k in launches}
    expected[kernel_layout] = steps * config.num_layers * 4
    if steps != new_tokens or launches != expected:
        raise AssertionError(f"[{name}] launches {launches} over {steps} steps, "
                             f"expected {expected}")
    if not all(logits_seen):
        raise AssertionError(f"[{name}] non-finite logits while serving")
    if any(len(o) != new_tokens for o in out):
        raise AssertionError(f"[{name}] a prompt got {[len(o) for o in out]} tokens")
    tm = eng.last_timings
    decode_s = [float(d) for d in tm["decode_s"]]
    dec = float(np.median(decode_s))
    total = tm["prefill_s"] + sum(decode_s)
    serving = dict(
        prompts=len(prompts), prompt_lengths=lengths, new_tokens=new_tokens,
        steps=steps, launches=launches, prefill_ms=tm["prefill_s"] * 1e3,
        decode_ms_per_step=dec * 1e3, decode_ms_steps=[d * 1e3 for d in decode_s],
        decode_tok_s=len(prompts) / dec, end_to_end_tok_s=len(prompts) * new_tokens / total,
        peak_gib=(torch.cuda.max_memory_allocated(dev) - held) / 2**30,
    )
    log(f"  [{name}] served {len(prompts)} prompts x {new_tokens} tokens: prefill "
        f"{serving['prefill_ms']:.1f} ms, decode {serving['decode_ms_per_step']:.2f} ms/step "
        f"(median; {min(decode_s) * 1e3:.2f}-{max(decode_s) * 1e3:.2f}), "
        f"{serving['decode_tok_s']:.1f} decode tok/s, "
        f"{serving['end_to_end_tok_s']:.1f} tok/s end to end, "
        f"{launches[kernel_layout]} {kernel_layout} kernel launches, "
        f"peak {serving['peak_gib']:.1f} GiB")
    return serving, eng, (out, torch.stack(step_logits).cpu())


NEW_TOKENS = 16


def serving_prompts(config):
    """The 8 ragged prompts every served run starts from."""
    rng = np.random.default_rng(2)
    return [rng.integers(1, config.vocab_size, n).tolist() for n in (3, 40, 17, 8, 29, 5, 36, 12)]


def serve_paged(dev, name, params, config, requests, engine_kw, gemm, keep_logits=False):
    """Serve ``requests`` [(prompt, submit keywords)] through PagedEngine;
    require the exact launches of its path: the LUT-GEMM ``gemm`` 4 x 32
    per forward call, K5 32 per decode step, K6 32 per pool-prefill chunk,
    no other LUT-GEMM. Returns the run's numbers, the engine, the tokens by
    request, the first-token logits rows by request and, with
    ``keep_logits``, each decode step's logits [slots, V] on the host."""
    from flute_tpu_torch.ops import lut_gemm
    from flute_tpu_torch.ops import paged_attention as pa
    from flute_tpu_torch.serving import PagedEngine

    held = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    eng = PagedEngine(params=params, config=config, device=dev, **engine_kw)
    calls = dict(decode=0, pool_chunks=0, dense_prefill=0, waits=0)
    decode_s, prefill_s, finite, peak_blocks, decode_rows = [], [], [], [0], []
    first_rows = {}

    def wrap(obj, attr, after):
        fn = getattr(obj, attr)

        def wrapped(*a, **kw):
            t0 = time.perf_counter()
            r = fn(*a, **kw)
            after(r, t0, *a)
            return r

        setattr(obj, attr, wrapped)

    def on_decode_logits(r, t0, *a):
        calls["decode"] += 1
        finite.append(bool(torch.isfinite(r).all()))
        if keep_logits:
            decode_rows.append(r.float().cpu())

    def on_decode(r, t0, *a):  # ends in a copy to the host: a synchronised step
        decode_s.append(time.perf_counter() - t0)

    def on_pool(r, t0, *a):
        calls["pool_chunks"] += 1
        finite.append(bool(torch.isfinite(r[0]).all()))

    def on_dense(r, t0, *a):
        calls["dense_prefill"] += 1

    def on_prefill(r, t0, *a):
        torch.cuda.synchronize()
        prefill_s.append(time.perf_counter() - t0)

    def on_admit(r, t0, *a):
        # pool pressure: a request waits while a slot is free
        if eng._queue and any(req is None for req in eng._slot_req):
            calls["waits"] += 1

    wrap(eng, "_decode_logits", on_decode_logits)
    wrap(eng, "_decode", on_decode)
    if eng._pool_fwd is not None:
        wrap(eng, "_pool_fwd", on_pool)
    wrap(eng, "forward", on_dense)
    wrap(eng, "_prefill_pool", on_prefill)
    wrap(eng, "_prefill_dense", on_prefill)
    eng._start = _record_first(eng, first_rows)
    wrap(eng, "_admit", on_admit)

    for d in (lut_gemm.LAUNCHES, pa.LAUNCHES):
        for k in d:
            d[k] = 0
    rids = [eng.submit(p, **kw) for p, kw in requests]
    t0 = time.perf_counter()
    while eng.step():
        peak_blocks[0] = max(peak_blocks[0], eng.blocks_in_use)
    out = eng.run()
    total = time.perf_counter() - t0
    launches = {**lut_gemm.LAUNCHES, **pa.LAUNCHES}

    forwards = calls["decode"] + calls["pool_chunks"] + calls["dense_prefill"]
    layers = config.num_layers
    expected = {k: 0 for k in launches}
    expected[gemm] = forwards * layers * 4
    expected["paged_decode"] = calls["decode"] * layers
    expected["paged_verify"] = calls["pool_chunks"] * layers
    if launches != expected:
        raise AssertionError(f"[{name}] launches {launches}, expected {expected} ({calls})")
    if not all(finite):
        raise AssertionError(f"[{name}] non-finite logits while serving")
    budgets = [kw["max_new_tokens"] for _, kw in requests]
    if [len(out[r]) for r in rids] != budgets:
        raise AssertionError(f"[{name}] tokens {[len(out[r]) for r in rids]} != {budgets}")
    tokens = sum(budgets)
    serving = dict(
        requests=len(requests), prompt_lengths=[len(p) for p, _ in requests],
        new_tokens=budgets, calls=dict(calls), launches=launches,
        prefix_hits=eng.prefix_hits, prefix_block_hits=eng.prefix_block_hits,
        prefill_ms_per_admission=float(np.median(prefill_s)) * 1e3,
        prefill_ms=[x * 1e3 for x in prefill_s],
        decode_ms_per_step=float(np.median(decode_s)) * 1e3,
        decode_ms_quickest=min(decode_s) * 1e3,
        decode_ms_steps=[x * 1e3 for x in decode_s],
        tok_s=tokens / total, peak_blocks_in_use=peak_blocks[0],
        peak_gib=(torch.cuda.max_memory_allocated(dev) - held) / 2**30,
    )
    log(f"  [{name}] {len(requests)} requests, {tokens} tokens: prefill "
        f"{serving['prefill_ms_per_admission']:.1f} ms per admission (median), decode "
        f"{serving['decode_ms_per_step']:.2f} ms/step (median; quickest "
        f"{serving['decode_ms_quickest']:.2f}) over {calls['decode']} steps, "
        f"{serving['tok_s']:.1f} tok/s, {calls['waits']} admission waits for blocks, "
        f"prefix hits {eng.prefix_hits}, peak {peak_blocks[0]} blocks in use, "
        f"peak {serving['peak_gib']:.1f} GiB; launches {launches}")
    return serving, eng, [out[r] for r in rids], [first_rows[r] for r in rids], decode_rows


def _record_first(eng, first_rows):
    """Wrap the engine's first-token step to keep each request's raw row."""
    start = eng._start

    def wrapped(slot, prompt, sampling, last_row):
        first_rows[eng._slot_req[slot]] = last_row.cpu()
        return start(slot, prompt, sampling, last_row)

    return wrapped


def profile_steps(name, step):
    """Where a decode step's device time goes: three calls of ``step``
    under torch.profiler, outside the counted runs (the profiler runs only
    after every timed run, so it cannot slow one down)."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for i in range(3):
            step(i)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    by_kernel = {}
    for ev in prof.key_averages():
        dt = getattr(ev, "device_time_total", None)
        if dt is None:
            dt = getattr(ev, "cuda_time_total", 0)
        if ev.device_type == torch.autograd.DeviceType.CUDA and dt > 0:
            by_kernel[ev.key] = dt / 3 / 1e3  # ms per step
    dev_ms = sum(by_kernel.values())
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:12]
    profile = dict(
        wall_ms_per_step=wall / 3 * 1e3,
        device_ms_per_step=dev_ms if by_kernel else None,
        idle_share=(1 - dev_ms / (wall / 3 * 1e3)) if by_kernel else None,
        top_kernels_ms_per_step=top,
    )
    if by_kernel:
        log(f"  [{name}] decode step profile: wall {wall / 3 * 1e3:.2f} ms, device busy "
            f"{dev_ms:.2f} ms (idle share {profile['idle_share']:.2f})")
        for k_name, ms in top[:6]:
            log(f"    {ms:8.3f} ms  {k_name[:100]}")
    else:
        log(f"  [{name}] decode step profile: the profiler recorded no device time "
            "(not measured)")
    return profile


def profile_decode(dev, name, eng):
    """An Engine's decode step at batch 8 after a 64-token prefill."""
    config = eng.config
    rng = np.random.default_rng(3)
    with torch.inference_mode():
        toks = torch.from_numpy(rng.integers(1, config.vocab_size, (8, 64))).to(dev)
        offs = torch.zeros(8, dtype=torch.int64, device=dev)
        _, cache = eng.prefill(toks, offs)
        nxt = toks[:, -1:]
        eng.decode(nxt, cache, 64, offs)
        torch.cuda.synchronize()
        return profile_steps(name, lambda i: eng.decode(nxt, cache, 65 + i, offs))


def profile_paged(name, eng, prompts):
    """A PagedEngine decode step with 8 live requests."""
    for p in prompts:
        eng.submit(p, max_new_tokens=8)
    eng.step()  # admission and a first decode step
    torch.cuda.synchronize()
    profile = profile_steps(name, lambda i: eng.step())
    eng.run()
    return profile


def kernel_line(kid, cases, launches):
    """The {"kernels": [...]} entry of a LUT-GEMM: its decode stack, one
    layer's four projections at M=8 in bf16 (K2 and K4 at 4 bits)."""
    wrapper, source, _, replaces = KERNELS[kid]
    bits = 4 if kid != "K3" else 3
    mine = [c for c in cases if c["kernel"] == kid]
    stack = [c for c in mine if c["bits"] == bits and c["m"] == 8 and c["dtype"] == "bfloat16"]
    return dict(
        name=wrapper,
        route="cuda",
        source=f"flute_tpu_torch/csrc/{source}",
        replaces=replaces,
        launches=launches,
        max_abs_err=max(c["max_abs_err"] for c in mine),
        ms=sum(c["us"] for c in stack) / 1e3,
        plain_ms=sum(c["plain_us"] for c in stack) / 1e3,
        bound_ms=sum(c["bound_us"] for c in stack) / 1e3,
        bound_by="bytes" if all(c["bound_by"] == "bytes" for c in stack) else "operations",
        library_ms=sum(c["library_us"] for c in stack) / 1e3,
        checked=True,
    )


def attention_line(kid, checks, timed, launches):
    """The {"kernels": [...]} entry of K5 (one call at B=8, every length
    1024) or K6 (one call, T=256 over 1024 cached positions)."""
    wrapper, source, _, replaces = KERNELS[kid]
    row = [c for c in timed if c["kernel"] == kid][0]
    return dict(
        name=wrapper,
        route="cuda",
        source=f"flute_tpu_torch/csrc/{source}",
        replaces=replaces,
        launches=launches,
        max_abs_err=max(c["max_abs_err"] for c in checks if c["kernel"] == kid),
        ms=row["us"] / 1e3,
        plain_ms=row["plain_us"] / 1e3,
        bound_ms=row["bound_us"] / 1e3,
        bound_by=row["bound_by"],
        library_ms=row["library_us"] / 1e3,
        checked=True,
    )


def first_tie_steps(logits, tol=THRESHOLDS[torch.bfloat16]):
    """Per sequence, the first step whose top-1/top-2 margin is within
    twice ``tol`` of the largest logit (``logits`` [steps, B, V]); and the
    share of (step, sequence) pairs decided."""
    top2 = torch.topk(logits, 2, dim=-1).values
    scale = logits.abs().amax(dim=-1)
    decided = (top2[..., 0] - top2[..., 1]) > 2 * tol * scale  # [steps, B]
    return [int(torch.argmin(col.int())) if not bool(col.all()) else col.numel()
            for col in decided.T], float(decided.float().mean())


def phase_paged(dev, results, w4sym_engine, w4sym_trajectory):
    """PagedEngine at w4sym (dense prefill) against Engine, then the HIGGS-W4
    model with pool prefill, prefix sharing, pool pressure and sampling."""
    from flute_tpu_torch.models import llama

    config = llama.LlamaConfig.llama31_8b()
    prompts = serving_prompts(config)
    budget = dict(max_new_tokens=NEW_TOKENS)

    # w4sym: the Engine's model and prompts
    out, logits = w4sym_trajectory
    ties, decided = first_tie_steps(logits[:, : len(prompts)])
    serving, eng, tokens, first, rows = serve_paged(
        dev, "paged w4sym", w4sym_engine.params, config, [(p, budget) for p in prompts],
        dict(num_slots=8, block_size=16, num_blocks=8 * 4 + 1, max_len=256), "w4sym",
        keep_logits=True)
    for i, tie in enumerate(ties):
        if tokens[i][:tie] != out[i][:tie]:
            raise AssertionError(f"paged w4sym: request {i} differs from Engine before step {tie}")
    # every request was admitted at once, request i into slot i: while its
    # tokens equal Engine's, decode step k's row i is Engine's step k + 1.
    # Engine rounds attention probabilities to bf16 and K5 keeps them in
    # f32, which alone moves 32-layer logits by a few percent (PERF.md, PR
    # 3); a wrong position or block would move them by their whole size.
    if serving["calls"]["waits"]:
        raise AssertionError("paged w4sym: a request waited for blocks")
    step_err, compared = 0.0, 0
    for k, row in enumerate(rows[: NEW_TOKENS - 1]):
        for i in range(len(prompts)):
            if tokens[i][: k + 1] == out[i][: k + 1]:
                want_k = logits[k + 1, i]
                step_err = max(step_err, float((row[i] - want_k).abs().max() / want_k.abs().max()))
                compared += 1
    if not step_err < 0.25:
        raise AssertionError(f"paged w4sym: decode logits differ from Engine's: {step_err}")
    first = torch.stack(first)
    want = logits[0, : len(prompts)]
    first_err = float(((first - want).abs().amax(dim=-1) / want.abs().amax(dim=-1)).max())
    if not first_err < THRESHOLDS[torch.bfloat16]:
        raise AssertionError(f"paged w4sym: first-token logits differ from Engine: {first_err}")
    same = sum(a == b for a, b in zip(tokens, out))
    log(f"  [paged w4sym] tokens equal Engine's before every low-margin step (decided share "
        f"{decided:.2f}; {same}/{len(out)} sequences identical in full); first-token logits "
        f"within {first_err:.2e}; decode logits within {step_err:.2e} of Engine's over "
        f"{compared} (step, request) pairs with the same history")
    serving.update(first_token_rel_err=first_err, decided_share=decided,
                   identical_sequences=same, decode_logits_rel_err=step_err,
                   decode_rows_compared=compared)
    results["serving"]["paged_w4sym"] = serving
    del eng
    torch.cuda.empty_cache()

    # HIGGS-W4 with pool prefill: 12 requests, the last 4 sharing the first
    # 32 tokens (2 blocks) of prompt 1, two sampled
    t0 = time.perf_counter()
    params = higgs_params(config, dev, seed=0)
    torch.cuda.synchronize()
    log(f"  [paged HIGGS-W4] built the 32-layer HIGGS model in {time.perf_counter() - t0:.1f} s")
    rng = np.random.default_rng(5)
    extra = [rng.integers(1, config.vocab_size, n).tolist() for n in (5, 9, 14, 3)]
    all_prompts = prompts + [prompts[1][:32] + e for e in extra]
    sampled = dict(temperature=0.8, top_k=50, top_p=0.9)
    kws = [dict(budget) for _ in all_prompts]
    kws[2].update(sampled, seed=11)
    kws[9].update(sampled, seed=12)
    # the first 8 requests need 22 blocks: 19 usable make admission wait
    engine_kw = dict(num_slots=8, block_size=16, num_blocks=20, max_len=256,
                     prefix_cache_blocks=16, pool_prefill=True)
    serving, eng, _, _, _ = serve_paged(dev, "paged HIGGS-W4", params, config,
                                        list(zip(all_prompts, kws)), engine_kw, "pair")
    if serving["prefix_hits"] < 1 or serving["calls"]["waits"] < 1:
        raise AssertionError(f"paged HIGGS-W4: prefix hits {serving['prefix_hits']}, "
                             f"admission waits {serving['calls']['waits']}")
    results["serving"]["paged_higgs_w4"] = serving
    return eng, prompts


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    from flute_tpu_torch.lab import ops as lab_ops
    from flute_tpu_torch.lab import ops2 as lab2_ops
    from flute_tpu_torch.ops import _build, lut_gemm
    from flute_tpu_torch.ops import paged_attention as pa

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    results = {"torch": torch.__version__, "cuda": torch.version.cuda}
    t_start = time.perf_counter()

    log("== 1. card and build")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    log(smi)
    results["nvidia_smi"] = smi
    t0 = time.perf_counter()
    sources = sorted({source for _, source, _, _ in KERNELS.values()})
    _build.build_all(sources)
    lut_gemm.build_kernels()
    for kernel in pa.LAUNCHES:
        pa._kernel_fn(kernel)
    lab_ops.build_kernels()
    lab2_ops.build_kernels()
    build_s = time.perf_counter() - t0
    log(f"  built the {len(sources)} kernel libraries in {build_s:.1f} s (in parallel)")
    for source in sources:
        lib = _build.library_path(source)
        log(f"  {os.path.relpath(lib, HERE)}")
        ptxas = lib.with_suffix(".log").read_text()
        regs = [int(r) for r in re.findall(r"Used (\d+) registers", ptxas)]
        spill = max(int(b) for b in re.findall(r"(\d+) bytes spill stores", ptxas))
        log(f"    ptxas: {len(regs)} kernels, {min(regs)}-{max(regs)} registers, "
            f"at most {spill} bytes of spill stores")
    results["build_s"] = build_s

    log("== 2. kernels against plain on the card")
    cases = phase_kernel(dev, results)
    attn_checks, attn_timed = phase_attention(dev, results)
    log("== 2b. the Hopper lab (L1-L6)")
    lab_cases, lab_checks, lab_launches = phase_lab(dev, results)
    log("== 2c. the Hopper lab, second half (L7-L12)")
    lab2_cases, lab2_checks, lab2_launches = phase_lab2(dev, results,
                                                        lab_cases[0]["library_us"])
    lab_before = dict(lab_ops.LAUNCHES)
    lab2_before = dict(lab2_ops.LAUNCHES)
    log("== 3. model logits against the CPU plain path; checkpoint round trip")
    phase_logits(dev, results)
    log("== 4. serving Llama-3.1-8B widths, 32 layers")
    results["serving"] = {}
    launches = {}
    engines = {}
    trajectories = {}
    for name, (kw, kid) in SERVED.items():
        layout = KERNELS[kid][2]
        results["serving"][name], engines[name], trajectories[name] = serve(dev, name, kw,
                                                                            layout)
        launches[kid] = results["serving"][name]["launches"][layout]
    paged_eng, prompts = phase_paged(dev, results, engines["w4sym"], trajectories["w4sym"])
    higgs_launches = results["serving"]["paged_higgs_w4"]["launches"]
    for kid in ("K4", "K5", "K6"):
        launches[kid] = higgs_launches[KERNELS[kid][2]]
    for name, eng in engines.items():
        results["serving"][name]["profile"] = profile_decode(dev, name, eng)
    results["serving"]["paged_higgs_w4"]["profile"] = profile_paged("paged HIGGS-W4", paged_eng,
                                                                    prompts)
    del engines, paged_eng
    torch.cuda.empty_cache()
    lab_served = {fn: lab_ops.LAUNCHES[fn] - lab_before[fn] for fn in lab_before}
    lab2_served = {fn: lab2_ops.LAUNCHES[fn] - lab2_before[fn] for fn in lab2_before}
    if any(lab_served.values()) or any(lab2_served.values()):
        raise AssertionError(f"phases 3 and 4 launched lab kernels: {lab_served}, {lab2_served}")
    log(f"  lab kernels launched in phases 3 and 4: {lab_served}, {lab2_served}")

    kernels = [kernel_line(kid, cases, launches[kid]) for kid in LUT_KERNELS]
    kernels += [attention_line(kid, attn_checks, attn_timed, launches[kid])
                for kid in ("K5", "K6")]
    kernels += [lab_line(kid, LAB, lab_cases, lab_checks, lab_launches, lab_served)
                for kid in LAB]
    kernels += [lab_line(kid, LAB2, lab2_cases, lab2_checks, lab2_launches, lab2_served)
                for kid in LAB2]
    results["kernels"] = kernels
    results["total_s"] = time.perf_counter() - t_start
    log(f"  chip_smoke took {results['total_s']:.0f} s")
    os.makedirs(os.path.join(HERE, "chiprun_out"), exist_ok=True)
    with open(os.path.join(HERE, "chiprun_out", "chip_smoke.json"), "w") as f:
        json.dump(results, f, indent=1)
    log(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
