"""The second half of the Hopper kernel lab, counterpart of
``scripts/kernel_lab2.py``: time candidate dequantization pipelines of the
LUT-GEMM on the card.

    python -m flute_tpu_torch.lab.kernel_lab2 --variants prod,pfdirect,sep,sep1,int4
    python -m flute_tpu_torch.lab.kernel_lab2 --device cpu --n 256 --k 512 --bn 128 --bk 256

Variants (the names of the JAX lab's ``main``; W4 g64 bf16, M16 N28672 K8192
by default):

  prod        K2, the package's plane kernel (``lut_qgemm``, gather8).
  pfdirect    L8: the 16-entry lookup indexed from the raw 8-bit pair field
              (no ce/co split); the chunk's operand goes through shared
              memory before the products.
  sep, sep1   L9: a separable table T[c] = A[c & 3] + B[c >> 2] over two
              2-bit planes: two products, or one on the bf16 sum.
  int4        L10: the affine table T[c] = z + c·δ, no lookup.
  slabstream  L11: L8's function, each decoded pair fed to its products in
              registers.
  w3wide      L12: the wide 3-bit layout (3-bit codes drawn after x).
  vmembw      L7: v ← v ^ (v >> 1), 2 and 8 times, on a [256, 2048] int32
              block that stays in L2; prints the slope per operation.

Each GEMM's time comes from ``utils/benchmark.py::bench_op`` (CUDA events
over a CUDA graph of at least ``--iters`` launches, cycling copies of the
planes and scales past the L2 cache); ``vmembw`` takes 4000 launches on one
block, as the JAX lab does. ``report`` counts the bytes as the JAX lab's
``gemm_bytes`` does (planes, scales, x and y) and takes the share of the
H100's 3.35 TB/s. ``rel`` (largest error over the largest output, against
``lut_qgemm_reference`` with the variant's table) is printed where the JAX
lab prints it. On the CPU (``--device cpu``) the plain versions run and
nothing is timed. ``main`` runs once (the JAX lab's ``main`` calls itself
at its end).
"""

from __future__ import annotations

import argparse
from types import SimpleNamespace

import numpy as np
import torch

from flute_tpu_torch import packing
from flute_tpu_torch.device import resolve_device
from flute_tpu_torch.lab import ops2
from flute_tpu_torch.lab.kernel_lab import HBM_BYTES_PER_S, card_label
from flute_tpu_torch.ops import lut_gemm
from flute_tpu_torch.ops.kernel_config import KernelConfig
from flute_tpu_torch.quantize import nf

BITS, G = 4, 64
# the JAX lab's order of variants in main()
ORDER = ("prod", "pfdirect", "sep", "sep1", "int4", "slabstream", "w3wide", "vmembw")
# the variants that run a lab GEMM ("prod" is the package's K2)
LAB_GEMMS = ("pfdirect", "sep", "sep1", "int4", "slabstream", "w3wide")
# the separable surrogate table (A over the low 2 bits, B over the high 2)
# and the affine one, T[c] = (c - 8)·0.05, of the JAX lab's main
SEP_A = np.asarray([-0.3, -0.1, 0.1, 0.3], np.float32)
SEP_B = np.asarray([-0.9, -0.2, 0.2, 0.9], np.float32)
INT4_ZERO, INT4_DELTA = -8.0 * 0.05, 0.05
# vmembw: the block, the chain lengths and the launches per timing
VMEMBW_SHAPE, VMEMBW_NOPS, VMEMBW_ITERS = (256, 2048), (2, 8), 4000


def make_inputs(m, n, k, g=G, device=None, w3=True) -> SimpleNamespace:
    """The JAX lab's inputs from ``default_rng(0)`` in its order: 4-bit codes
    ``[K, N]`` (numpy), bf16 scales ``[K/g, N]`` in [0.5, 1.5), a
    standard-normal bf16 ``x`` ``[M, K]`` and, after x, 3-bit codes (with
    ``w3``); the planes (4-bit, the two 2-bit planes of L9, the wide 3-bit
    one) are packed on ``device`` (bit-equal to the numpy packers)."""
    dev = resolve_device(device)
    rng = np.random.default_rng(0)
    codes = rng.integers(0, 16, size=(k, n), dtype=np.int32)
    scales = torch.from_numpy(rng.uniform(0.5, 1.5, (k // g, n)).astype(np.float32))
    x = torch.from_numpy(rng.standard_normal((m, k)).astype(np.float32))
    inp = SimpleNamespace(codes=codes, scales=scales.to(dev, torch.bfloat16),
                          x=x.to(dev, torch.bfloat16),
                          table=torch.from_numpy(nf.nf_values(BITS)).to(dev),
                          sep_a=torch.from_numpy(SEP_A).to(dev),
                          sep_b=torch.from_numpy(SEP_B).to(dev),
                          table3=torch.from_numpy(nf.nf_values(3)).to(dev))
    c = torch.from_numpy(codes).to(dev)
    inp.planes = packing.pack_plane(c, BITS)
    inp.planes_a = packing.pack_plane(c & 3, 2)
    inp.planes_b = packing.pack_plane(c >> 2, 2)
    del c
    inp.codes3, inp.planes3 = None, None
    if w3:
        inp.codes3 = rng.integers(0, 8, size=(k, n), dtype=np.int32)
        inp.planes3 = [packing.pack_w3_wide(torch.from_numpy(inp.codes3).to(dev))]
    return inp


def sep_table(device=None) -> torch.Tensor:
    """``T[c] = A[c & 3] + B[c >> 2]`` in f32, the sep variants' oracle."""
    return torch.from_numpy((SEP_A[None, :] + SEP_B[:, None]).reshape(-1)).to(device)


def affine_table(device=None) -> torch.Tensor:
    """``T[c] = (c - 8)·0.05`` in f32, int4's oracle."""
    return torch.from_numpy(((np.arange(16) - 8.0) * 0.05).astype(np.float32)).to(device)


def gemm_bytes(m, n, k, bits, g=G) -> int:
    """The JAX lab's byte count: planes, scales, x and y."""
    return k * n * bits // 8 + (k // g) * n * 2 + m * k * 2 + m * n * 2


def operands(name, inp):
    """The weight operands of variant ``name`` that a timed call cycles
    through (planes and scales)."""
    if name in ("sep", "sep1"):
        return (inp.planes_a, inp.planes_b, inp.scales)
    if name == "w3wide":
        return (inp.planes3, inp.scales)
    return (inp.planes, inp.scales)


def _tensors(weights):
    for w in weights:
        yield from (w if isinstance(w, list) else [w])


def weight_bytes(weights) -> int:
    """Bytes of the weight operands (planes and scales)."""
    return sum(t.numel() * t.element_size() for t in _tensors(weights))


def clone_weights(weights) -> tuple:
    """A copy of the weight operands, in their structure."""
    return tuple([p.clone() for p in w] if isinstance(w, list) else w.clone() for w in weights)


def lab_call(name, inp, weights, bm, bn, bk, g=G):
    """(lab function, its arguments in the JAX signature) of variant
    ``name`` on ``inp.x`` with the weight operands ``weights`` (as
    ``operands`` gives them)."""
    x = inp.x
    if name in ("sep", "sep1"):
        pa, pb, scales = weights
        return "sep", (x, pa, pb, scales, inp.sep_a, inp.sep_b, bm, bn, bk, g, name == "sep1")
    planes, scales = weights
    if name == "int4":
        return "int4", (x, planes, scales, bm, bn, bk, g, INT4_ZERO, INT4_DELTA)
    return name, (x, planes, scales, inp.table3 if name == "w3wide" else inp.table,
                  bm, bn, bk, g)


def run_variant(name, inp, weights, bm, bn, bk, g=G):
    """GEMM variant ``name``: the package's K2 (``prod``) or a lab
    function."""
    if name == "prod":
        planes, scales = weights
        cfg = KernelConfig(block_m=bm, block_n=bn, block_k=bk)
        return lut_gemm.lut_qgemm(inp.x, planes, scales, inp.table, num_bits=BITS, config=cfg)
    fn, args = lab_call(name, inp, weights, bm, bn, bk, g)
    return ops2.FUNCTIONS[fn](*args)


def oracle(name, inp) -> torch.Tensor:
    """``lut_qgemm_reference`` with the variant's codes and table (f32)."""
    dev = inp.x.device
    codes = inp.codes3 if name == "w3wide" else inp.codes
    table = {"sep": sep_table, "sep1": sep_table, "int4": affine_table}.get(name)
    table = inp.table3 if name == "w3wide" else (inp.table if table is None else table(dev))
    return lut_gemm.lut_qgemm_reference(inp.x, torch.from_numpy(codes).to(dev), inp.scales,
                                        table).float()


def report(name, t, nbytes, card="") -> dict:
    """Print and return one variant's row; ``t`` is seconds per call (None:
    not measured)."""
    row = dict(name=name, bytes=nbytes, us=None, gbps=None, share_of_hbm=None)
    if t is None:
        print(f"{name:12s}: not measured (CPU)", flush=True)
        return row
    gbps = nbytes / t / 1e9
    row.update(us=t * 1e6, gbps=gbps, share_of_hbm=gbps * 1e9 / HBM_BYTES_PER_S)
    print(f"{name:12s}: {t * 1e6:8.1f} us  {gbps:7.1f} GB/s "
          f"({100 * row['share_of_hbm']:5.1f}% of 3.35 TB/s{', ' + card if card else ''})",
          flush=True)
    return row


def vmembw_block(device) -> torch.Tensor:
    """``run_vmembw``'s block: ``default_rng(0)`` integers in [0, 2^30)."""
    w = np.random.default_rng(0).integers(0, 2**30, VMEMBW_SHAPE)
    return torch.from_numpy(w.astype(np.int32)).to(device)


def run_vmembw(device, timed, card="") -> dict:
    """L7 at 2 and 8 chained steps; the slope in ns per 1024 int32 elements
    per operation (two operations a step)."""
    from flute_tpu_torch.utils.benchmark import bench_op

    w = vmembw_block(device)
    row = dict(name="vmembw", t_us={})
    for nops in VMEMBW_NOPS:
        ops2.vmembw(w, nops)
        if timed:
            t = bench_op(lambda w_, n=nops: ops2.vmembw(w_, n), [(w,)], min_launches=VMEMBW_ITERS)
            row["t_us"][nops] = t * 1e6
    if not timed:
        print("vmembw      : not measured (CPU)", flush=True)
        return row
    lo, hi = VMEMBW_NOPS
    vregs = w.numel() / 1024
    row["ns_per_op_per_1024"] = (row["t_us"][hi] - row["t_us"][lo]) * 1e3 / (2 * (hi - lo)) / vregs
    print(f"vmembw slope: {row['ns_per_op_per_1024']:.4f} ns per 1024 int32 elements per op "
          f"[t{lo}={row['t_us'][lo]:.2f}us t{hi}={row['t_us'][hi]:.2f}us, {card}]", flush=True)
    return row


def main(argv=None) -> list[dict]:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--m", type=int, default=16)
    p.add_argument("--n", type=int, default=28672)
    p.add_argument("--k", type=int, default=8192)
    p.add_argument("--bn", type=int, default=2048)
    p.add_argument("--bk", type=int, default=2048)
    p.add_argument("--iters", type=int, default=200,
                   help="launches per timed CUDA graph (at least)")
    p.add_argument("--variants", type=str, default="prod,pfdirect,sep,sep1,int4")
    p.add_argument("--device", type=str, default=None,
                   help="cuda (default) or cpu (plain versions, nothing timed)")
    args = p.parse_args(argv)
    dev = resolve_device(args.device)
    m, n, k, g = args.m, args.n, args.k, G
    bm = max(16, m)
    variants = args.variants.split(",")
    unknown = sorted(set(variants) - set(ORDER))
    if unknown:
        p.error(f"unknown variants {unknown}; known: {','.join(ORDER)}")
    timed = dev.type == "cuda"
    card = ""
    if timed:
        from flute_tpu_torch.utils.benchmark import bench_op, cold_copies

        torch.backends.cuda.matmul.allow_tf32 = False
        card = card_label()
        print(f"kernel lab 2 on {card}: M={m} N={n} K={k} bk={args.bk} g={g}", flush=True)
    inp = make_inputs(m, n, k, g, device=dev, w3="w3wide" in variants)

    rows = []
    for name in ORDER:
        if name not in variants:
            continue
        if name == "vmembw":
            rows.append(run_vmembw(dev, timed, card))
            continue
        weights = operands(name, inp)
        got = run_variant(name, inp, weights, bm, args.bn, args.bk, g).float()
        want = oracle(name, inp)
        rel = float((got - want).abs().max() / want.abs().max())
        del got, want
        t = None
        if timed:
            copies = [clone_weights(weights)
                      for _ in range(cold_copies(weight_bytes(weights)))]
            t = bench_op(lambda *ws, name=name: run_variant(name, inp, ws, bm, args.bn, args.bk, g),
                         copies, min_launches=args.iters)
            del copies
        row = report(name, t, gemm_bytes(m, n, k, 3 if name == "w3wide" else BITS, g), card)
        row["rel"] = rel
        print(f"   rel={rel:.2e}", flush=True)
        rows.append(row)
    return rows


if __name__ == "__main__":
    main()
