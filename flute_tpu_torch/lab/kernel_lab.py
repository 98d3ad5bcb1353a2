"""The Hopper kernel lab, counterpart of ``scripts/kernel_lab.py``: time the
dequantization strategies of the LUT-GEMM on the card.

    python -m flute_tpu_torch.lab.kernel_lab --variants floor,unpack,gather16
    python -m flute_tpu_torch.lab.kernel_lab --device cpu --n 256 --k 512 --bn 128 --bk 256

Variants (the names of the JAX lab's ``main``):

  floor        L1: the packed words read as bf16 bit patterns (tiled, then
               bitcast): the pipeline and memory floor a real dequant can
               approach. On the lab's tensor-core loop at every g, where the
               words are the B registers as they stand: the loop's staging
               alone. Real planes give non-finite outputs; only timed.
  unpack       L2: shifts and masks only, the codes used as bit patterns.
               On the lab's tensor-core loop at every g: floor's staging plus
               the unpack of each 4-bit pair field, with no lookup.
  gather16     L3: the reference dequantization, x split in even/odd K.
  g8_full, g8_nochain, g8_wrap, g8_noscale, g8_bare
               L4: the 8-entry lookup with or without the group select
               (chain), the scale, and the v5e's index wrap, on the lab's
               tensor-core loop (``csrc/lab_mma.cuh``).
  g8_repeat, g8_groupacc
               L5: scales tiled per K block, or per-group sums times s.
  g8_hoist, g8_hoist_ga
               L6: L5 with both table halves read for every code, on the
               lab's tensor-core loop (as L1-L5).
  gather8      K2, the package's plane kernel (``lut_qgemm``).
  pairlut      K4, ``lut_qgemm`` with ``lut_mode="pair_lut"``.

Each variant's time comes from ``utils/benchmark.py::bench_cycled`` (CUDA
events over a CUDA graph of at least ``--iters`` launches, cycling copies of the
planes and scales past the L2 cache). ``report`` counts the bytes as the JAX
lab does (planes, scales, x and y) and takes the share of the H100's
3.35 TB/s. ``rel`` (largest error over the largest output, against
``lut_qgemm_reference``) is printed where the JAX lab prints it. On the CPU
(``--device cpu``) the plain versions run and nothing is timed.
"""

from __future__ import annotations

import argparse
import subprocess

import numpy as np
import torch

from flute_tpu_torch import packing
from flute_tpu_torch.device import resolve_device
from flute_tpu_torch.lab import ops
from flute_tpu_torch.ops import lut_gemm
from flute_tpu_torch.ops.kernel_config import KernelConfig
from flute_tpu_torch.quantize import nf

HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
BITS = 4  # the lab's one 4-bit plane

# lab variant -> (lab function, its keyword flags)
VARIANTS = {
    "floor": ("floor", {}),
    "unpack": ("unpack_only", {}),
    "gather16": ("gather16", {}),
    "g8_full": ("g8_ablate", dict(chain=True, scale=True, wrap=False)),
    "g8_nochain": ("g8_ablate", dict(chain=False, scale=True, wrap=False)),
    "g8_wrap": ("g8_ablate", dict(chain=False, scale=True, wrap=True)),
    "g8_noscale": ("g8_ablate", dict(chain=True, scale=False, wrap=False)),
    "g8_bare": ("g8_ablate", dict(chain=False, scale=False, wrap=True)),
    "g8_repeat": ("g8_rs", dict(scale_mode="repeat")),
    "g8_groupacc": ("g8_rs", dict(scale_mode="group_acc")),
    "g8_hoist": ("g8_hoist", dict(scale_mode="repeat")),
    "g8_hoist_ga": ("g8_hoist", dict(scale_mode="group_acc")),
}
# the package's kernels the JAX lab times beside its own
PACKAGE_VARIANTS = {"gather8": "gather8", "pairlut": "pair_lut"}
# the JAX lab's order of variants in main()
ORDER = ("gather8", "floor", "unpack", "gather16", "g8_full", "g8_nochain", "g8_wrap",
         "g8_noscale", "g8_bare", "g8_repeat", "g8_groupacc", "pairlut", "g8_hoist",
         "g8_hoist_ga")
# where the JAX lab prints rel (against the reference), when it has one
REL_PRINTED = ("gather8", "gather16", "g8_repeat", "g8_groupacc", "g8_hoist", "g8_hoist_ga")


def make_inputs(m, n, k, bits, g, device=None):
    """The JAX lab's inputs from ``default_rng(0)``: codes ``[K, N]`` (numpy),
    the packed planes, bf16 scales ``[K/g, N]`` in [0.5, 1.5), the NF table
    (float32) and a standard-normal bf16 ``x`` ``[M, K]``, on ``device``."""
    dev = resolve_device(device)
    rng = np.random.default_rng(0)
    codes = rng.integers(0, 2**bits, size=(k, n), dtype=np.int32)
    planes = [torch.from_numpy(p).to(dev) for p in packing.pack_np(codes, bits)]
    scales = torch.from_numpy(rng.uniform(0.5, 1.5, (k // g, n)).astype(np.float32))
    table = torch.from_numpy(nf.nf_values(bits)).to(dev)
    x = torch.from_numpy(rng.standard_normal((m, k)).astype(np.float32))
    return codes, planes, scales.to(dev, torch.bfloat16), table, x.to(dev, torch.bfloat16)


def report(name, t, planes, scales, x, m, n, card="") -> dict:
    """Print and return one variant's row; ``t`` is seconds per call (None:
    not measured). The bytes are the JAX lab's: planes, scales, x, y."""
    byts = sum(p.numel() * 4 for p in planes) + scales.numel() * 2 + x.numel() * 2 + m * n * 2
    row = dict(name=name, bytes=byts, us=None, gbps=None, share_of_hbm=None)
    if t is None:
        print(f"{name:14s}: not measured (CPU)", flush=True)
        return row
    gbps = byts / t / 1e9
    row.update(us=t * 1e6, gbps=gbps, share_of_hbm=gbps * 1e9 / HBM_BYTES_PER_S)
    print(f"{name:14s}: {t * 1e6:8.1f} us  {gbps:7.1f} GB/s "
          f"({100 * row['share_of_hbm']:5.1f}% of 3.35 TB/s{', ' + card if card else ''})",
          flush=True)
    return row


def card_label() -> str:
    """The card's name and power limit as nvidia-smi reports them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    except (OSError, subprocess.CalledProcessError, IndexError):
        out = f"{torch.cuda.get_device_name(0)}, power limit not read"
    return out


def run_variant(name, x, planes, scales, table, bm, bn, bk, g, pair_values=None):
    """Variant ``name`` of the lab on ``x``'s device. ``pairlut`` takes the
    joint table that ``lut_qgemm`` would build from ``table``, when given
    it already built."""
    if name in PACKAGE_VARIANTS:
        cfg = KernelConfig(block_m=bm, block_n=bn, block_k=bk, lut_mode=PACKAGE_VARIANTS[name])
        return lut_gemm.lut_qgemm(x, planes, scales, table, num_bits=BITS, config=cfg,
                                  pair_values=pair_values if name == "pairlut" else None)
    fn, flags = VARIANTS[name]
    return ops.run(fn, x, planes, scales, table, bm, bn, bk, g, **flags)


def main(argv=None) -> list[dict]:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--m", type=int, default=16)
    p.add_argument("--n", type=int, default=28672)
    p.add_argument("--k", type=int, default=8192)
    p.add_argument("--bn", type=int, default=2048)
    p.add_argument("--bk", type=int, default=1024)
    p.add_argument("--iters", type=int, default=100,
                   help="launches per timed CUDA graph (at least)")
    p.add_argument("--variants", type=str, default="gather8,floor,unpack,gather16")
    p.add_argument("--device", type=str, default=None,
                   help="cuda (default) or cpu (plain versions, nothing timed)")
    args = p.parse_args(argv)
    dev = resolve_device(args.device)
    m, n, k, g = args.m, args.n, args.k, 64
    bm = max(16, m)
    variants = args.variants.split(",")
    unknown = sorted(set(variants) - set(ORDER))
    if unknown:
        p.error(f"unknown variants {unknown}; known: {','.join(ORDER)}")
    codes, planes, scales, table, x = make_inputs(m, n, k, BITS, g, device=dev)
    timed = dev.type == "cuda"
    card = ""
    if timed:
        from flute_tpu_torch.utils.benchmark import bench_cycled, cold_copies

        torch.backends.cuda.matmul.allow_tf32 = False
        card = card_label()
        print(f"kernel lab on {card}: M={m} N={n} K={k} bk={args.bk} g={g}", flush=True)
        wbytes = sum(p_.numel() * 4 for p_ in planes) + scales.numel() * 2
        copies = [([p_.clone() for p_ in planes], scales.clone())
                  for _ in range(cold_copies(wbytes))]

    want = None
    if {"gather8", "gather16"} & set(variants):
        want = lut_gemm.lut_qgemm_reference(
            x, torch.from_numpy(codes).to(dev), scales, table).float()

    # pairlut's joint table, built once outside the timed calls (the JAX lab's
    # jit folds it into a constant once)
    pair_values = lut_gemm.separable_pair_values(table, BITS)

    rows = []
    for name in ORDER:
        if name not in variants:
            continue

        def f(pl, s, name=name):
            return run_variant(name, x, pl, s, table, bm, args.bn, args.bk, g, pair_values)

        got = f(planes, scales).float()
        t = bench_cycled(f, copies, min_launches=args.iters) if timed else None
        row = report(name, t, planes, scales, x, m, n, card)
        if want is not None and name in REL_PRINTED:
            row["rel"] = float((got - want).abs().max() / want.abs().max())
            print(f"   {name} rel={row['rel']:.2e}", flush=True)
        rows.append(row)
    return rows


if __name__ == "__main__":
    main()
