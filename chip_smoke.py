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
     and spill; for each instantiation of the lab's tensor-core loop its
     registers, spill (none allowed), dynamic shared memory and blocks per
     SM (the CUDA occupancy calculator), among them L1's WordDecoder,
     L11's PairTableDecoder<4> (kernel_lab2.cu's copy of L5's), L8's
     PairTileDecoder and L12's W3PairDecoder; for each tensor-core
     instantiation of K1-K4 (the loop at 1, 2 and 4 m16 tiles a warp and
     the wide-M kernel, bf16 and f16; K3 with a chunk's scales once per
     field and with the per-field cache, at chunk 256 and 512; K1-K4 on
     the wide-M kernel's mid route at row tiles of 16, 32, 48 and 64, K3
     in both scale modes, K4 at 2, 3 and 4 bits) its registers, shared
     memory and blocks per SM (the mid route's at least the 2 it is sized
     for, K3's with the per-field cache 1), each wide_m_kernel's registers
     and spill from ptxas (no wgmma serialized; none spilled by K3's mid
     route with a chunk's scales, its served mode), and K4's wide ring the
     size of K2's;
  2. hold each kernel against its plain PyTorch version on the card:
     the LUT-GEMMs at the Llama-3.1-8B decoder-layer shapes (K1 also at
     Gemma-2-9B's), M in {1, 8, 128, 512}, bf16 and f16 (relative Frobenius
     error under 1.1e-2 / 2e-3): K1, K2 at 4, 3 and 2 bits with a general
     table, K3, K4 at 4, 3 and 2 bits with a general joint table; identity
     input bit-exact against the oracle (K1 and K2 in bf16/f16/f32 at chunk
     128 and 256, K3 at 256 and 512, K4 in bf16/f16 at 128 and 256) and
     unpack_via_kernel round-tripping the codes; lut_mode="pair_lut" without
     pair_values launching K4 once and K2 not at all; qgemm_hadamard
     (rotation 512) against its plain version; K5 at B=8, blocks of 16,
     ragged lengths 0..4096 in a table 3 blocks wider than the longest, and
     K6 at T in {5, 64, 256} over 0 and 1024 cached positions, each with
     softcap, window and both, bf16 and f16, at Llama-3.1-8B's heads (32/8,
     D=128) and at Gemma-2-9B's (16/8, D=256, also with its softcap 50 and
     window 4096) (max error relative to the largest output < 1.1e-2); K1-K6
     called twice give the same bits (split-K, K5's spans and K6 add in a
     fixed order), rows 0 and M-1 of each K1-K4 call at M > 1 have the bits
     of the one-row call on that row (the split does not follow M), and each
     K5 sequence called alone, with a table just wide enough for it, has
     the bits it has in the batch. K1, K2 and K3 run the tensor-core loop in
     bf16/f16 and their SIMT kernel in f32; each case, and each kernel line,
     names the path it ran. K1 at M=512 is also timed, in turns, with the
     split a planner that follows M would take: what a row's independence
     of M costs at prefill. K5 is timed at lengths 1024 and 4096 (Llama's
     heads with its span and at spans of 128, 256 and 512; Gemma-2's with
     softcap 50 and window 4096); K6 at T=256 over 1024 (both head shapes)
     and at the served pool-prefill chunk (T=32 over 32 cached). Time each
     kernel, its plain version and a yardstick that the port never calls
     (LUT-GEMMs: a torch.matmul on the pre-dequantized weight; K5/K6: one
     scaled_dot_product_attention on K/V gathered beforehand, without a
     softcap, which it does not take), L2-cold, in CUDA graphs
     (bench_cycled). K1 at Llama-3.1-8B's qkv (M=8, bf16) is also timed with
     bench_op, the JAX package's form (the same inputs every call, so
     L2-warm), beside bench_cycled, and bench_op's K1 launches are counted
     (1 warm-up + 200). The sweep of the tensor-core routes (the decode
     loop, the wide-M kernel and its mid route) at one Llama-3.1-8B layer
     in bf16: K1 and K2 W4 at M in {8, 16, 32, 40, 48, 64, 96, 128}, K4 W4
     and K3 at {16, 32, 40, 64, 96, 128}, on the loop and the mid route and
     from 64 on the wide-M kernel, at 192 and 256 on the mid route and the
     wide-M kernel, and at 2047 on the wide-M kernel; K2 W2 at 8, 16, 32,
     40 and 64; K4 W3 and W2 at 40, 64, 128 and 2047; at every point its
     routes timed beside the bf16 matmul and the bound, the same bits on
     all, identity exact on each, rows 0 and M-1 the one-row call's, a
     repeat call's bits, the plain version's threshold; the plan's two
     bounds (kernel_config.MID_MIN_M, WIDE_MIN_M) held to the sweep for
     every kernel and bit width (at no point a route faster than the
     plan's by more than 5%); then the card tests
     of K3 and K4 on the wide route and of K1-K4 on the mid route
     (tests/test_torch_cuda.py -k "k3_k4_wide or k1_k2_mid or k3_k4_mid",
     in a child process; the count passed is reported);
  2b. the Hopper lab (L1-L6 of csrc/kernel_lab.cu): its entry point,
     flute_tpu_torch.lab.kernel_lab.main, runs every variant at the JAX lab's
     reference shape (M16 N28672 K8192, bk 1024, g64, bf16) with the launch
     counts set to 0 just before and read just after (each function exactly
     its variants' calls: a check call, bench_cycled's first calls and its graph's
     launches; gather8 and pairlut as many of K2 and K4, no other package
     kernel), and no lab kernel launched in phases 3-5; L1 (floor) and L2
     (unpack_only), at every g (they read no scales), L3 (gather16), L4
     (g8_ablate, its five variants), L5 (g8_rs, both scale modes) and L6
     (g8_hoist) run the lab's tensor-core loop (path "mma", each function's
     path recorded); one mma.sync of bf16 subnormal operands keeps them,
     their f32 products and sums of 16 subnormal products exactly (the
     probe, before L2's checks, so that a flush is named as the tensor
     core's); then each of its 12 cases is held
     against its plain version on the card at that shape and at bk 256 on a
     narrow N (relative Frobenius error under 1.1e-2; floor on planes
     masked to finite bf16 halves; unpack_only, whose operand is subnormal,
     to 1.1e-2 of the largest output) and with an identity x bit for bit
     (floor also at bk 1024, where its x map is not the identity), the
     loop's cases also called twice for the same bits, and at g = 2 (floor
     and unpack_only on the loop, the others on their SIMT kernel); L5 and L3 (tables in
     shared memory) give the bits of their register twins L6 and L4 full;
     the plain versions and a yardstick (one bf16 torch.matmul of x on the
     pre-dequantized [8192, 28672] weight) are timed beside the kernels,
     L2-cold, in CUDA graphs, and each loop variant's time over floor's
     (the loop's staging floor) is printed per decode instruction a B
     register, beside floor timed at bk 256 (its x map the identity) and
     on planes masked to L2's operand statistics;
  2c. the lab's second half (L7-L12 of csrc/kernel_lab2.cu): its entry
     point, flute_tpu_torch.lab.kernel_lab2.main, runs every variant at the
     JAX lab2's default shape (M16 N28672 K8192, bn 2048, bk 2048, g64,
     bf16) with the launch counts set to 0 just before and read just after
     (each function exactly its variants' calls, sep for sep and sep1, L7
     2 x 4002; prod as many of K2, no other package kernel, no L1-L6), and
     no L7-L12 kernel launched in phases 3-5; L8 (pfdirect, on L11's
     decoder with its operand through a tile in shared memory), L9 (sep
     and sep1), L10 (int4), L11 (slabstream, on L5 group_acc's decoder)
     and L12 (w3wide, 24 word rows a chunk) run the lab's tensor-core loop
     (path "mma"), L7 SIMT; then the six GEMM
     functions (seven cases with sep1) are held against their plain
     versions on the card at that shape and at bk 256 on a narrow N
     (relative Frobenius error under 1.1e-2) and with an identity x bit for
     bit (the sign of a zero aside), the loop's cases also called twice for
     the same bits, L11 to L5 group_acc's bits and L8 to L11's on the same
     inputs, L7 bit
     for bit at nops 2 and 8; the
     plain versions and a yardstick (one bf16 torch.matmul on the
     pre-dequantized weight: phase 2b's for the 4-bit cases, its own for
     L12's 3-bit weight) are timed beside the kernels, L2-cold, in CUDA
     graphs;
  3. logits of a 2-layer model at Llama-3.1-8B widths (fused) quantized at
     w4sym, W3 (w3wide) and general-table W4 (plane), with every projection
     a HIGGS W4 layer (rotation 512, then K4), and of a 2-layer Gemma-2 at
     Gemma-2-9B widths (w4sym, fused): one prefill and one decode step on
     the card against the same params on the CPU plain path (max error
     relative to the largest logit < 1.1e-2); the W3 and the HIGGS models
     saved with save_quantized and loaded back give the same logits bit for
     bit;
  4. serve 8 ragged prompts for 16 new tokens through Engine.generate on
     the full 32-layer Llama-3.1-8B-width model (random weights from a seed,
     quantized on the card) at w4sym, W3 and general W4, each run through
     exactly its kernel: steps x 32 layers x 4 launches, none of the others;
     then through PagedEngine: the w4sym and the W3 models with dense
     prefill, each held to its Engine's tokens and first-token logits, and
     the HIGGS-W4 model with pool prefill, 12 requests (4 sharing a
     32-token prefix, 2 sampled) on a pool small enough that admission
     waits, with exact launch counts: K4 forward calls x 32 x 4, K5 decode
     steps x 32, K6 prefill chunks x 32, K1-K3 none; in every paged run the
     LUT-GEMM launches on the mid route and on the wide-M kernel are
     exactly those the plan gives each forward's rows (the admissions of
     17-64 rows on the mid route: K1, K3 and K4; a decode step's 8 rows
     and the short suffixes after a prefix hit on the loop). Every engine
     runs its decode step as a CUDA graph captured at its first decode
     step and replayed after it; the wrappers' launch
     counts add each replay's launches (serving/graph.py), so the counts
     above count launches that ran. One replayed step of each engine is
     held bit for bit against the eager step on the same state (launches
     of that eager step are not counted). The decode-step profiles
     (torch.profiler over graphed steps that end on the host as a served
     step does, CUDA events over back-to-back replays for the device time
     per step, one profiled eager step for the dtype conversions and, where
     the profiler does not show replayed kernels one by one, for the split
     by kernel) report each served model's LUT-GEMM (K1, K2, K3 or K4, and
     the loop's split-K reduction) in ms per decode step, K5's (span and
     merge kernels) per decode step and per call, K6's in a step that
     admits 8 requests, the median and quickest host-clock step and the
     idle share (1 - device ms per replay / median step), and fail if a
     decode step converts the dtype of a tensor of 2^20 elements or more
     (the lm_head and the KV cache are multiplied in 16 bits with f32
     results, never copied to f32); the HIGGS PagedEngine's step that
     admits 8 requests reports K4's ms (the mid route's among them) and
     the prefill ms per admission. Each Engine's 512-row prefill runs its
     LUT-GEMM on the wide-M kernel (exact wide launches: 128 of K1's, K2's
     and K3's); the HIGGS-W4 model is also served once through Engine
     (128 of K4's launches on the wide-M kernel, the rest on the loop; its
     greedy tokens held to the paged engine's before near ties, its
     first-token logits within 0.25); the prefills of w4sym (K1), W3 (K3)
     and HIGGS-W4 (K4) are profiled on both routes (the kernel's device ms
     and share of the prefill's busy time; the same logits bits);
  5. Gemma-2-9B at full width and depth (42 layers, w4sym, g64, fused, random
     weights from a seed, quantized on the card): the 8 prompts through
     Engine (batch 8, max_len 256), a 4160-token prompt through a batch-1
     Engine (max_len 4352), then all nine through PagedEngine with pool
     prefill (blocks of 16, 8 slots, 400 blocks, max_len 4352): the long
     request runs the sliding layers' window of 4096 in K6 and in K5, whose
     17 spans the merge kernel adds; exact launches in each run (K1 forward
     calls x 42 x 4, K5 decode steps x 42, K6 prefill chunks x 42); paged
     tokens held to the Engines' before their first near tie, first-token
     logits within 0.25 of theirs (the paged-against-dense limit of phase
     4); each engine's replayed step bit-identical to its eager step; the
     Engine's decode profile as in phase 4;
  6. continuous batching and speculative decoding on Llama-3.1-8B at full
     width and depth (phase 4's random weights, seed 0): the w4sym target
     (K1) and a W2 draft of the same weights (general 2-bit table, K2),
     quantized on the card. A verify's M = 40 rows of every layer-0
     projection (the mid route) have the bits of the M = 8 call (the loop;
     K1 and K2; both timed per layer at M = 8 and 40). Every continuous and
     speculative run checks its mid-route launches exactly (each forward's
     rows through the plan). ContinuousBatchingEngine: 12 requests into 8
     slots, max_len 512, chunked prefill (64; one prompt of 100 tokens), a
     prefix store of blocks of 16 that three requests hit on the first 32
     tokens of a fourth, 2 sampled; greedy tokens held to Engine's (phase
     4's trajectory, and a batch-2 Engine for the other two) before near
     ties, exact K1 launches, one replayed step bit for bit against the
     eager step; its dense cache's attention timed alone. SpeculativeEngine
     (dense caches), batch 8, k = 4, the 8 prompts, with the self-draft and
     the W2 draft: tokens held to Engine's before near ties, exact K1/K2
     launches, the graphed draft (third call) and verify (second call) bit
     for bit against the eager steps. PagedSpeculativeEngine as
     scripts/bench_serving.py:97-125 runs it (batch 8, k = 4, blocks of 32,
     max_len 512, 16-token prompts, 248 tokens a request for the
     self-draft, about 48 rounds; 56 for the W2 draft), then the self-draft
     with pool prefill: tokens held to PagedEngine's greedy tokens (T = 1,
     K5) before near ties, exact K6 (verify rounds plus pool-prefill chunks,
     x 32) and K1/K2 launches, each graphed draft and verify replay bit for
     bit against its eager step, no block in use at the end. Each engine
     reports tok/s and ms per round (per step), the graphs' device ms per
     replay, the idle share (1 - device busy / wall of profiled rounds, or
     of the continuous engine's replay over its median step), acceptance
     and bonus tokens, and K6's µs per served verify call with its bound;
  7. the quantized lm_head, the HTTP server and perplexity on Llama-3.1-8B
     at full width and depth (phase 4's random weights, seed 0; w4sym, g64,
     fused, quantized on the card with the head): K1 at the two quantized
     heads (Llama's [129024, 4096], Gemma-2-9B's tied [256000, 3584]) at
     M = 1 and 8 and at the perplexity prefill (M = 2047, one layer), held
     against its plain version (relative Frobenius error under 1.1e-2),
     rows 0 and M-1 to the one-row call's bits, timed beside its plain
     version and a yardstick (matmul_f32 on the dense bf16 head, the call a
     step makes with a dense head; a bf16 matmul on the dequantized layer);
     the quantized-head Engine (8 prompts, 24 tokens, exact launches: 32 x 4
     + 1 per forward; its decode profile and dtype-copy check) with first
     logits within 0.15 of the largest dense-head logit (phase 4's); then
     ContinuousBatchingEngine (8 slots, max_len 512) run directly and behind
     the port's serve(): /health, /v1/models, the 8 prompts as 8 concurrent
     greedy requests held to Engine's before near ties, one request plain,
     as NDJSON and as SSE (bit for bit the same), n = 2 sampled choices
     equal to direct submissions with seeds s and s + 1, chat equal to the
     templated completion, malformed requests 400, /metrics counting the
     requests and tokens, exact K1 launches, time to first token and ms per
     token streamed against the engine's median step, the idle share from
     profiling.device_trace over one streamed request (the trace file must
     name K1); PagedEngine (K1, K5) behind the server for 12 tokens a
     request (cut from 24 to keep the phase short), held to Engine before
     near ties, exact launches, no block in use at the end; perplexity of
     4096 tokens from a numpy seed in two windows of 2048, quantized at
     batch 1 and 2 (within 1e-3), with the quantized head, and dense bf16
     (the quantized ones within 5%), exact K1 launches, seconds per window.
  8. the CLI (flute_tpu_torch.integrations.cli) from an HF Llama directory
     at Llama-3.1-8B widths cut to 4 layers (bf16, 3.85 GB, written from a
     seed by the port's safetensors writer, under build/phase8/, removed at
     the end): quantize at 4 bits (w4sym, K1) and 3 bits (wide, K3), in
     memory and streaming, every .npy file of the two byte-equal; generate
     from each, tokens equal to an Engine built on the loaded params,
     exact launches; generate --retune (the tuner at M = 1) with the same
     tokens; the tuner at the fused projections' shapes (qkv, o, gate_up,
     down) at M = 8 and 40: each candidate launch's time, its checks and
     its bits against the planner's, the winner against the planner's;
     calibrate (NFL, batch 2 x 512, 8 steps over one seeded batch, lr
     1e-3): the loss falls, the checkpoint is w4sym and serves on K1;
     bnb NF4 (nested absmax) and FP4 and reference-FLUTE W4, W3 and HIGGS
     checkpoints of one layer, imported and served (K2, K2 at 3 bits, K4)
     within 1.1e-2 of the dense model of the same weights, exact launches;
     serve's three engines (continuous, paged with pool prefill, paged
     speculative with the 3-bit checkpoint as draft) behind the HTTP
     server, one streamed request each: tokens and launches those of the
     engine driven directly, time to first token.
  9. tensor and pipeline parallelism and the host packer: K1 at one
     rank's shard of a Llama-3.1-8B layer at tp = 2 and 4 (M = 8), K5 and
     K6 at the local heads at phase 2's shapes and at the shapes the TP
     engines give them (the served decode, the pool-prefill chunks, the
     verify), each against its plain version and timed; phase 4's model
     through a checkpoint into gloo worlds of 2 and 4 ranks on the one
     card (Engine, PagedEngine with pool prefill, ContinuousBatchingEngine
     and PagedSpeculativeEngine at tp = 2; Engine at tp = 4; each also
     Engine at 2 layers) against the same engines at tp = 1: the ranks
     bit-identical, launches and all-reduces exact, each forward's logits
     within the bf16 threshold or twice another summation order's (o and
     down summed in K slices by torch.matmul at tp = 1), the larger, at
     most 0.1; PipelinedModel in 2 stages against llama.forward; the
     native packer against the numpy packers.

Prints a {"kernels": [...]} line, then as its last line
{"ok": true, "device": {...}}. Writes the full results to
chiprun_out/chip_smoke.json. Needs a CUDA device; exits non-zero without one.
"""

import contextlib
import dataclasses
import filecmp
import functools
import gc
import io
import json
import math
import os
import re
import shutil
import signal
import subprocess
import sys
import tempfile
import threading
import time
import unittest.mock
import urllib.error
import urllib.request

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
# one Gemma-2-9B decoder layer, fused qkv and gate_up (K = 3584 is 14 chunks
# of 256)
GEMMA2_SHAPES = [
    ("qkv", 8192, 3584),
    ("o", 3584, 4096),
    ("gate_up", 28672, 3584),
    ("down", 3584, 14336),
]
MODEL_SHAPES = {"llama31_8b": LAYER_SHAPES, "gemma2_9b": GEMMA2_SHAPES}
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
# phase-2 cases: (kernel id, bits, M values that are timed, dtypes timed,
# the model whose layer shapes it runs; every M and both dtypes are
# checked). K2 and K4 read the plane layout; K4 looks its weights up in a
# joint pair table.
KERNEL_CASES = [
    ("K1", 4, M_CASES, ("bfloat16", "float16"), "llama31_8b"),
    ("K2", 4, M_CASES, ("bfloat16", "float16"), "llama31_8b"),
    ("K2", 3, (1, 8, 512), ("bfloat16", "float16"), "llama31_8b"),
    ("K2", 2, (1, 8, 512), ("bfloat16", "float16"), "llama31_8b"),
    ("K3", 3, M_CASES, ("bfloat16", "float16"), "llama31_8b"),
    ("K4", 4, (1, 8, 512), ("bfloat16",), "llama31_8b"),
    ("K4", 3, (1, 8, 512), ("bfloat16",), "llama31_8b"),
    ("K4", 2, (1, 8, 512), ("bfloat16",), "llama31_8b"),
    ("K1", 4, (1, 8, 512), ("bfloat16",), "gemma2_9b"),
]
LAYOUT = {"K1": "w4sym", "K2": "plane", "K3": "w3wide", "K4": "plane"}
HIGGS_HADAMARD = 512  # the rotation of the HIGGS layers (phases 2-4)
# served models: name -> (quantize_model arguments, kernel id)
SERVED = {
    "w4sym": (dict(num_bits=4), "K1"),
    "w3wide": (dict(num_bits=3), "K3"),
    "w4_general": (dict(num_bits=4, symmetric=False), "K2"),
}

# the bits of phase 6's models by kernel layout: the w4sym target (K1) and
# the W2 draft (K2)
LAYOUT_BITS = {"w4sym": 4, "plane": 2}
# phase 6, as scripts/bench_serving.py:97-200 runs it: k proposals per
# round, blocks of 32, max_len 512
SPEC_K = 4
SPEC_ROUNDS = 48  # scripts/bench_serving.py's --steps
SPEC_BLOCK = 32
SPEC_MAX_LEN = 512
# the self-draft's budget: bench_serving.py's (k + 1) x steps + 8; the W2
# draft (acceptance near 0 on random weights) steps + 8
SPEC_BUDGETS = {"self-draft": (SPEC_K + 1) * SPEC_ROUNDS + 8, "W2 draft": SPEC_ROUNDS + 8}


def log(*a):
    print(*a, flush=True)


def header(title, t_start):
    """A phase's heading, with the seconds since the run began."""
    log(f"== {title} ({time.perf_counter() - t_start:.0f} s in)")


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


def kernel_path(kid, dtype, bits, chunk=256, m=1):
    """The kernel a LUT-GEMM case runs: "mma" (the tensor-core loop),
    "wide" (the wide-M kernel on warpgroup MMA, K1-K4 from
    kernel_config.WIDE_MIN_M rows), "mid" (its mid route, from
    kernel_config.MID_MIN_M rows below that) or "simt" (the skeleton of
    lut_gemm_common.cuh), as the wrapper picks it."""
    from flute_tpu_torch.ops import kernel_config, lut_gemm

    path = "mma" if kid == "K4" else lut_gemm.lut_path(dtype, bits, chunk, LAYOUT[kid])
    route = kernel_config.mma_route(m, bits, chunk, ROUTE_LAYOUT[kid], GROUP)
    return route if path == "mma" and route != "loop" else path


def check_rows(kid, label, x, y, call):
    """Rows 0 and M-1 of ``y`` (the call on all of ``x``) have the bits of
    the one-row call on that row: a row's result does not depend on M."""
    for i in sorted({0, x.shape[0] - 1}):
        row = call(x[i:i + 1])
        if not torch.equal(row.view(torch.int16), y[i:i + 1].view(torch.int16)):
            raise AssertionError(f"{kid} {label}: row {i} of the M={x.shape[0]} call differs "
                                 "from the one-row call")


def phase_kernel(dev, results):
    from flute_tpu_torch import packing
    from flute_tpu_torch.ops import lut_gemm
    from flute_tpu_torch.ops.kernel_config import KernelConfig
    from flute_tpu_torch.utils.benchmark import bench_cycled, cold_copies

    rng = np.random.default_rng(0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    cases = []
    for kid, bits, timed, timed_dtypes, model in KERNEL_CASES:
        layout = LAYOUT[kid]
        log(f"  {kid} ({layout}{', joint pair table' if kid == 'K4' else ''}, {bits}-bit, "
            f"{model} layer)")
        for name, n, k in MODEL_SHAPES[model]:
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
                    label = f"{bits}-bit {name} M={m} {dtype}"
                    # split-K adds its partial sums in a fixed order
                    again = lut_gemm.lut_qgemm(x, planes, scales, table, **kw)
                    if not torch.equal(again.view(torch.int16), y.view(torch.int16)):
                        raise AssertionError(f"{kid} {label}: a repeat call gave other bits")
                    if m > 1:
                        check_rows(kid, label, x, y, lambda xr: lut_gemm.lut_qgemm(
                            xr, planes, scales, table, **kw))
                    torch.cuda.synchronize()
                    err = rel_err(y, y_plain)
                    max_abs = float((y.float() - y_plain.float()).abs().max())
                    if not err < THRESHOLDS[dtype]:
                        raise AssertionError(f"{kid} {bits}-bit {name} M={m} {dtype}: rel err {err}")
                    case = dict(kernel=kid, model=model, bits=bits, name=name, n=n, k=k, m=m,
                                dtype=str(dtype).split(".")[-1], rel_err=err,
                                max_abs_err=max_abs, path=kernel_path(kid, dtype, bits, m=m))
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

                    t_k = bench_cycled(kern, args)
                    t_p = bench_cycled(plain, args[:2], min_launches=2)
                    t_l = bench_cycled(library, [(w,) for w in deq_c])
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
                        f"    {name:8s} M={m:<4d} {case['dtype']:9s} {case['path']:4s} "
                        f"err={err:.2e} "
                        f"kernel {case['us']:9.1f} us  bound {case['bound_us']:7.1f} us "
                        f"({case['bound_by']}, {100 * case['share_of_bound']:5.1f}%)  "
                        f"plain {case['plain_us']:9.1f} us  matmul {case['library_us']:7.1f} us"
                    )
                del args, deq_c, deq, planes
    results["kernel_cases"] = cases
    log("  K1-K4: every repeat call gave the same bits (fixed-order split-K), and rows 0 "
        "and M-1 of every call at M > 1 the bits of the one-row call (K1 at the Llama-3.1-8B "
        "and the Gemma-2-9B layer shapes)")
    time_split_cost(dev, rng, gen, results)
    check_identity(dev, rng, gen, results)
    check_pair_lut_routing(dev, rng, gen, results)
    check_qgemm_hadamard(dev, rng, gen, results)
    time_warm_and_cold(dev, results)
    wide_sweep(dev, results)
    time_k3_scale_modes(dev, results)
    results["wide_card_tests"] = wide_card_tests()
    return cases


def time_warm_and_cold(dev, results, m=8, iters=200):
    """K1 at Llama-3.1-8B's qkv (M=8, bf16) timed by both timers:
    ``bench_op`` (the JAX package's form, the same inputs every call, so the
    12.6 MB of planes and scales stay in the 50 MB L2) and ``bench_cycled``
    (copies past the L2, the timer of every kernel time in the kernels
    line). Warm and cold differ by design: no bound joins them. Checks that
    ``bench_op`` launched K1 once to warm up and ``iters`` times in its
    graph, and that its time is finite and positive."""
    from flute_tpu_torch.ops import lut_gemm
    from flute_tpu_torch.ops.kernel_config import KernelConfig
    from flute_tpu_torch.utils.benchmark import bench_cycled, bench_op, cold_copies

    gen = torch.Generator(device=dev)
    gen.manual_seed(21)
    _, n, k = LAYER_SHAPES[0]
    _, planes, scales, table = make_weight(np.random.default_rng(21), gen, "w4sym", 4, n, k,
                                           torch.bfloat16, dev)
    x = torch.randn((m, k), generator=gen, device=dev).to(torch.bfloat16)
    kw = dict(num_bits=4, layout="w4sym", config=KernelConfig(chunk=256))
    before = lut_gemm.LAUNCHES["w4sym"]
    warm = bench_op(lambda x_: lut_gemm.lut_qgemm(x_, planes, scales, table, **kw), x,
                    iters=iters)
    launched = lut_gemm.LAUNCHES["w4sym"] - before
    if launched != 1 + iters:
        raise AssertionError(f"bench_op launched K1 {launched} times, not 1 + {iters}")
    if not (math.isfinite(warm) and warm > 0):
        raise AssertionError(f"bench_op timed K1 at {warm} s")
    wbytes = sum(p.numel() * 4 for p in planes) + scales.numel() * scales.element_size()
    args = [([p.clone() for p in planes], scales.clone()) for _ in range(cold_copies(wbytes))]
    cold = bench_cycled(lambda p, s: lut_gemm.lut_qgemm(x, p, s, table, **kw), args)
    results["k1_qkv_warm_cold"] = dict(warm_us=warm * 1e6, cold_us=cold * 1e6,
                                       cold_over_warm=cold / warm, weight_bytes=wbytes,
                                       bench_op_launches=launched, iters=iters)
    log(f"  K1 qkv M={m} bf16 ({wbytes / 1e6:.1f} MB of planes and scales): bench_op "
        f"(JAX's form, L2-warm) {warm * 1e6:.2f} us, bench_cycled (L2-cold) {cold * 1e6:.2f} "
        f"us, cold/warm {cold / warm:.3f}; bench_op launched K1 1 + {iters} times")


def time_split_cost(dev, rng, gen, results, m=512, chunk=256):
    """What a split that does not follow M costs at the served prefill block
    (K1, bf16, M=512): each projection timed with mma_plan's split and with
    the split a planner that follows M would take (the smallest that fills
    the card counting M's row blocks too: one pass where they fill it), in
    turns, both held to the plain version."""
    from flute_tpu_torch.ops import kernel_config, lut_gemm
    from flute_tpu_torch.utils.benchmark import bench_cycled, cold_copies

    rows_out = []
    for name, n, k in LAYER_SHAPES:
        _, planes, scales, table = make_weight(rng, gen, "w4sym", 4, n, k, torch.bfloat16, dev)
        x = torch.randn((m, k), generator=gen, device=dev).bfloat16()
        fixed = kernel_config.mma_plan(m, n, k, chunk)
        cols, _, rows = fixed.grid
        nchunks = k // chunk
        splits = next(s for s in range(1, nchunks + 1) if nchunks % s == 0 and (
            cols * rows * s >= kernel_config.MMA_TARGET_BLOCKS or s == nchunks))
        follow = kernel_config.MmaPlan(m_tiles=fixed.m_tiles, splits=splits,
                                       grid=(cols, splits, rows))
        wbytes = planes[0].numel() * 4 + scales.numel() * 2
        args = [(planes[0].clone(), scales.clone()) for _ in range(cold_copies(wbytes))]
        want = lut_gemm.lut_qgemm_plain(x, planes, scales, table, num_bits=4, chunk=chunk,
                                        layout="w4sym")

        def call(p, s, plan):
            return lut_gemm._launch("w4sym", x, [p.data_ptr()], s, table, group_size=GROUP,
                                    chunk=chunk, plan=plan)

        for plan in (fixed, follow):
            err = rel_err(call(planes[0], scales, plan), want)
            if not err < THRESHOLDS[torch.bfloat16]:
                raise AssertionError(f"K1 {name} M={m} with {plan.splits} splits: rel err {err}")
        times = {"fixed": [], "follow": []}
        for which in ("follow", "fixed", "fixed", "follow"):
            plan = fixed if which == "fixed" else follow
            times[which].append(bench_cycled(lambda p, s, plan=plan: call(p, s, plan), args) * 1e6)
        def workspace(s):  # f32 partial sums written once and read once
            return 2 * 4 * m * n * s if s > 1 else 0

        row = dict(name=name, n=n, k=k, m=m, splits=fixed.splits, splits_following_m=splits,
                   workspace_bytes=workspace(fixed.splits) - workspace(splits),
                   us=min(times["fixed"]), us_following_m=min(times["follow"]))
        rows_out.append(row)
        log(f"    split cost {name:8s} M={m}: {fixed.splits:2d} splits {row['us']:8.1f} us, "
            f"{splits:2d} splits (following M) {row['us_following_m']:8.1f} us")
    total = sum(r["us"] for r in rows_out) - sum(r["us_following_m"] for r in rows_out)
    extra = sum(r["workspace_bytes"] for r in rows_out)
    log(f"  K1 at M={m}: the M-independent split costs {total:.1f} us per layer "
        f"({extra / 1e9:.3f} GB more workspace written and read, "
        f"{extra / HBM_BYTES_PER_S * 1e6:.1f} us of it at 3.35 TB/s)")
    results["split_cost"] = dict(rows=rows_out, us_per_layer=total, extra_bytes=extra)


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
    paths = {}
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
                    path = kernel_path(kid, dtype, bits, chunk)
                    paths.setdefault(kid, set()).add(f"{path} {str(dtype).split('.')[-1]}")
                    if not torch.equal(got.float(), want.float()):
                        raise AssertionError(f"identity not bit-exact: {kid} {bits}-bit {dtype} "
                                             f"chunk={chunk} ({path})")
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
    paths = {kid: sorted(p) for kid, p in paths.items()}
    log("  identity bit-exact (bf16/f16/f32; K1 and K2 at chunk 128/256, K1 with a "
        "mixed-sign table, K3 at 256/512; K4 in bf16/f16 at 2/3/4 bits, chunk 128/256); "
        f"unpack_via_kernel round-trips; paths {paths}")
    results["identity_bit_exact"] = True
    results["identity_paths"] = paths


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


# K5/K6: one decode batch at Llama-3.1-8B's attention widths, and at
# Gemma-2-9B's (D=256, 16/8 heads) with the options its layers pass: the
# softcap 50 everywhere and the window of 4096 on even layers
# phase 2's sweep of the LUT-GEMMs' routes on the tensor cores at one
# Llama-3.1-8B layer in bf16: (kernel id, bits, M). K1, K2, K3 and K4 at
# their widest tables (W4; K3 W3) from 8 or 16 to 128 rows on the decode
# loop, the wide-M kernel's mid route and (from 64) the wide-M kernel (the
# mid bound's crossover, the mid route against both), at 192 and 256 on
# the mid route and the wide-M kernel (the wide bound's crossover), and at
# 2047 on the wide-M kernel (the prefill regime); K2 W2 (phase 6's draft)
# at the verify's 40 rows and the mid crossover; K4 W3 and W2 at 40, 64,
# 128 and 2047. Points another point decides are not run: the wide-M
# kernel under 64 rows (3-4x slower than the loop there at every layout,
# PERF.md), the loop above 128, the mid route above 256, 512 rows (between
# 256 and 2047 the wide-M kernel won every earlier sweep).
MID_SWEEP_M = (16, 32, 40, 64, 96, 128)
ABOVE_M = (192, 256)
TOP_M = 2047
VERIFY_M = 8 * (SPEC_K + 1)  # the speculative verify's rows (phase 6)
SWEEP = (("K1", 4, (8, 16, 32, 40, 48, 64, 96, 128) + ABOVE_M + (TOP_M,)),
         ("K2", 4, (8, 16, 32, 40, 48, 64, 96, 128) + ABOVE_M + (TOP_M,)),
         ("K2", 2, (8, 16, 32, VERIFY_M, 64)),
         ("K4", 4, MID_SWEEP_M + ABOVE_M + (TOP_M,)), ("K3", 3, MID_SWEEP_M + ABOVE_M + (TOP_M,)),
         ("K4", 3, (VERIFY_M, 64, 128, TOP_M)), ("K4", 2, (VERIFY_M, 64, 128, TOP_M)))
ROUTES = ("loop", "mid", "wide")
# the routes' reach in the sweep: the loop up to 128 rows, the mid route up
# to 256, the wide-M kernel from 64
SWEEP_LOOP_MAX_M, SWEEP_MID_MAX_M, SWEEP_WIDE_MIN_M = 128, 256, 64
# the plan's crossovers that force each route at any M: (MID_MIN_M,
# WIDE_MIN_M)
ROUTE_BOUNDS = {"loop": (1 << 30, 1 << 30), "mid": (1, 1 << 30), "wide": (1 << 30, 1)}
# a route the plan does not take may be faster than the one it takes by at
# most this share at a sweep point (the spread of repeated timings)
CROSSOVER_SLACK = 0.05
WIDE_SOURCE = "lut_gemm_wide_m.cuh"
WIDE_REPLACES = ("flute_tpu/ops/lut_gemm.py:454 (_lut_qgemm_kernel[{}], its weight-side branch "
                 ":611-615, taken above group_acc_max_bm at :812; pallas_call :828)")
MID_REPLACES = ("flute_tpu/ops/lut_gemm.py:454 (_lut_qgemm_kernel[{}], its group-accumulating "
                "decode branch :590-602, taken for bm <= group_acc_max_bm at :812, "
                "flute_tpu/ops/kernel_config.py:32; pallas_call :828)")
WIDE_PAYLOAD = {"K1": "w4sym", "K2": "plane, gather8/select",
                "K3": "w3wide: _unpack_wide3_payload :342, :494-506",
                "K4": "plane, pair_lut: _lookup_payload_lane :279, :533-538, "
                      "_table_tile_pair :680"}
# the layout the route plan (kernel_config.mma_route) names for each kernel:
# K4 reads the plane layout with its own (joint) table
ROUTE_LAYOUT = {**LAYOUT, "K4": "pair"}


@contextlib.contextmanager
def route_bounds(mid=None, wide=None):
    """The plan's crossovers (kernel_config.MID_MIN_M, WIDE_MIN_M: the
    least M of the mid route and of the wide-M kernel) set to ``mid`` and
    ``wide`` where given, for the block; the plan's after it."""
    from flute_tpu_torch.ops import kernel_config

    saved = kernel_config.MID_MIN_M, kernel_config.WIDE_MIN_M
    kernel_config.MID_MIN_M = saved[0] if mid is None else mid
    kernel_config.WIDE_MIN_M = saved[1] if wide is None else wide
    try:
        yield
    finally:
        kernel_config.MID_MIN_M, kernel_config.WIDE_MIN_M = saved


def route_call(kid, bits, planes, scales, table, route, group_size=GROUP, chunk=256):
    """The wrapper of K1, K2, K3 or K4 (``table`` its pair table) on
    ``route``, for a 2-D x: "loop", "mid" or "wide" at any M, the plan's
    bounds moved to one row or past M for the call."""
    from flute_tpu_torch.ops import lut_gemm

    kw = dict(group_size=group_size, chunk=chunk)

    def call(x, p=planes, s=scales):
        with route_bounds(*ROUTE_BOUNDS[route]):
            if kid == "K1":
                return lut_gemm.lut_qgemm_w4sym_cuda(x, p[0], s, table, **kw)
            if kid == "K3":
                return lut_gemm.lut_qgemm_w3wide_cuda(x, p[0], s, table, **kw)
            if kid == "K4":
                return lut_gemm.lut_qgemm_pair_cuda(x, p, s, table, num_bits=bits, **kw)
            return lut_gemm.lut_qgemm_plane_cuda(x, p, s, table, num_bits=bits, **kw)

    return call


def same_bits(a, b) -> bool:
    return torch.equal(a.view(torch.int16), b.view(torch.int16))


def sweep_routes(kid, m) -> list:
    """The routes phase 2's sweep runs for a kernel at M (SWEEP's note)."""
    from flute_tpu_torch.ops import kernel_config

    reach = {"loop": m <= SWEEP_LOOP_MAX_M,
             "mid": m <= SWEEP_MID_MAX_M and ROUTE_LAYOUT[kid] in kernel_config.MID_LAYOUTS,
             "wide": m >= SWEEP_WIDE_MIN_M}
    return [r for r in ROUTES if reach[r]]


def wide_sweep(dev, results):
    """Phase 2's sweep: K1 (w4sym), K2 at 4 and 2 bits, K4 at 4, 3 and 2
    bits (a random joint pair table) and K3 (w3wide) at one Llama-3.1-8B
    layer's four fused shapes, bf16, at SWEEP's M. At each point every
    route of ``sweep_routes`` is timed (bench_cycled, L2-cold) beside the
    bf16 matmul and the bound (bytes at 3.35 TB/s or operations at 989
    TFLOP/s, the larger), and checked: the routes give the same bits, the
    call the plan routes has them and is within the bf16 threshold of the
    plain version, a repeat call gives the same bits, identity rows are
    bit-exact on every route, and rows 0 and M-1 have the one-row call's
    bits. The layer's sums per M show which route is faster: the plan's
    crossovers (kernel_config.MID_MIN_M, WIDE_MIN_M) are held to them (at
    no point a route the plan does not take faster than the one it takes
    by more than CROSSOVER_SLACK), for each kernel and bit width."""
    from flute_tpu_torch.ops import kernel_config, lut_gemm
    from flute_tpu_torch.utils.benchmark import bench_cycled, cold_copies

    rng = np.random.default_rng(5)
    gen = torch.Generator(device=dev)
    gen.manual_seed(5)
    points, matmul_us, plain_us = [], {}, {}
    t_sweep = time.perf_counter()
    for kid, bits, sweep_m in SWEEP:
        layout = LAYOUT[kid]
        for name, n, k in LAYER_SHAPES:
            codes, planes, scales, table = make_weight(rng, gen, layout, bits, n, k,
                                                       torch.bfloat16, dev)
            pv = make_pair_table(rng, bits, dev) if kid == "K4" else None
            lut = table if pv is None else pv  # what the kernel looks up
            deq = (lut_gemm.dequantize_codes(codes, scales, table, torch.bfloat16) if pv is None
                   else lut_gemm.dequantize_codes_pair(codes, scales, pv, torch.bfloat16))
            del codes
            kw = dict(num_bits=bits, layout=layout, pair_values=pv)
            wbytes = sum(p.numel() * 4 for p in planes) + scales.numel() * 2
            args = [([p.clone() for p in planes], scales.clone())
                    for _ in range(cold_copies(wbytes))]
            deq_c = ([(deq.clone(),) for _ in range(cold_copies(deq.numel() * 2))]
                     if any((name, m) not in matmul_us for m in sweep_m) else None)
            for m in sweep_m:
                label = f"{bits}-bit {name} M={m}"
                x = torch.randn((m, k), generator=gen, device=dev).bfloat16()
                routes = sweep_routes(kid, m)
                calls = {r: route_call(kid, bits, planes, scales, lut, r) for r in routes}
                routed = kernel_config.mma_route(m, bits, 256, ROUTE_LAYOUT[kid], GROUP)
                if routed not in routes:
                    raise AssertionError(f"{kid} {label}: the plan's route {routed} is not swept")
                ys = {r: call(x) for r, call in calls.items()}
                y = lut_gemm.lut_qgemm(x, planes, scales, table, **kw)
                for r in routes:
                    if not same_bits(ys[r], ys[routes[0]]):
                        raise AssertionError(f"{kid} {label}: the {r} route's bits differ from "
                                             f"the {routes[0]} route's")
                if not same_bits(y, ys[routed]):
                    raise AssertionError(f"{kid} {label}: lut_qgemm did not take the {routed} "
                                         "route")
                if not same_bits(lut_gemm.lut_qgemm(x, planes, scales, table, **kw), y):
                    raise AssertionError(f"{kid} {label}: a repeat call gave other bits")
                if m > 1:
                    check_rows(kid, label, x, y, lambda xr: lut_gemm.lut_qgemm(
                        xr, planes, scales, table, **kw))
                eye = torch.eye(m, k, dtype=torch.bfloat16, device=dev)
                for r, call in calls.items():
                    if not same_bits(call(eye), deq[:m]):
                        raise AssertionError(f"{kid} {label}: identity rows not bit-exact on "
                                             f"the {r} route")
                y_plain = lut_gemm.lut_qgemm_plain(x, planes, scales, table, num_bits=bits,
                                                   chunk=256, layout=layout, pair_values=pv)
                err = rel_err(y, y_plain)
                if not err < THRESHOLDS[torch.bfloat16]:
                    raise AssertionError(f"{kid} {label}: rel err {err}")
                max_abs = float((y.float() - y_plain.float()).abs().max())
                timed = {f"{r}_us": bench_cycled(
                    lambda p, s, r=r: route_call(kid, bits, p, s, lut, r)(x), args) * 1e6
                    for r in routes}
                if (name, m) not in matmul_us:
                    matmul_us[name, m] = bench_cycled(lambda w: torch.matmul(x, w), deq_c) * 1e6
                if m in (sweep_m[-1], VERIFY_M) and (kid, bits, name, m) not in plain_us:
                    plain_us[kid, bits, name, m] = bench_cycled(
                        lambda p, s: lut_gemm.lut_qgemm_plain(x, p, s, table, num_bits=bits,
                                                              chunk=256, layout=layout,
                                                              pair_values=pv),
                        args[:2], min_launches=2) * 1e6
                nbytes = wbytes + lut.numel() * 4 + 2 * m * k + 2 * m * n
                t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, 2 * m * n * k / BF16_OPS_PER_S
                plan = kernel_config.mid_plan(m, n, k, 256)
                points.append(dict(
                    kernel=kid, bits=bits, name=name, n=n, k=k, m=m, route=routed,
                    **{f"{r}_us": timed.get(f"{r}_us") for r in ROUTES},
                    library_us=matmul_us[name, m],
                    plain_us=plain_us.get((kid, bits, name, m)), rel_err=err,
                    max_abs_err=max_abs, bound_us=max(t_bytes, t_ops) * 1e6,
                    bound_by="bytes" if t_bytes >= t_ops else "operations", bytes=nbytes,
                    mid_workspace_bytes=(plan.splits * m * n * 4 if plan.splits > 1 else 0)))
            del args, deq_c, deq, planes
    layers = []
    for kid, bits, sweep_m in SWEEP:
        for m in sweep_m:
            stack = [p for p in points if p["kernel"] == kid and p["bits"] == bits and p["m"] == m]
            row = dict(kernel=kid, bits=bits, m=m, route=stack[0]["route"],
                       **{key: sum(p[key] for p in stack)
                          for key in ("library_us", "bound_us", "mid_workspace_bytes")},
                       **{f"{r}_us": (sum(p[f"{r}_us"] for p in stack)
                                      if stack[0][f"{r}_us"] is not None else None)
                          for r in ROUTES},
                       bound_by="bytes" if all(p["bound_by"] == "bytes" for p in stack)
                       else "operations")
            times = {r: row[f"{r}_us"] for r in ROUTES if row[f"{r}_us"] is not None}
            row["faster"] = min(times, key=times.get)
            row["routed_over_fastest"] = times[row["route"]] / times[row["faster"]]
            layers.append(row)
            log(f"    sweep {kid} {bits}-bit layer M={m:<5d} route {row['route']:4s}: " + "  ".join(
                f"{r} {times[r]:9.1f} us" if r in times else f"{r} {'-':>9s}   "
                for r in ROUTES) + f"  matmul {row['library_us']:8.1f} us  bound "
                f"{row['bound_us']:8.1f} us ({row['bound_by']})")
    # both crossovers: at no point does a route the plan does not take beat
    # the routed one by more than the slack (below WIDE_MIN_M that holds
    # MID_MIN_M, from it WIDE_MIN_M)
    bounds = kernel_config.MID_MIN_M, kernel_config.WIDE_MIN_M
    late = [r for r in layers if r["routed_over_fastest"] > 1 + CROSSOVER_SLACK]
    agrees = {f"{kid} {bits}-bit": not any(r["kernel"] == kid and r["bits"] == bits
                                           for r in late)
              for kid, bits, _ in SWEEP}
    if late:
        raise AssertionError("the plan's crossovers disagree with the sweep: " + ", ".join(
            f"{r['kernel']} {r['bits']}-bit M={r['m']}: {r['route']} "
            f"{r['routed_over_fastest']:.3f}x {r['faster']} "
            f"({'WIDE' if r['m'] >= bounds[1] else 'MID'}_MIN_M)" for r in late))
    log(f"  sweep: every point's routes bit-identical, identity exact, rows 0 and M-1 the "
        f"one-row call's bits; the plan's MID_MIN_M ({bounds[0]}) and WIDE_MIN_M "
        f"({bounds[1]}) agree with the sweep within {CROSSOVER_SLACK:.0%} at every point "
        f"({', '.join(f'{key}: {v}' for key, v in agrees.items())}; "
        f"{time.perf_counter() - t_sweep:.0f} s)")
    results["wide_sweep"] = dict(points=points, layers=layers, crossover_agrees=all(
        agrees.values()), crossover_agrees_by_kernel=agrees, mid_min_m=bounds[0],
        wide_min_m=bounds[1])
    return results["wide_sweep"]


def time_k3_scale_modes(dev, results, m=2047, chunk=512):
    """K3's two wide-M instantiations at one Llama-3.1-8B layer, bf16, M =
    2047, chunk 512: group size 32 (a multiple of 2 kc = 32: a chunk's
    scales once per field) against 16 (the per-field cache, whose build
    spills), each held to the loop's bits and timed L2-cold. At this M the
    layer is bound by operations, so the extra scale bytes of g 16 cost
    little beside the decode's instructions and the spill."""
    from flute_tpu_torch import packing
    from flute_tpu_torch.utils.benchmark import bench_cycled, cold_copies

    rng = np.random.default_rng(7)
    gen = torch.Generator(device=dev)
    gen.manual_seed(7)
    out = {}
    for g, mode in ((32, "chunk"), (16, "field")):
        total = 0.0
        for name, n, k in LAYER_SHAPES:
            codes = torch.randint(0, 8, (k, n), generator=gen, device=dev, dtype=torch.int32)
            planes = [packing.pack_w3_wide(codes, chunk=chunk)]
            del codes
            scales = (torch.rand((k // g, n), generator=gen, device=dev) + 0.5).bfloat16()
            table = torch.from_numpy(rng.standard_normal(8).astype(np.float32)).to(dev)
            x = torch.randn((m, k), generator=gen, device=dev).bfloat16()
            wide = route_call("K3", 3, planes, scales, table, "wide", g, chunk)
            y = wide(x)
            if not same_bits(y, route_call("K3", 3, planes, scales, table, "loop", g, chunk)(x)):
                raise AssertionError(f"K3 g{g} chunk {chunk} {name}: the wide kernel's bits "
                                     "differ from the loop's")
            args = [([p.clone() for p in planes], scales.clone())
                    for _ in range(cold_copies(planes[0].numel() * 4 + scales.numel() * 2))]
            total += bench_cycled(lambda p, s: route_call("K3", 3, p, s, table, "wide", g,
                                                          chunk)(x), args) * 1e6
        out[mode] = dict(group_size=g, us=total)
    out["field_over_chunk"] = out["field"]["us"] / out["chunk"]["us"]
    log(f"  K3 on the wide-M kernel, one Llama layer at M={m}, chunk {chunk}: g32 (a chunk's "
        f"scales once per field) {out['chunk']['us']:.1f} us, g16 (the per-field cache, its "
        f"spill) {out['field']['us']:.1f} us: {out['field_over_chunk']:.3f}x")
    results["k3_scale_modes"] = out
    return out


# tests/test_torch_cuda.py's cases of K3 and K4 on the wide route and of
# K1-K4 on the mid route
WIDE_TESTS = "k3_k4_wide or k1_k2_mid or k3_k4_mid"


def wide_card_tests() -> dict:
    """The card tests of K3 and K4 on the wide-M kernel and of K1-K4 on its
    mid route (tests/test_torch_cuda.py -k WIDE_TESTS: the loop's bits at
    full and ragged tiles, identity, cp.async staging, K3 at chunk 512 and
    in both scale modes, rows 0 and M-1, one split, f32 refused or on SIMT,
    refused launches raise), run in a child process that loads the
    libraries already built; every one must pass."""
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "pytest", os.path.join("tests", "test_torch_cuda.py"), "-m",
         "cuda", "-q", "--noconftest", "-p", "no:cacheprovider", "-k", WIDE_TESTS],
        cwd=HERE, capture_output=True, text=True, timeout=600)
    tail = proc.stdout.strip().splitlines()[-1] if proc.stdout.strip() else ""
    counts = {key: int(v) for v, key in re.findall(r"(\d+) (passed|failed|skipped|error)", tail)}
    if proc.returncode != 0 or counts.get("passed", 0) == 0 or set(counts) != {"passed"}:
        raise AssertionError(f"card tests -k {WIDE_TESTS}: rc {proc.returncode}, {tail}\n"
                             f"{proc.stdout[-4000:]}{proc.stderr[-2000:]}")
    out = dict(selection=WIDE_TESTS, passed=counts["passed"], s=time.perf_counter() - t0)
    log(f"  card tests -k {WIDE_TESTS}: {out['passed']} passed in {out['s']:.0f} s")
    return out


def wide_line(kid, sweep, launches, gemma2_launches=None, ppl_launches=None):
    """The {"kernels": [...]} entry of the wide-M route of K1, K2, K3 or K4:
    one Llama-3.1-8B layer at M=2047 in bf16 (4 bits; K3 3), its per-M layer
    sums from the sweep beside it (K4's 3- and 2-bit rows under
    ``sweep_other_bits``); ``launches`` its launches in phase 4's Engine
    prefill."""
    bits = 3 if kid == "K3" else 4
    mine = [p for p in sweep["points"] if p["kernel"] == kid and p["bits"] == bits]
    top = [p for p in mine if p["m"] == TOP_M]

    def rows(b):
        return sweep_rows(sweep, kid, b)

    line = dict(
        name=f"{KERNELS[kid][0]} (wide-M route)", route="cuda", path="wide",
        source=f"flute_tpu_torch/csrc/{WIDE_SOURCE}",
        replaces=WIDE_REPLACES.format(WIDE_PAYLOAD[kid]),
        launches=launches,
        max_abs_err=max(p["max_abs_err"] for p in mine if p["route"] == "wide"),
        m=TOP_M, ms=sum(p["wide_us"] for p in top) / 1e3,
        plain_ms=sum(p["plain_us"] for p in top) / 1e3,
        bound_ms=sum(p["bound_us"] for p in top) / 1e3,
        bound_by="bytes" if all(p["bound_by"] == "bytes" for p in top) else "operations",
        library_ms=sum(p["library_us"] for p in top) / 1e3,
        sweep=rows(bits), checked=True)
    if kid == "K4":
        line["sweep_other_bits"] = {b: rows(b) for b in (3, 2)}
    if gemma2_launches is not None:
        line["gemma2"] = dict(launches=gemma2_launches)
    if ppl_launches is not None:
        line["perplexity"] = dict(launches=ppl_launches)
    return line


def sweep_rows(sweep, kid, bits) -> list:
    """The sweep's layer sums of one kernel at each M: each route's ms (None
    where not run), the matmul's and the bound."""
    return [dict(m=r["m"], route=r["route"],
                 **{f"{route}_ms": None if r[f"{route}_us"] is None else r[f"{route}_us"] / 1e3
                    for route in ROUTES},
                 library_ms=r["library_us"] / 1e3, bound_ms=r["bound_us"] / 1e3)
            for r in sweep["layers"] if r["kernel"] == kid and r["bits"] == bits]


def mid_line(kid, sweep, launches):
    """The {"kernels": [...]} entry of the mid route of K1, K2, K3 or K4: one
    Llama-3.1-8B layer at the verify's M = 40 in bf16 (4 bits; K3 3),
    beside the loop's time there, the split-K workspace it writes and reads,
    the same at M = 64, and the sweep's per-M layer sums (K2's 2-bit rows
    and K4's 3- and 2-bit rows under ``sweep_other_bits``); ``launches`` its
    launches in phase 6 (K1, K2) or phase 4 (K3, K4: the paged engines'
    admissions)."""
    bits = 3 if kid == "K3" else 4
    mine = [p for p in sweep["points"] if p["kernel"] == kid and p["bits"] == bits]

    def layer(m, key):
        return sum(p[key] for p in mine if p["m"] == m) / 1e3

    at = [p for p in mine if p["m"] == VERIFY_M]
    line = dict(
        name=f"{KERNELS[kid][0]} (mid-M route)", route="cuda", path="mid",
        source=f"flute_tpu_torch/csrc/{WIDE_SOURCE}",
        replaces=MID_REPLACES.format(WIDE_PAYLOAD[kid]), launches=launches,
        max_abs_err=max(p["max_abs_err"] for p in mine if p["route"] == "mid"),
        m=VERIFY_M, ms=layer(VERIFY_M, "mid_us"),
        plain_ms=sum(p["plain_us"] for p in at) / 1e3,
        bound_ms=layer(VERIFY_M, "bound_us"),
        bound_by="bytes" if all(p["bound_by"] == "bytes" for p in at) else "operations",
        library_ms=layer(VERIFY_M, "library_us"),
        loop_ms=layer(VERIFY_M, "loop_us"),
        workspace_mb=sum(p["mid_workspace_bytes"] for p in at) / 1e6,
        at_64={key: layer(64, f"{key}_us") for key in ("mid", "loop", "library", "bound")},
        sweep=sweep_rows(sweep, kid, bits), checked=True)
    other = {"K2": (2,), "K4": (3, 2)}.get(kid, ())
    if other:
        line["sweep_other_bits"] = {b: sweep_rows(sweep, kid, b) for b in other}
    return line


ATTN = dict(h=32, hkv=8, d=128, bs=16)
ATTN_GEMMA2 = dict(h=16, hkv=8, d=256, bs=16)
ATTN_OPTIONS = [(None, None), (50.0, None), (None, 1000), (30.0, 333)]
GEMMA2_OPTIONS = [(50.0, None), (50.0, 4096)]


def paged_inputs(rng, gen, dev, dtype, lengths, t=0, extra_blocks=0, attn=ATTN):
    """q, pools and tables for sequences of ``lengths`` cached positions (and
    ``t`` more queries each) at ``attn``'s heads and blocks: every live block
    its own pool row, a random permutation of them; dead table entries
    (``extra_blocks`` past the longest sequence's too) point at row 0.
    Returns also the number of live blocks."""
    h, hkv, d, bs = attn["h"], attn["hkv"], attn["d"], attn["bs"]
    need = [-(-(n + t) // bs) for n in lengths]
    mb = max(max(need), 1) + extra_blocks
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


def time_attention(dev, rng, gen, model, attn, kid, lengths, t, kw, spans=False) -> dict:
    """K5 (``t`` = 0) or K6 at ``attn``'s heads on sequences of ``lengths``
    cached positions (and ``t`` queries each): held to its plain version,
    then it, its plain version and the yardstick (SDPA on K/V gathered
    beforehand, masked to each sequence's length where they differ) timed
    L2-cold, with the bound of the bytes and operations this call needs;
    K5 with ``spans`` also at spans of 128, 256 and 512."""
    import torch.nn.functional as F

    from flute_tpu_torch.ops import paged_attention as pa
    from flute_tpu_torch.utils.benchmark import bench_cycled, cold_copies

    dtype = torch.bfloat16
    esz = 2
    h, hkv, d, bs = attn["h"], attn["hkv"], attn["d"], attn["bs"]
    q, kp, vp, tables, lens, live = paged_inputs(rng, gen, dev, dtype, lengths, t=t,
                                                 attn=attn)
    kv_bytes = 2 * kp.numel() * esz
    pools = [(kp.clone(), vp.clone()) for _ in range(cold_copies(kv_bytes))]
    b = len(lengths)
    s_len = max(lengths) + t
    ragged = len(set(lengths)) > 1
    # the yardstick: K/V gathered into [B, Hkv, S, D] beforehand
    kg = kp[tables.long()].permute(0, 2, 1, 3, 4).reshape(b, hkv, -1, d)[:, :, :s_len]
    vg = vp[tables.long()].permute(0, 2, 1, 3, 4).reshape(b, hkv, -1, d)[:, :, :s_len]
    dense = [(kg.contiguous(), vg.contiguous())
             for _ in range(cold_copies(2 * kg.numel() * esz))]
    if kid == "K5":
        def kern(k, v):
            return pa.paged_decode_attention(q, k, v, tables, lens, **kw)

        def plain(k, v):
            return pa.paged_gqa_reference(q, k, v, tables, lens, **kw)

        q4 = q[:, :, None]
        mask = ((torch.arange(s_len, device=dev)[None, :] < lens[:, None])[:, None, None]
                if ragged else None)
        att = [n for n in lengths]
    else:
        def kern(k, v):
            return pa.paged_verify_attention(q, k, v, tables, lens, **kw)

        def plain(k, v):
            return pa.paged_verify_reference(q, k, v, tables, lens, **kw)

        q4 = q.permute(0, 2, 1, 3)
        if ragged:
            mask = (torch.arange(s_len, device=dev)[None, None, :]
                    <= lens[:, None, None] + torch.arange(t, device=dev)[None, :, None])[:, None]
        else:
            mask = (torch.arange(s_len, device=dev)[None, :]
                    <= lengths[0] + torch.arange(t, device=dev)[:, None])
        att = [n + j + 1 for n in lengths for j in range(t)]
    scale = kw.get("scale")

    def library(k, v):
        return F.scaled_dot_product_attention(q4, k, v, attn_mask=mask, enable_gqa=True,
                                              scale=scale)

    got, want = kern(kp, vp).float(), plain(kp, vp).float()
    err = float((got - want).abs().max() / want.abs().max())
    if not err < THRESHOLDS[torch.bfloat16]:
        raise AssertionError(f"{kid} {model} {attn['h']}/{attn['hkv']} B={b} T={t} cached "
                             f"{lengths} {kw}: max rel err {err}")
    t_k = bench_cycled(kern, pools)
    span_us = {}
    if spans:  # the span, timed at 128, 256 and 512
        for span in (128, 256, 512):
            def kern_span(k, v, span=span):
                return pa._launch("paged_decode", q[:, None], k, v, tables, lens, d**-0.5,
                                  None, None, span=span)

            got = kern_span(kp, vp)[:, 0].float()
            err = float((got - want).abs().max() / want.abs().max())
            if not err < THRESHOLDS[torch.bfloat16]:
                raise AssertionError(f"K5 {lengths[0]} with spans of {span}: max rel err {err}")
            span_us[span] = bench_cycled(kern_span, pools) * 1e6
    t_p = bench_cycled(plain, pools[:2], min_launches=2)
    t_l = bench_cycled(library, dense)
    nbytes = live * hkv * bs * d * esz * 2 + 2 * q.numel() * esz
    flops = 4 * h * d * sum(att)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / BF16_OPS_PER_S
    cached = f"{min(lengths)}-{max(lengths)}" if ragged else lengths[0]
    case = dict(kernel=kid, model=model, case=f"B={b} T={max(t, 1)} cached {cached}",
                heads=f"{h}/{hkv}", d=d, dtype="bfloat16",
                options={k: v for k, v in kw.items() if k != "scale"},
                bytes=nbytes, flops=flops, us=t_k * 1e6, plain_us=t_p * 1e6,
                library_us=t_l * 1e6, bound_us=max(t_bytes, t_ops) * 1e6,
                bound_by="bytes" if t_bytes >= t_ops else "operations")
    if kid == "K5":
        case.update(span=pa.DECODE_SPAN,
                    spans=pa.decode_spans(tables.shape[1], bs, pa.DECODE_SPAN),
                    us_by_span=span_us)
    case["share_of_bound"] = case["bound_us"] / case["us"]
    # K6's served shapes: a pool-prefill chunk (a bucket of at most 64), the verify
    case["role"] = "verify" if t == SPEC_K + 1 else "chunk" if 0 < t <= 64 else ""
    log(f"    {kid} {model:10s} {case['heads']:5s} D={d:3d} {case['case']:26s} kernel "
        f"{case['us']:9.1f} us  bound {case['bound_us']:7.1f} us ({case['bound_by']}, "
        f"{100 * case['share_of_bound']:5.1f}%)  plain {case['plain_us']:9.1f} us  "
        f"sdpa {case['library_us']:7.1f} us"
        + (f"  options {case['options']}" if kw else "")
        + (f"  by span {', '.join(f'{k}: {v:.1f}' for k, v in span_us.items())} us"
           if span_us else ""))
    return case


def phase_attention(dev, results):
    """K5 and K6 against their plain versions with every option, at
    Llama-3.1-8B's heads and at Gemma-2-9B's; timed at the decode batch
    (every length 1024, every length 4096) and at a pool prefill chunk
    (T = 256 over 1024 cached positions), Gemma-2's with its softcap and
    window (SDPA, the yardstick, takes no softcap: it runs without)."""
    from flute_tpu_torch.ops import paged_attention as pa

    rng = np.random.default_rng(4)
    gen = torch.Generator(device=dev)
    gen.manual_seed(4)
    cases = []

    def check(kid, fn, ref, q, kp, vp, tables, lens, label, attn, options, model):
        bs = attn["bs"]
        for softcap, window in options:
            kw = dict(softcap=softcap, window=window)
            if model == "gemma2_9b":
                kw["scale"] = 256.0**-0.5  # query_pre_attn_scalar
            got = fn(q, kp, vp, tables, lens, **kw)
            want = ref(q, kp, vp, tables, lens, **kw)
            if not torch.equal(fn(q, kp, vp, tables, lens, **kw).view(torch.int16),
                               got.view(torch.int16)):
                raise AssertionError(f"{kid} {label} {kw}: a repeat call gave other bits")
            if kid == "K5":  # a sequence alone, with a table just wide enough for it
                for i, n in enumerate(lens.tolist()):
                    mb = max(1, -(-n // bs))
                    alone = fn(q[i:i + 1], kp, vp, tables[i:i + 1, :mb], lens[i:i + 1], **kw)
                    if not torch.equal(alone.view(torch.int16), got[i:i + 1].view(torch.int16)):
                        raise AssertionError(f"K5 {label} {kw}: sequence {i} (length {n}) "
                                             "alone differs from it in the batch")
            torch.cuda.synchronize()
            if not torch.isfinite(got.float()).all():
                raise AssertionError(f"{kid} {label} {kw}: non-finite output")
            err = float((got.float() - want.float()).abs().max() / want.float().abs().max())
            max_abs = float((got.float() - want.float()).abs().max())
            if not err < THRESHOLDS[torch.bfloat16]:
                raise AssertionError(f"{kid} {label} {kw}: max rel err {err}")
            cases.append(dict(kernel=kid, model=model, case=label,
                              dtype=str(q.dtype).split(".")[-1], softcap=softcap, window=window,
                              rel_err=err, max_abs_err=max_abs))
        return got

    for model, attn, options in (("llama31_8b", ATTN, ATTN_OPTIONS),
                                 ("gemma2_9b", ATTN_GEMMA2, ATTN_OPTIONS + GEMMA2_OPTIONS)):
        for dtype in (torch.bfloat16, torch.float16):
            lengths = [0, 1, 37, 100, 515, 1000, 2049, 4096]
            q, kp, vp, tables, lens, _ = paged_inputs(rng, gen, dev, dtype, lengths,
                                                      extra_blocks=3, attn=attn)
            got = check("K5", pa.paged_decode_attention, pa.paged_gqa_reference, q, kp, vp,
                        tables, lens, f"decode B=8 lengths {lengths}", attn, options, model)
            if got[0].float().any():
                raise AssertionError("K5: a slot of length 0 must give zeros")
            for t in (5, 64, 256):
                q, kp, vp, tables, lens, _ = paged_inputs(rng, gen, dev, dtype, [0, 1024], t=t,
                                                          attn=attn)
                check("K6", pa.paged_verify_attention, pa.paged_verify_reference, q, kp, vp,
                      tables, lens, f"verify T={t} over [0, 1024]", attn, options, model)
            del q, kp, vp
        log(f"  [{model}: {attn['h']}/{attn['hkv']} heads, D={attn['d']}] K5 (ragged lengths "
            f"0..4096, spans of {pa.DECODE_SPAN}) and K6 (T 5/64/256 over 0 and 1024) agree "
            f"with their plain versions with options {options}, bf16/f16: max rel err "
            f"{max(c['rel_err'] for c in cases if c['model'] == model):.2e}; repeat calls "
            "bit-identical; each K5 sequence alone bit-identical to it in the batch")

    timed = []
    # K6 at T=256 over 1024 (its kernels-line entry) and at the served
    # pool-prefill chunk of phase 4 (one request, 32 tokens over a cached
    # 32-token prefix); Gemma-2's K5 with its softcap and window, K6 with
    # its softcap (the window of 4096 masks nothing at 1280 positions)
    gemma_kw = dict(scale=256.0**-0.5, softcap=50.0, window=4096)
    for model, attn, kid, lengths, t, kw in (
            ("llama31_8b", ATTN, "K5", [1024] * 8, 0, {}),
            ("llama31_8b", ATTN, "K5", [4096] * 8, 0, {}),
            ("llama31_8b", ATTN, "K6", [1024], 256, {}),
            ("llama31_8b", ATTN, "K6", [32], 32, {}),
            ("llama31_8b", dict(ATTN, bs=SPEC_BLOCK), "K6", [128] * 8, SPEC_K + 1, {}),
            ("gemma2_9b", ATTN_GEMMA2, "K5", [1024] * 8, 0, gemma_kw),
            ("gemma2_9b", ATTN_GEMMA2, "K5", [4096] * 8, 0, gemma_kw),
            ("gemma2_9b", ATTN_GEMMA2, "K6", [1024], 256, gemma_kw)):
        timed.append(time_attention(dev, rng, gen, model, attn, kid, lengths, t, kw,
                                    spans=kid == "K5" and model == "llama31_8b"))
    torch.cuda.empty_cache()
    results["attention_cases"] = cases
    results["attention_timed"] = timed
    return cases, timed


def loop_ptxas(ptxas: str) -> list[dict]:
    """Registers and spill stores of each instantiation of the lab's
    tensor-core loop (``lab_mma_kernel<Decoder, Scaling>``) in a ptxas log,
    read from its mangled name (a decoder template's argument as
    ``<true>`` or ``<4>``)."""
    from flute_tpu_torch.lab.ops import LOOP_SCALINGS

    kernels, name = [], None
    for line in ptxas.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = m.group(1)
            continue
        m = name and "lab_mma_kernel" in name and re.search(
            r"([A-Z][A-Za-z0-9]*Decoder)(?:IL([bi])(\d+)EE)?ELi(\d)E", name)
        if not m:
            continue
        arg = m.group(3)
        if m.group(2) == "b":
            arg = "true" if arg == "1" else "false"
        decoder = m.group(1) + ("" if arg is None else f"<{arg}>")
        kernel = next((k for k in kernels if k["mangled"] == name), None)
        if kernel is None:
            kernel = dict(mangled=name, decoder=decoder, scaling=LOOP_SCALINGS[int(m.group(4))])
            kernels.append(kernel)
        r = re.search(r"Used (\d+) registers", line)
        if r:
            kernel["registers"] = int(r.group(1))
        r = re.search(r"(\d+) bytes spill stores", line)
        if r:
            kernel["spill_bytes"] = int(r.group(1))
    return kernels


def loop_report(source: str, ptxas: str) -> list[dict]:
    """Each loop instantiation of lab library ``source``: its ptxas
    registers and spill stores beside its blocks per SM and dynamic shared
    memory at its lab's shape (the occupancy calculator on the card). Fails
    on an instantiation that spills or that ptxas and the library do not
    both list."""
    from flute_tpu_torch.lab import ops as lab

    shape = LAB_SHAPE if source == "kernel_lab.cu" else LAB2_SHAPE
    compiled = loop_ptxas(ptxas)
    occupancy = {(o["decoder"], o["scaling"]): o
                 for o in lab.loop_instances(source, shape["bk"], shape["g"])}
    keys = {(k["decoder"], k["scaling"]) for k in compiled}
    if keys != set(occupancy) or len(keys) != len(compiled):
        raise AssertionError(f"{source}: ptxas lists the loop's instantiations {sorted(keys)}, "
                             f"the library {sorted(occupancy)}")
    for kernel in compiled:
        kernel.update(occupancy[kernel["decoder"], kernel["scaling"]], source=source,
                      bk=shape["bk"], g=shape["g"])
        if kernel["spill_bytes"]:
            raise AssertionError(f"{source}: {kernel['decoder']} {kernel['scaling']} spills")
    return compiled


# the JAX lab's reference shape (scripts/kernel_lab.py:233-243)
LAB_SHAPE = dict(m=16, n=28672, k=8192, bk=1024, g=64)
LAB_NARROW_N = 2048  # the bk 256 checks
# L5's and L3's variants (tables in shared memory) and their register twins
LAB_TWINS = {"g8_repeat": "g8_hoist", "g8_groupacc": "g8_hoist_ga", "gather16": "g8_full"}
LAB_ITERS = 24  # the lab's --iters: launches per timed CUDA graph (at least)
# instructions a B register that a loop variant adds to floor's none,
# counted in its decoder's CUDA source (csrc/kernel_lab.cu), not in the
# SASS that ptxas makes of it: HalfDecoder's lookup 3, HoistDecoder's 6,
# Gather16Decoder's 7, UnpackDecoder's 4 (3 of them the word's, the same in
# each of its 4 fields), and one __hmul2 with "expand": the variants whose
# only work over floor's is their decode
# keeps the low nibble of each bf16 half of a plane word: floor's operand
# then has L2's statistics
L2_HALVES = 0x000F000F
DECODE_INSTRUCTIONS = {"unpack": 4, "g8_bare": 3, "g8_nochain": 4, "g8_wrap": 4,
                       "g8_noscale": 6, "g8_full": 7, "gather16": 8}


def mma_probe_check() -> dict:
    """The tensor core on subnormals (lab.probe_subnormals): the f32 outputs
    are the exact values and round to the operands' bf16 bits, and a k16
    step's sum of 16 subnormal products is exact (L2's whole operand is
    subnormal). Fails on a flush to zero or a truncated sum."""
    from flute_tpu_torch.lab import ops as lab

    out = lab.probe_subnormals(torch.device("cuda"))
    kept, products = out["operands_kept"], out["subnormal_products_kept"]
    sums = out["subnormal_sums_kept"]
    log(f"  the tensor core on subnormals: bf16 {out['operand_bits']} times 1 gives "
        f"{out['outputs']} (kept: {kept}); 2^-100 x ~2^-40 gives {out['products']} "
        f"(kept: {products}); sums of 16 subnormal products {out['sums']} (exact: {sums})")
    if not (kept and products and sums):
        raise AssertionError(f"mma.sync flushes or truncates subnormals: {out}")
    return out


def lab_check(fn, flags, x, planes, scales, table, bn, bk, name, label):
    """One lab case against its plain version on the card: relative
    Frobenius error (unpack_only: largest error over the largest output)."""
    from flute_tpu_torch.lab import ops as lab

    g = LAB_SHAPE["g"]
    m = x.shape[0]
    got = lab.run(fn, x, planes, scales, table, m, bn, bk, g, **flags)
    path = lab.LAST_PATH[fn]
    want = lab.plain(fn, x, planes, scales, table, m, bn, bk, g, **flags)
    torch.cuda.synchronize()
    if path != lab.path_of(fn, g):
        raise AssertionError(f"lab {name} {label}: ran path {path}")
    if not torch.isfinite(got.float()).all():
        raise AssertionError(f"lab {name} {label}: non-finite output")
    max_abs = float((got.float() - want.float()).abs().max())
    err = lab_err(fn, got, want)
    if not err < THRESHOLDS[torch.bfloat16]:
        raise AssertionError(f"lab {name} {label}: error {err}")
    return dict(variant=name, function=fn, case=label, path=path, rel_err=err,
                max_abs_err=max_abs)


def lab_err(fn, got, want) -> float:
    """A lab case's error against its plain version: relative Frobenius
    error, or for unpack_only, whose operand is subnormal, the largest error
    over the largest output."""
    if fn == "unpack_only":
        return float((got.float() - want.float()).abs().max() / want.float().abs().max())
    return rel_err(got, want)


def phase_lab(dev, results):
    """The Hopper lab: its entry point over every variant (counted, each
    function's path recorded), then each case against its plain version, an
    identity x bit for bit, a repeated call of the tensor-core loop bit for
    bit, and the plain versions and a bf16 matmul timed beside the
    kernels."""
    from flute_tpu_torch.lab import kernel_lab
    from flute_tpu_torch.lab import ops as lab
    from flute_tpu_torch.ops import lut_gemm
    from flute_tpu_torch.utils.benchmark import bench_cycled, cold_copies

    sh = LAB_SHAPE
    m, n, k, bk, g = sh["m"], sh["n"], sh["k"], sh["bk"], sh["g"]
    for d in (lab.LAUNCHES, lut_gemm.LAUNCHES):
        for kk in d:
            d[kk] = 0
    lab.LAST_PATH.clear()
    t0 = time.perf_counter()
    rows = kernel_lab.main(["--m", str(m), "--n", str(n), "--k", str(k), "--bk", str(bk),
                            "--iters", str(LAB_ITERS), "--variants", ",".join(kernel_lab.ORDER)])
    launches = dict(lab.LAUNCHES)
    gemm = dict(lut_gemm.LAUNCHES)
    paths = dict(lab.LAST_PATH)
    main_s = time.perf_counter() - t0
    want_paths = {fn: lab.path_of(fn, g) for fn in lab.LAUNCHES}
    if paths != want_paths:
        raise AssertionError(f"the lab's run took the paths {paths}, expected {want_paths}")
    # calls per variant: one check call, then bench_cycled's first call on each
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
        f"package kernels {gemm}; paths {paths}")
    by_name = {r["name"]: r for r in rows}
    probe = mma_probe_check()

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
        if fn == "floor":  # at the lab's bk the four stretches of a block are apart
            eye = torch.eye(bk, dtype=torch.bfloat16, device=dev)
            small = [q[:bk // 8, :256].contiguous() for q in p]
            s_small = scales[:bk // g, :256].contiguous()
            got = lab.run(fn, eye, small, s_small, table, 16, 256, bk, g)
            want = lab.plain(fn, eye, small, s_small, table, 16, 256, bk, g)
            if not torch.equal(got.view(torch.int16), want.view(torch.int16)):
                raise AssertionError(f"lab floor: identity x at bk {bk} not bit-exact")
        if fn in lab.MMA_FUNCTIONS:  # split-K reduced in a fixed order: the same bits
            once = lab.run(fn, x, p, scales, table, m, n, bk, g, **flags)
            again = lab.run(fn, x, p, scales, table, m, n, bk, g, **flags)
            if not torch.equal(once.view(torch.int16), again.view(torch.int16)):
                raise AssertionError(f"lab {name}: a repeated call changed bits")
    # L5 and L3 hold their tables in shared memory, their register twins (L6,
    # L4 full) in registers: one function, the same entries, the same sum
    # order on the loop, so the same bits
    for name, twin in LAB_TWINS.items():
        (fn, flags), (tfn, tflags) = kernel_lab.VARIANTS[name], kernel_lab.VARIANTS[twin]
        got = lab.run(fn, x, planes, scales, table, m, n, bk, g, **flags)
        want = lab.run(tfn, x, planes, scales, table, m, n, bk, g, **tflags)
        if not torch.equal(got.view(torch.int16), want.view(torch.int16)):
            raise AssertionError(f"lab {name} differs from its register twin {twin}")
    log(f"  the shared-memory tables give their register twins' bits: {LAB_TWINS}")
    # g = 2 puts no k16 step inside one group: the loop's functions that
    # read scales run their SIMT kernel, chosen from g before the launch;
    # floor and unpack_only read none and stay on the loop
    _, p2, s2, t2, x2 = kernel_lab.make_inputs(m, LAB_NARROW_N, 1024, 4, 2, device=dev)
    simt = {}
    for name, (fn, flags) in kernel_lab.VARIANTS.items():
        if fn not in lab.MMA_FUNCTIONS:
            continue
        q2 = [lab.finite_halves(p2[0])] if fn == "floor" else p2
        got = lab.run(fn, x2, q2, s2, t2, m, LAB_NARROW_N, 256, 2, **flags)
        path = lab.LAST_PATH[fn]
        err = lab_err(fn, got, lab.plain(fn, x2, q2, s2, t2, m, LAB_NARROW_N, 256, 2, **flags))
        if path != lab.path_of(fn, 2) or not err < THRESHOLDS[torch.bfloat16]:
            raise AssertionError(f"lab {name} at g = 2: path {path}, error {err}")
        simt[name] = dict(path=path, rel_err=err)
    del p2, s2, t2, x2
    log(f"  at g = 2 the loop's variants run SIMT, floor and unpack_only the loop, within "
        f"{max(v['rel_err'] for v in simt.values()):.2e} of their plain versions "
        f"(M{m} N{LAB_NARROW_N} K1024 bk 256): "
        f"{ {name: v['path'] for name, v in simt.items()} }")
    log(f"  L1-L6: 12 cases agree with their plain versions at M{m} N{n} K{k} bk {bk} and at "
        f"N{LAB_NARROW_N} bk 256 (largest error {max(c['rel_err'] for c in checks):.2e}), "
        f"identity x bit-exact (floor also at bk {bk}; unpack_only: its subnormal operand), "
        f"the tensor-core loop's repeated calls bit-identical; on the loop: "
        f"{sorted({c['variant'] for c in checks if c['path'] == 'mma'})}")

    # plain versions and the yardstick, timed beside the kernels
    args = [([q.clone() for q in planes], scales.clone()) for _ in range(2)]
    w_ref = lut_gemm.dequantize_codes(torch.from_numpy(codes).to(dev), scales, table,
                                      torch.bfloat16)
    del codes
    dense = [(w_ref.clone(),) for _ in range(cold_copies(w_ref.numel() * 2))]
    t_lib = bench_cycled(lambda w: torch.matmul(x, w), dense)
    del dense, w_ref
    cases = []
    xy_bytes = x.numel() * 2 + m * n * 2
    t_ops = 2 * m * n * k / BF16_OPS_PER_S
    for name, (fn, flags) in kernel_lab.VARIANTS.items():
        def plain(q, s, fn=fn, flags=flags):
            return lab.plain(fn, x, q, s, table, m, n, bk, g, **flags)

        t_p = bench_cycled(plain, args, min_launches=2)
        # what the function reads: floor and unpack_only read no scales or
        # table, g8_noscale and g8_bare no scales
        nbytes = sum(q.numel() * 4 for q in planes) + xy_bytes
        if fn not in lab.UNSCALED:
            nbytes += table.numel() * 4 + (scales.numel() * 2 if flags.get("scale", True) else 0)
        t_bytes = nbytes / HBM_BYTES_PER_S
        row = by_name[name]
        case = dict(variant=name, function=fn, path=paths[fn], us=row["us"], gbps=row["gbps"],
                    lab_share_of_hbm=row["share_of_hbm"], plain_us=t_p * 1e6,
                    library_us=t_lib * 1e6, bytes=nbytes, bound_us=max(t_bytes, t_ops) * 1e6,
                    bound_by="bytes" if t_bytes >= t_ops else "operations")
        case["share_of_bound"] = case["bound_us"] / case["us"]
        cases.append(case)
        log(f"    {name:12s} {case['path']:4s} kernel {case['us']:8.1f} us {case['gbps']:7.1f} "
            f"GB/s  bound {case['bound_us']:6.1f} us ({case['bound_by']}, "
            f"{100 * case['share_of_bound']:5.1f}%)  plain {case['plain_us']:8.1f} us  matmul "
            f"{case['library_us']:6.1f} us")
    # floor as the lab times it reads real planes (65% of its outputs are
    # not finite); the same kernel on planes masked to finite halves
    fin = [([lab.finite_halves(q[0])], s) for q, s in args]
    t_fin = bench_cycled(lambda q, s: lab.floor(x, q, s, m, n, bk, g), fin, min_launches=24)
    floor = next(c for c in cases if c["variant"] == "floor")
    floor["finite_planes_us"] = t_fin * 1e6
    # at bk 256 floor's x map is the identity (L2's K order): what the map
    # costs at the lab's bk; and floor on planes masked to L2's operand
    # statistics (each half a 4-bit code as a bf16 subnormal, as L2's B
    # registers' halves are): what L2's operand, not its decoder, costs
    t_256 = bench_cycled(lambda q, s: lab.floor(x, q, s, m, n, 256, g), args, min_launches=24)
    sub = [([q[0] & L2_HALVES], s) for q, s in args]
    t_sub = bench_cycled(lambda q, s: lab.floor(x, q, s, m, n, bk, g), sub, min_launches=24)
    floor.update(bk256_us=t_256 * 1e6, l2_operand_us=t_sub * 1e6)
    log(f"    floor on finite planes: kernel {t_fin * 1e6:8.1f} us; at bk 256 "
        f"{t_256 * 1e6:8.1f} us; on L2's operand statistics {t_sub * 1e6:8.1f} us")
    del fin, sub
    # the loop's staging floor: each loop variant's time over floor's, and
    # per decode instruction a B register where the decode is all it adds
    staging = {}
    for c in cases:
        if c["path"] != "mma" or c["variant"] == "floor":
            continue
        over = c["us"] - floor["us"]
        n_ins = DECODE_INSTRUCTIONS.get(c["variant"])
        staging[c["variant"]] = dict(
            over_floor_us=over, source_instructions_per_b_register=n_ins,
            us_per_source_instruction=None if n_ins is None else over / n_ins)
    log(f"    over floor's {floor['us']:.1f} us (the loop's staging floor, "
        f"{100 * floor['share_of_bound']:.1f}% of its bound): " + ", ".join(
            f"{v} +{d['over_floor_us']:.1f}"
            + ("" if d["us_per_source_instruction"] is None else
               f" ({d['source_instructions_per_b_register']} source ins, "
               f"{d['us_per_source_instruction']:.1f} us each)")
            for v, d in staging.items()))
    for name in kernel_lab.PACKAGE_VARIANTS:
        row = by_name[name]
        log(f"    {name:12s} kernel {row['us']:8.1f} us {row['gbps']:7.1f} GB/s "
            f"({100 * row['share_of_hbm']:5.1f}% of 3.35 TB/s, the lab's byte count)"
            + (f", rel {row['rel']:.2e}" if "rel" in row else ""))
    del args, planes, finite, x
    torch.cuda.empty_cache()
    results["lab"] = dict(shape=sh, main_s=main_s, rows=rows, launches=launches,
                          package_launches=gemm, paths=paths, checks=checks, cases=cases,
                          g2=simt, mma_probe=probe, over_floor=staging)
    return cases, checks, launches


def lab_line(kid, lab, cases, checks, launches, served):
    """The {"kernels": [...]} entry of lab kernel ``kid`` (of ``LAB`` or
    ``LAB2``, given as ``lab``): its reporting variant's numbers (its path,
    ``"mma"`` or ``"simt"``, and its share of the bound among them), the
    other variants' times beside them. ``launches`` counts the lab's run,
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
        path=row["path"],
        share_of_bound=row["share_of_bound"],
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
    from flute_tpu_torch.lab import ops as lab

    fn, args = kernel_lab2.lab_call(name, inp, weights, inp.x.shape[0], bn, bk)
    got = ops2.FUNCTIONS[fn](*args)
    path = ops2.LAST_PATH[fn]
    want = ops2.plain(fn, *args)
    torch.cuda.synchronize()
    if path != lab.path_of(fn, LAB2_SHAPE["g"], ops2.MMA_FUNCTIONS):
        raise AssertionError(f"lab2 {name} {label}: ran path {path}")
    if not torch.isfinite(got.float()).all():
        raise AssertionError(f"lab2 {name} {label}: non-finite output")
    err = rel_err(got, want)
    if not err < THRESHOLDS[torch.bfloat16]:
        raise AssertionError(f"lab2 {name} {label}: error {err}")
    return dict(variant=name, function=fn, case=label, path=path, rel_err=err,
                max_abs_err=float((got.float() - want.float()).abs().max()))


def phase_lab2(dev, results, library_us_w4, floor_us):
    """The lab's second half (L7-L12): its entry point over every variant
    (counted, each function's path recorded), then each case against its
    plain version, an identity x bit for bit, a repeated call of the
    tensor-core loop bit for bit, L11 against L5 group_acc's bits, L8
    against L11's, L7 bit for bit, and the plain versions and a bf16 matmul
    timed beside the kernels. ``library_us_w4`` is phase 2b's yardstick, a bf16 matmul at
    this shape, and ``floor_us`` phase 2b's floor (the loop's staging floor,
    timed at the first lab's bk 1024 in the first library, where this lab
    runs bk 2048: its "over floor" times compare across the two)."""
    from types import SimpleNamespace

    from flute_tpu_torch.lab import kernel_lab2, ops2
    from flute_tpu_torch.lab import ops as lab
    from flute_tpu_torch.ops import lut_gemm
    from flute_tpu_torch.utils.benchmark import bench_cycled, cold_copies

    sh = LAB2_SHAPE
    m, n, k, bn, bk, g = sh["m"], sh["n"], sh["k"], sh["bn"], sh["bk"], sh["g"]
    for d in (ops2.LAUNCHES, lab.LAUNCHES, lut_gemm.LAUNCHES):
        for kk in d:
            d[kk] = 0
    ops2.LAST_PATH.clear()
    t0 = time.perf_counter()
    rows = kernel_lab2.main(["--iters", str(LAB_ITERS), "--variants", ",".join(kernel_lab2.ORDER)])
    launches, gemm, lab1 = dict(ops2.LAUNCHES), dict(lut_gemm.LAUNCHES), dict(lab.LAUNCHES)
    paths = dict(ops2.LAST_PATH)
    main_s = time.perf_counter() - t0
    want_paths = {fn: lab.path_of(fn, g, ops2.MMA_FUNCTIONS) for fn in ops2.LAUNCHES}
    if paths != want_paths:
        raise AssertionError(f"the lab2 run took the paths {paths}, expected {want_paths}")

    # calls per GEMM variant: one check call, then bench_cycled's first call on
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
    # vmembw: per chain length a check call, bench_cycled's first call, the graph
    want["vmembw"] = len(kernel_lab2.VMEMBW_NOPS) * (2 + kernel_lab2.VMEMBW_ITERS)
    want_gemm = {kk: calls(w4_bytes) if kk == "plane" else 0 for kk in lut_gemm.LAUNCHES}
    if launches != want or gemm != want_gemm or any(lab1.values()):
        raise AssertionError(f"the lab2 run launched {launches}, {gemm} and {lab1}, "
                             f"expected {want}, {want_gemm} and no L1-L6")
    log(f"  the lab2 entry point ran {len(rows)} variants in {main_s:.1f} s; launches {launches}, "
        f"package kernels {gemm}; paths {paths}")
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
        if fn in ops2.MMA_FUNCTIONS:  # split-K reduced in a fixed order: the same bits
            fn, args = kernel_lab2.lab_call(name, inp, weights, m, bn, bk)
            once, again = ops2.FUNCTIONS[fn](*args), ops2.FUNCTIONS[fn](*args)
            if not torch.equal(once.view(torch.int16), again.view(torch.int16)):
                raise AssertionError(f"lab2 {name}: a repeated call changed bits")
    # L11 and L5 group_acc: one decoder, scaling and split in two libraries
    twin = ops2.slabstream(inp.x, inp.planes, inp.scales, inp.table, m, bn, bk, g)
    l5 = lab.g8_rs(inp.x, inp.planes, inp.scales, inp.table, m, bn, bk, g, "group_acc")
    if not torch.equal(twin.view(torch.int16), l5.view(torch.int16)):
        raise AssertionError("lab2 slabstream differs from L5 g8_rs group_acc")
    log(f"  L11 slabstream gives L5 g8_rs group_acc's bits on the same inputs (path "
        f"{ops2.LAST_PATH['slabstream']}, {lab.lab_splits(n, k, g)} splits of K)")
    # L8 and L11: one decoder, scaling, split and step order; L8's B
    # registers go through a tile in shared memory first
    tiled = ops2.pfdirect(inp.x, inp.planes, inp.scales, inp.table, m, bn, bk, g)
    if not torch.equal(tiled.view(torch.int16), twin.view(torch.int16)):
        raise AssertionError("lab2 pfdirect differs from L11 slabstream")
    log(f"  L8 pfdirect gives L11 slabstream's bits on the same inputs (path "
        f"{ops2.LAST_PATH['pfdirect']})")
    del twin, l5, tiled
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
        "aside), the tensor-core loop's repeated calls bit-identical; vmembw bit-exact at "
        f"nops 2 and 8; on the loop: {sorted({c['variant'] for c in checks if c.get('path') == 'mma'})}")

    # plain versions and the yardsticks, timed beside the kernels: phase 2b's
    # bf16 matmul for the 4-bit cases, its own for L12's 3-bit weight
    w3 = lut_gemm.dequantize_codes(torch.from_numpy(inp.codes3).to(dev), inp.scales, inp.table3,
                                   torch.bfloat16)
    dense = [(w3.clone(),) for _ in range(cold_copies(w3.numel() * 2))]
    library_us_w3 = bench_cycled(lambda w: torch.matmul(inp.x, w), dense) * 1e6
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

        t_p = bench_cycled(plain, sets, min_launches=2)
        del sets
        nbytes = kernel_lab2.weight_bytes(weights) + table_bytes[name] + xy_bytes
        t_bytes = nbytes / HBM_BYTES_PER_S
        row = by_name[name]
        fn = "sep" if name == "sep1" else name
        case = dict(variant=name, function=fn, path=paths[fn], us=row["us"],
                    gbps=row["gbps"], lab_share_of_hbm=row["share_of_hbm"], rel=row["rel"],
                    plain_us=t_p * 1e6,
                    library_us=library_us_w3 if name == "w3wide" else library_us_w4,
                    bytes=nbytes, bound_us=max(t_bytes, t_ops) * 1e6,
                    bound_by="bytes" if t_bytes >= t_ops else "operations")
        case["share_of_bound"] = case["bound_us"] / case["us"]
        if case["path"] == "mma":
            case["over_floor_us"] = case["us"] - floor_us
        cases.append(case)
        log(f"    {name:12s} {case['path']:4s} kernel {case['us']:8.1f} us {case['gbps']:7.1f} "
            f"GB/s  bound {case['bound_us']:6.1f} us ({case['bound_by']}, "
            f"{100 * case['share_of_bound']:5.1f}%)  plain {case['plain_us']:8.1f} us  matmul "
            f"{case['library_us']:6.1f} us  rel {case['rel']:.2e}"
            + (f"  over floor (bk 1024) +{case['over_floor_us']:.1f} us"
               if "over_floor_us" in case else ""))
    # L7 at its longer chain: the block read once and written once, two
    # int32 operations per element and step
    row = by_name["vmembw"]
    nops = max(kernel_lab2.VMEMBW_NOPS)
    t_p = bench_cycled(lambda w: ops2.plain("vmembw", w, nops), [(block,)], min_launches=LAB_ITERS)
    t_bytes = 2 * block.numel() * 4 / HBM_BYTES_PER_S
    t_alu = 2 * nops * block.numel() / ALU_OPS_PER_S
    cases += [dict(variant=f"vmembw nops {kk}", function="vmembw", us=v)
              for kk, v in row["t_us"].items() if kk != nops]
    case = dict(variant="vmembw", function="vmembw", path=paths["vmembw"], us=row["t_us"][nops],
                nops=nops,
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
                           package_launches=gemm, paths=paths, checks=checks, cases=cases)
    return cases, checks, launches


def model_logits(params, config, dev, tokens, offsets, nxt, family=None):
    """Prefill and one decode step of ``family`` (a model module; Llama by
    default) on ``dev``: the f32 logits of both, on the host."""
    from flute_tpu_torch.models import llama

    family = family or llama
    b, t = tokens.shape
    with torch.inference_mode():
        cache = family.init_cache(config, b, 32, device=dev)
        pre, cache = family.forward(params, config, tokens.to(dev), cache, 0, offsets.to(dev))
        dec, _ = family.forward(params, config, nxt.to(dev), cache, t, offsets.to(dev))
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
    # Gemma-2: two layers at Gemma-2-9B widths, w4sym, fused
    from flute_tpu_torch.models import gemma2

    gconfig = dataclasses.replace(gemma2.Gemma2Config.gemma2_9b(), num_layers=2)
    gparams = gemma2.init_params(gconfig, seed=1, device=dev)
    gq = gemma2.quantize_model(gparams, group_size=GROUP, fuse=True, device=dev)
    del gparams
    out = model_logits(gq, gconfig, dev, tokens, offsets, nxt, family=gemma2)
    ref = model_logits(move_params(gq, cpu), gconfig, cpu, tokens, offsets, nxt, family=gemma2)
    errs = {}
    for step, a, want in zip(("prefill", "decode"), out, ref):
        if not torch.isfinite(a).all():
            raise AssertionError(f"gemma2 w4sym: non-finite {step} logits")
        errs[step] = float((a - want).abs().max() / want.abs().max())
        if not errs[step] < THRESHOLDS[torch.bfloat16]:
            raise AssertionError(f"gemma2 w4sym {step} logits differ from the CPU plain path: "
                                 f"{errs[step]}")
    log(f"  2-layer Gemma-2-9B-width w4sym logits vs CPU plain path: prefill "
        f"{errs['prefill']:.2e}, decode {errs['decode']:.2e}")
    results["logits_rel_err"]["gemma2_w4sym"] = errs
    del gq
    torch.cuda.empty_cache()


def serve(dev, name, quant_kw, kernel_layout):
    """Quantize the 32-layer model on the card and serve the prompts once;
    returns the run's numbers, the engine (which keeps the model) and the
    tokens with the logits that chose them (one [B, V] row block per step)."""
    from flute_tpu_torch.models import llama
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
    eng = Engine(params=qparams, config=config, batch_size=8, max_len=256, device=dev)
    serving, trajectory = serve_engine(name, eng, serving_prompts(config), kernel_layout)
    serving["peak_gib"] = (torch.cuda.max_memory_allocated(dev) - held) / 2**30
    log(f"  [{name}] peak {serving['peak_gib']:.1f} GiB")
    return serving, eng, trajectory


def release():
    """Free the card's memory of engines just dropped: an engine and its
    decode graph refer to each other, so only the garbage collector frees
    them."""
    gc.collect()
    torch.cuda.empty_cache()


def counters():
    from flute_tpu_torch.ops import lut_gemm
    from flute_tpu_torch.ops import paged_attention as pa

    return (lut_gemm.LAUNCHES, pa.LAUNCHES, lut_gemm.WIDE_LAUNCHES, lut_gemm.MID_LAUNCHES)


def route_expected(route, layout, bits, rows, calls) -> int:
    """Launches on ``route`` ("wide": the wide-M kernel; "mid": its mid
    route) among ``calls`` LUT-GEMM launches of ``layout`` at ``rows`` rows
    each: all of them where the plan routes that M there, else none."""
    from flute_tpu_torch.ops import kernel_config

    routed = kernel_config.mma_route(rows, bits, 256, layout, GROUP) == route
    return calls if routed else 0


def check_route(name, expected, route="wide"):
    """The launches on ``route`` ("wide" or "mid") since the counters were
    set to 0 equal ``expected`` (by layout, the others 0)."""
    from flute_tpu_torch.ops import lut_gemm

    counter = lut_gemm.WIDE_LAUNCHES if route == "wide" else lut_gemm.MID_LAUNCHES
    want = {key: 0 for key in counter}
    want.update({f"{layout}_{route}": n for layout, n in expected.items() if n})
    got = dict(counter)
    if got != want:
        raise AssertionError(f"[{name}] {route}-M launches {got}, expected {want}")
    return got


def mid_of(layers, runs, route="mid") -> dict:
    """The launches on ``route`` (the mid route, or "wide") expected of
    ``runs`` [(layout, bits, rows of each forward)], each forward four
    LUT-GEMM launches a layer."""
    out = {}
    for layout, bits, rows in runs:
        out[layout] = out.get(layout, 0) + sum(
            route_expected(route, layout, bits, r, layers * 4) for r in rows)
    return out


def launches_now() -> dict:
    from flute_tpu_torch.ops import lut_gemm
    from flute_tpu_torch.ops import paged_attention as pa

    return {**lut_gemm.LAUNCHES, **pa.LAUNCHES}


def reset_counters():
    for c in counters():
        for k in c:
            c[k] = 0


@contextlib.contextmanager
def uncounted():
    """Launches made only to hold a graphed step against the eager step:
    the counts are put back after them."""
    saved = [dict(c) for c in counters()]
    try:
        yield
    finally:
        for c, b in zip(counters(), saved):
            c.update(b)


def hold_graph_step(name, graphed, eager):
    """A replayed step's logits (``graphed``, copied before anything else
    runs) against ``eager()``, the eager step on the same state (it writes
    the same K/V at the same slots): bit for bit."""
    with uncounted():
        want = eager()
    same = torch.equal(graphed.view(torch.int32), want.float().view(torch.int32))
    err = float((graphed - want.float()).abs().max() / want.float().abs().max())
    if not same:
        raise AssertionError(f"[{name}] the graphed decode step differs from the eager step: "
                             f"max rel err {err:.3e}")
    log(f"  [{name}] a replayed decode step is bit-identical to the eager step on the same "
        "state")
    return dict(bit_identical=same, max_rel_err=err)


def serve_engine(name, eng, prompts, kernel_layout, new_tokens=None, head=0):
    """Serve ``prompts`` once through ``eng.generate`` (its decode step
    graphed on the card), each step through exactly ``kernel_layout``'s
    kernel (steps x (layers x 4 + ``head``) launches, ``head`` 1 for a
    quantized lm_head; none of the others), then hold one more replayed step
    bit for bit against the eager step. Returns the run's numbers and
    (tokens, the [steps, B, V] logits that chose them)."""
    from flute_tpu_torch.ops import lut_gemm

    new_tokens = new_tokens or NEW_TOKENS
    layers = eng.config.num_layers
    logits_seen, step_logits, last = [], [], {}
    prefill, decode_step = eng.prefill, eng.decode_step

    prefill_rows, decode_rows = [], []

    def counted_prefill(tokens, offsets):
        prefill_rows.append(tokens.numel())
        logits, cache = prefill(tokens, offsets)
        logits_seen.append(bool(torch.isfinite(logits).all()))
        step_logits.append(logits.float().clone())
        return logits, cache

    def counted_step(tokens, pos, offsets):
        decode_rows.append(tokens.numel())
        logits = decode_step(tokens, pos, offsets)  # overwritten by the next replay
        logits_seen.append(bool(torch.isfinite(logits).all()))
        step_logits.append(logits.clone())
        last.update(pos=pos, offsets=offsets)
        return logits

    eng.prefill, eng.decode_step = counted_prefill, counted_step
    reset_counters()
    out = eng.generate(prompts, max_new_tokens=new_tokens)
    launches = dict(lut_gemm.LAUNCHES)
    eng.prefill, eng.decode_step = prefill, decode_step

    steps = len(logits_seen)  # one prefill + the decode steps
    expected = {k: 0 for k in launches}
    expected[kernel_layout] = steps * (layers * 4 + head)
    if steps != new_tokens or launches != expected:
        raise AssertionError(f"[{name}] launches {launches} over {steps} steps, "
                             f"expected {expected}")
    # the prefill's projections (and a quantized head, which runs on every
    # row) on the wide-M kernel where the plan routes its rows there (the
    # decode steps' 8 rows stay on the loop)
    bits = 3 if kernel_layout == "w3wide" else 4
    wide = check_route(name, {kernel_layout: sum(
        route_expected("wide", kernel_layout, bits, r, layers * 4 + head) for r in prefill_rows)})
    # and none on the mid route where neither the prefill's nor a decode
    # step's rows take it
    check_route(name, {kernel_layout: sum(route_expected("mid", kernel_layout, bits, r,
                                                         layers * 4 + head)
                                          for r in prefill_rows + decode_rows)}, "mid")
    if not all(logits_seen):
        raise AssertionError(f"[{name}] non-finite logits while serving")
    if any(len(o) != new_tokens for o in out):
        raise AssertionError(f"[{name}] a prompt got {[len(o) for o in out]} tokens")
    # one more step at the next slot: the graph's replay, then the eager step
    nxt = step_logits[-1].argmax(-1)[:, None]
    pos, offsets = last["pos"] + 1, last["offsets"]
    with uncounted():
        graphed = eng.decode_step(nxt, pos, offsets).clone()
    graph = hold_graph_step(name, graphed, lambda: eng.decode(nxt, eng._cache, pos, offsets)[0])
    tm = eng.last_timings
    decode_s = [float(d) for d in tm["decode_s"]]
    dec = float(np.median(decode_s))
    total = tm["prefill_s"] + sum(decode_s)
    serving = dict(
        prompts=len(prompts), prompt_lengths=[len(p) for p in prompts], new_tokens=new_tokens,
        steps=steps, launches=launches, wide_launches=wide, prefill_rows=prefill_rows,
        prefill_ms=tm["prefill_s"] * 1e3,
        decode_ms_per_step=dec * 1e3, decode_ms_quickest=min(decode_s) * 1e3,
        decode_ms_steps=[d * 1e3 for d in decode_s],
        decode_tok_s=len(prompts) / dec, end_to_end_tok_s=len(prompts) * new_tokens / total,
        graph_step=graph,
    )
    log(f"  [{name}] served {len(prompts)} prompts x {new_tokens} tokens: prefill "
        f"{serving['prefill_ms']:.1f} ms, graphed decode {serving['decode_ms_per_step']:.2f} "
        f"ms/step (median; quickest {min(decode_s) * 1e3:.2f}, slowest "
        f"{max(decode_s) * 1e3:.2f}), {serving['decode_tok_s']:.1f} decode tok/s, "
        f"{serving['end_to_end_tok_s']:.1f} tok/s end to end, "
        f"{launches[kernel_layout]} {kernel_layout} kernel launches, "
        f"{sum(wide.values())} of them on the wide-M kernel (prefill of {prefill_rows} rows)")
    return serving, (out, torch.stack(step_logits).cpu())


NEW_TOKENS = 16


def serving_prompts(config):
    """The 8 ragged prompts every served run starts from."""
    rng = np.random.default_rng(2)
    return [rng.integers(1, config.vocab_size, n).tolist() for n in (3, 40, 17, 8, 29, 5, 36, 12)]


def serve_paged(dev, name, params, config, requests, engine_kw, gemm, keep_logits=False):
    """Serve ``requests`` [(prompt, submit keywords)] through PagedEngine
    (its decode step graphed on the card); require the exact launches of
    its path: the LUT-GEMM ``gemm`` 4 x layers per forward call, K5 one per
    layer and decode step, K6 one per layer and pool-prefill chunk, no other
    LUT-GEMM, and of the LUT-GEMM's launches exactly those on the mid route
    and on the wide-M kernel that the plan gives each forward's rows (an
    admission's bucketed prompt or pool chunk; a decode step's slots); hold
    the third decode step (a replay) bit for bit against the eager step on
    the same state (that step's time is left out of the decode times).
    Returns the run's numbers, the engine, the tokens by request, the
    first-token logits rows by request and, with ``keep_logits``, each
    decode step's logits [slots, V] on the host."""
    from flute_tpu_torch.serving import PagedEngine

    held = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    eng = PagedEngine(params=params, config=config, device=dev, **engine_kw)
    calls = dict(decode=0, pool_chunks=0, dense_prefill=0, waits=0)
    decode_s, prefill_s, finite, peak_blocks, decode_rows = [], [], [], [0], []
    first_rows, graph = {}, {}
    forward_rows = []  # the rows of each forward's LUT-GEMM calls

    def on_step_logits(r, t0, *a):
        calls["decode"] += 1
        forward_rows.append(eng._step_tokens.shape[0])
        finite.append(bool(torch.isfinite(r).all()))
        if keep_logits:
            decode_rows.append(r.cpu())
        if calls["decode"] == 3:
            graph.update(hold_graph_step(name, r.clone(), lambda: eng._decode_logits(
                eng._step_tables, eng._step_lengths, eng._step_tokens)))

    def on_decode(r, t0, *a):  # ends in a copy to the host: a synchronised step
        if calls["decode"] != 3:
            decode_s.append(time.perf_counter() - t0)

    def on_pool(r, t0, *a):  # (params, K pool, V pool, table row, position, tokens)
        calls["pool_chunks"] += 1
        forward_rows.append(a[5].numel())
        finite.append(bool(torch.isfinite(r[0]).all()))

    def on_dense(r, t0, *a):  # (params, config, tokens, cache, start)
        calls["dense_prefill"] += 1
        forward_rows.append(a[2].numel())

    def on_prefill(r, t0, *a):
        torch.cuda.synchronize()
        prefill_s.append(time.perf_counter() - t0)

    def on_admit(r, t0, *a):
        # pool pressure: a request waits while a slot is free
        if eng._queue and any(req is None for req in eng._slot_req):
            calls["waits"] += 1

    wrap(eng, "_step_logits", on_step_logits)
    wrap(eng, "_decode", on_decode)
    if eng._pool_fwd is not None:
        wrap(eng, "_pool_fwd", on_pool)
    wrap(eng, "forward", on_dense)
    wrap(eng, "_prefill_pool", on_prefill)
    wrap(eng, "_prefill_dense", on_prefill)
    record_first(eng, first_rows)
    wrap(eng, "_admit", on_admit)

    reset_counters()
    rids = [eng.submit(p, **kw) for p, kw in requests]
    t0 = time.perf_counter()
    while eng.step():
        peak_blocks[0] = max(peak_blocks[0], eng.blocks_in_use)
    out = eng.run()
    total = time.perf_counter() - t0
    launches = launches_now()

    forwards = calls["decode"] + calls["pool_chunks"] + calls["dense_prefill"]
    layers = config.num_layers
    expected = {k: 0 for k in launches}
    expected[gemm] = forwards * layers * 4
    expected["paged_decode"] = calls["decode"] * layers
    expected["paged_verify"] = calls["pool_chunks"] * layers
    if launches != expected:
        raise AssertionError(f"[{name}] launches {launches}, expected {expected} ({calls})")
    bits = 3 if gemm == "w3wide" else 4
    routes = {route: check_route(name, mid_of(layers, [(gemm, bits, forward_rows)], route), route)
              for route in ("mid", "wide")}
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
        mid_launches=routes["mid"], wide_launches=routes["wide"],
        forward_rows=list(forward_rows), prefill_ms_per_admission=float(np.median(prefill_s)) * 1e3,
        prefill_ms=[x * 1e3 for x in prefill_s],
        decode_ms_per_step=float(np.median(decode_s)) * 1e3,
        decode_ms_quickest=min(decode_s) * 1e3,
        decode_ms_steps=[x * 1e3 for x in decode_s],
        tok_s=tokens / total, peak_blocks_in_use=peak_blocks[0],
        peak_gib=(torch.cuda.max_memory_allocated(dev) - held) / 2**30, graph_step=graph,
    )
    log(f"  [{name}] {len(requests)} requests, {tokens} tokens: prefill "
        f"{serving['prefill_ms_per_admission']:.1f} ms per admission (median), decode "
        f"{serving['decode_ms_per_step']:.2f} ms/step graphed (median; quickest "
        f"{serving['decode_ms_quickest']:.2f}) over {calls['decode']} steps, "
        f"{serving['tok_s']:.1f} tok/s, {calls['waits']} admission waits for blocks, "
        f"prefix hits {eng.prefix_hits}, peak {peak_blocks[0]} blocks in use, "
        f"peak {serving['peak_gib']:.1f} GiB; launches {launches}, of them "
        f"{sum(routes['mid'].values())} on the mid route and {sum(routes['wide'].values())} "
        f"on the wide-M kernel (the plan's, exactly)")
    return serving, eng, [out[r] for r in rids], [first_rows[r] for r in rids], decode_rows


def wrap(obj, attr, after=None, before=None):
    """Replace the method ``obj.attr`` by a call that runs ``before(*a)``,
    the method, then ``after(r, t0, *a)`` with ``t0`` the host clock at the
    method's call; returns the method."""
    fn = getattr(obj, attr)

    def wrapped(*a, **kw):
        if before is not None:
            before(*a)
        t0 = time.perf_counter()
        r = fn(*a, **kw)
        if after is not None:
            after(r, t0, *a)
        return r

    setattr(obj, attr, wrapped)
    return fn


def record_first(eng, first_rows):
    """Keep each request's raw first-token row, by request id."""
    wrap(eng, "_start", before=lambda slot, prompt, sampling, last_row: first_rows.__setitem__(
        eng._slot_req[slot], last_row.cpu()))


# device kernels by name: the LUT-GEMMs (K1, K2 and K4 on the tensor-core
# loop and the wide-M kernel, told apart by their table fill, K3 by its
# decoder; off them by their SIMT kernels; the wide-M kernel of any of
# them also in its own group, both routes, and its mid route, the row
# tiles under 128, in one more), the loop's split-K reduction (of
# whichever of K1-K4 a model runs), K5's span kernel and its merge, K6, and PyTorch's
# dtype copies (an f32 copy of the lm_head or of a KV cache would show
# there)
PROFILE_GROUPS = {
    "K1": ("W4SymFill", "lut_qgemm_w4sym_kernel"),
    "K2": ("ScalarFill", "lut_qgemm_plane_kernel"),
    "K3": ("W3WideDecoder", "lut_qgemm_w3wide_kernel"),
    "K4": ("JointFill",),
    "split-K reduction": ("split_reduce_kernel",),
    "wide-M (K1-K4)": ("wide_m_kernel",),
    "mid-M (K1-K4)": (", true>(",),
    "K5": ("decode_span_kernel",),
    "K5 merge": ("decode_merge_kernel",),
    "K6": ("verify_mma_kernel",),
    "dtype copies": ("direct_copy",),
}
# an f32 copy of the lm_head ([4096, 128256]) or of a layer's KV cache
# (Engine's [8, 8, 256, 128]) converts at least this many elements; a decode
# step's activations convert at most [8, 28672] (the logits are f32 already)
LARGE_COPY_ELEMENTS = 1 << 20


def profile_steps(name, step, steps=3):
    """Where a step's device time goes: ``steps`` calls of ``step`` under
    torch.profiler, outside the counted runs (the profiler runs only after
    every timed run, so it cannot slow one down)."""
    with profiler() as prof:
        t0 = time.perf_counter()
        for i in range(steps):
            step(i)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return profile_summary(name, prof, wall, steps)


def profiler():
    return torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                              torch.profiler.ProfilerActivity.CUDA],
                                  record_shapes=True)


def profile_summary(name, prof, wall, steps):
    """A profile's device time per step by kernel and group, its idle share
    (1 - device busy / wall), its host waits per step (the host blocking on
    a stream: a copy to the host or an item, each a cudaStreamSynchronize)
    and its large dtype conversions."""
    # dtype conversions of large tensors, by input shape
    large = sorted({tuple(ev.input_shapes[0]) for ev in prof.events()
                    if ev.name == "aten::_to_copy" and ev.input_shapes and ev.input_shapes[0]
                    and int(np.prod(ev.input_shapes[0])) >= LARGE_COPY_ELEMENTS})
    by_kernel = {}
    for ev in prof.key_averages():
        dt = getattr(ev, "device_time_total", None)
        if dt is None:
            dt = getattr(ev, "cuda_time_total", 0)
        if ev.device_type == torch.autograd.DeviceType.CUDA and dt > 0:
            by_kernel[ev.key] = dt / steps / 1e3  # ms per step
    dev_ms = sum(by_kernel.values())
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:12]
    groups = {g: sum(ms for k_name, ms in by_kernel.items() if any(p in k_name for p in pats))
              for g, pats in PROFILE_GROUPS.items()}
    waits = sum(ev.name == "cudaStreamSynchronize" for ev in prof.events())
    profile = dict(
        wall_ms_per_step=wall / steps * 1e3,
        host_waits_per_step=waits / steps,
        device_ms_per_step=dev_ms if by_kernel else None,
        idle_share=(1 - dev_ms / (wall / steps * 1e3)) if by_kernel else None,
        top_kernels_ms_per_step=top,
        groups_ms_per_step=groups if by_kernel else None,
        large_dtype_copies=[list(shape) for shape in large],
    )
    if by_kernel:
        log(f"  [{name}] profile of {steps} step(s): wall {wall / steps * 1e3:.2f} ms, device "
            f"busy {dev_ms:.2f} ms (idle share {profile['idle_share']:.2f}), "
            f"{profile['host_waits_per_step']:.1f} host waits per step; "
            + ", ".join(f"{g} {ms:.3f} ms" for g, ms in groups.items()))
        for k_name, ms in top[:6]:
            log(f"    {ms:8.3f} ms  {k_name[:100]}")
    else:
        log(f"  [{name}] decode step profile: the profiler recorded no device time "
            "(not measured)")
    return profile


def replay_ms(step, steps=10) -> float:
    """Device ms per call of ``step`` (a graphed decode step), from CUDA
    events around ``steps`` calls issued back to back: the host issues a
    replay in far less time than the device runs it, so this is the
    device's time per step."""
    step(0)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(steps):
        step(i)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / steps


def profile_graphed(name, eager_step, served_step, replay_step):
    """Where a graphed decode step's time goes: ``served_step`` (a replay
    with what a served step does around it, ending on the host) profiled
    for wall and device time; ``replay_step`` timed with CUDA events
    (:func:`replay_ms`); one profiled ``eager_step`` on the same state for
    the dtype conversions (a replay records no PyTorch op) and for the
    split by kernel where the profiler does not show the replayed kernels
    one by one."""
    with uncounted():
        eager = profile_steps(f"{name} eager step", eager_step, steps=1)
        profile = profile_steps(name, served_step)
        profile["replay_device_ms_per_step"] = replay_ms(replay_step)
    profile["eager_step"] = eager
    profile["large_dtype_copies"] = sorted(
        {tuple(c) for c in profile["large_dtype_copies"] + eager["large_dtype_copies"]})
    groups = profile["groups_ms_per_step"]
    profile["split_from"] = "graphed steps"
    if not groups or not any(groups.values()):
        profile["groups_ms_per_step"] = eager["groups_ms_per_step"]
        profile["split_from"] = "the eager step"
    log(f"  [{name}] graphed step: {profile['replay_device_ms_per_step']:.2f} ms of device time "
        f"per replay (CUDA events); split by kernel from {profile['split_from']}")
    return profile


def profile_prefill(dev, name, eng, kid="K1"):
    """``kid``'s share of Engine's prefill (8 prompts of 64 tokens: 512
    rows) on each route: the plan's (the wide-M kernel) and the decode
    loop's (both crossovers set past 512 for the run),
    one profiled prefill each after a warm one. The two prefills' logits
    have the same bits."""
    rng = np.random.default_rng(4)
    toks = torch.from_numpy(rng.integers(1, eng.config.vocab_size, (8, 64))).to(dev)
    offs = torch.zeros(8, dtype=torch.int64, device=dev)
    out, logits = {}, {}
    with uncounted():
        for route in ("wide", "loop"):
            with route_bounds(*(ROUTE_BOUNDS["loop"] if route == "loop" else (None, None))):
                with torch.inference_mode():
                    logits[route] = eng.prefill(toks, offs)[0].float().clone()
                    profile = profile_steps(f"{name} prefill, {route} route",
                                            lambda i: eng.prefill(toks, offs), steps=1)
            groups = profile["groups_ms_per_step"] or {}
            ms = groups.get(kid, 0.0) + groups.get("split-K reduction", 0.0)
            profile.update(kernel=kid, kernel_ms=ms, kernel_share=(
                ms / profile["device_ms_per_step"] if profile["device_ms_per_step"] else None))
            out[route] = profile
    if not torch.equal(logits["wide"], logits["loop"]):
        raise AssertionError(f"[{name}] prefill logits differ between the two routes")
    log(f"  [{name}] prefill of 512 rows: {kid} {out['wide']['kernel_ms']:.2f} ms of "
        f"{out['wide']['device_ms_per_step']:.2f} ms busy on the wide-M route, "
        f"{out['loop']['kernel_ms']:.2f} ms (with its split-K reduction) of "
        f"{out['loop']['device_ms_per_step']:.2f} ms on the loop's; the logits of the two "
        "have the same bits")
    return out


def profile_decode(dev, name, eng):
    """An Engine's graphed decode step at batch 8 after a 64-token prefill
    (the graph captured in the served run), each ending with its argmax on
    the host as a served step does."""
    config = eng.config
    rng = np.random.default_rng(3)
    with torch.inference_mode():
        toks = torch.from_numpy(rng.integers(1, config.vocab_size, (8, 64))).to(dev)
        offs = torch.zeros(8, dtype=torch.int64, device=dev)
        eng.prefill(toks, offs)
        nxt = toks[:, -1:]
    return profile_graphed(
        name, lambda i: eng.decode(nxt, eng._cache, 64, offs),
        lambda i: eng.decode_step(nxt, 64 + i, offs).argmax(-1).cpu(),
        lambda i: eng.decode_step(nxt, 80 + i, offs))


def profile_paged(name, eng, prompts):
    """A PagedEngine step that admits 8 requests (pool prefill: K6; the
    prompts served before, so each admission prefills what its prefix hit
    leaves, at most 16 rows: the loop) and decodes once, then three graphed
    decode steps with 8 live requests; then steps that admit 8 new prompts
    of the same lengths (no prefix hit: those of 17-64 rows on the mid
    route), on the plan's routes and with MID_MIN_M past 64 (the loop), in
    turns (mid, loop, loop, mid), uncounted: the LUT-GEMM's ms in each."""
    for p in prompts:
        eng.submit(p, max_new_tokens=8)
    torch.cuda.synchronize()
    with uncounted():
        admission = profile_steps(f"{name} admission", lambda i: eng.step(), steps=1)
    profile = profile_graphed(
        name, lambda i: eng._decode_logits(eng._step_tables, eng._step_lengths,
                                           eng._step_tokens),
        lambda i: eng.step(), lambda i: eng._graph())
    eng.run()
    profile["admission_step"] = admission
    rng = np.random.default_rng(6)
    turns = {"mid": [], "loop": []}
    for route in ("mid", "loop", "loop", "mid"):
        for p in prompts:
            eng.submit(rng.integers(1, eng.config.vocab_size, len(p)).tolist(), max_new_tokens=1)
        torch.cuda.synchronize()
        with uncounted(), route_bounds(mid=None if route == "mid" else 1 << 30):
            step = profile_steps(f"{name} admission of new prompts, {route} route",
                                 lambda i: eng.step(), steps=1)
            eng.run()
        groups = step["groups_ms_per_step"] or {}
        turns[route].append(dict(lut_ms=groups.get("K4"), mid_ms=groups.get("mid-M (K1-K4)"),
                                 split_ms=groups.get("split-K reduction"),
                                 busy_ms=step["device_ms_per_step"]))
    profile["admission_new_prompts"] = {
        route: {key: (float(np.mean([t[key] for t in ts])) if ts[0][key] is not None else None)
                for key in ts[0]} | {"turns": ts}
        for route, ts in turns.items()}
    return profile


def check_copies(name, profile):
    """No f32 copy of the lm_head or of a KV cache: no dtype conversion in a
    decode step takes a tensor of LARGE_COPY_ELEMENTS or more."""
    if profile["large_dtype_copies"]:
        raise AssertionError(f"[{name}] a decode step converts tensors of shapes "
                             f"{profile['large_dtype_copies']}")


def _stack_numbers(stack) -> dict:
    """ms, plain_ms, bound_ms, bound_by and library_ms of a stack of timed
    cases (one layer's projections, or one attention call)."""
    return dict(
        ms=sum(c["us"] for c in stack) / 1e3,
        plain_ms=sum(c["plain_us"] for c in stack) / 1e3,
        bound_ms=sum(c["bound_us"] for c in stack) / 1e3,
        bound_by="bytes" if all(c["bound_by"] == "bytes" for c in stack) else "operations",
        library_ms=sum(c["library_us"] for c in stack) / 1e3,
    )


def spec_runs(spec) -> dict:
    """Phase 6's runs by name: the continuous engine, the dense and the
    paged speculative runs."""
    runs = {"continuous": spec["continuous"]}
    for engine in ("dense_spec", "paged_spec"):
        runs.update({f"{engine} {name}": run for name, run in spec[engine].items()
                     if name != "oracle"})
    return runs


def spec_launches(spec, key) -> dict:
    """A kernel's launches (counter ``key``) in each phase-6 run that
    launched it."""
    return {name: run["launches"][key] for name, run in spec_runs(spec).items()
            if run["launches"].get(key)}


def kernel_line(kid, cases, launches, identity_paths, gemma2_launches=None, spec=None):
    """The {"kernels": [...]} entry of a LUT-GEMM: its decode stack, one
    Llama-3.1-8B layer's four projections at M=8 in bf16 (K2 and K4 at 4
    bits); K1's also one Gemma-2-9B layer's (``gemma2_9b``, beside its
    launches in the Gemma-2 phase). ``path`` is the kernel that stack ran;
    ``paths`` every kernel its checked cases ran (phase 2's and the identity
    checks')."""
    wrapper, source, _, replaces = KERNELS[kid]
    bits = 4 if kid != "K3" else 3
    mine = [c for c in cases if c["kernel"] == kid]

    def stack(model):
        return [c for c in mine if c["model"] == model and c["bits"] == bits and c["m"] == 8
                and c["dtype"] == "bfloat16"]

    (path,) = {c["path"] for c in stack("llama31_8b")}
    paths = sorted({f"{c['path']} {c['dtype']}" for c in mine} | set(identity_paths.get(kid, ())))
    line = dict(name=wrapper, route="cuda", path=path, paths=paths,
                source=f"flute_tpu_torch/csrc/{source}", replaces=replaces, launches=launches,
                max_abs_err=max(c["max_abs_err"] for c in mine),
                **_stack_numbers(stack("llama31_8b")), checked=True)
    if stack("gemma2_9b"):
        line["gemma2_9b"] = dict(_stack_numbers(stack("gemma2_9b")), launches=gemma2_launches)
    if spec is not None and spec_launches(spec, KERNELS[kid][2]):
        line["spec"] = dict(launches=spec_launches(spec, KERNELS[kid][2]))
        if kid == "K2":  # the W2 draft: the 2-bit stack at M=8
            w2 = [c for c in mine if c["model"] == "llama31_8b" and c["bits"] == 2
                  and c["m"] == 8 and c["dtype"] == "bfloat16"]
            line["spec"]["w2_m8"] = _stack_numbers(w2)
    return line


def attention_line(kid, checks, timed, launches, gemma2_launches=None, spec=None):
    """The {"kernels": [...]} entry of K5 (one call at B=8, every length
    1024; with its span and the spans of a sequence at 1024 [4096]) or K6
    (one call, T=256 over 1024 cached positions), at Llama-3.1-8B's heads;
    ``gemma2_9b`` the same calls at Gemma-2-9B's (with its options, beside
    its launches in the Gemma-2 phase)."""
    wrapper, source, _, replaces = KERNELS[kid]
    rows = [c for c in timed if c["kernel"] == kid and c["model"] == "llama31_8b"]
    gemma = [c for c in timed if c["kernel"] == kid and c["model"] == "gemma2_9b"]
    row = rows[0]
    line = dict(
        name=wrapper,
        route="cuda",
        source=f"flute_tpu_torch/csrc/{source}",
        replaces=replaces,
        launches=launches,
        max_abs_err=max(c["max_abs_err"] for c in checks if c["kernel"] == kid),
        **_stack_numbers([row]),
        checked=True,
    )
    if kid == "K6":
        line["served_chunk_ms"] = next(c for c in rows if c["role"] == "chunk")["us"] / 1e3
        served = next(c for c in rows if c["role"] == "verify")
        line["served_verify"] = dict(_stack_numbers([served]), case=served["case"])
        if spec is not None:
            paged = {name: run for name, run in spec["paged_spec"].items() if name != "oracle"}
            line["served_verify"]["launches"] = spec_launches(spec, KERNELS[kid][2])
            line["served_verify"].update({
                f"{name} {key}": run[key] for name, run in paged.items()
                for key in ("k6_us_per_served_call", "k6_bound_us") if key in run})
    else:
        line.update(span=row["span"], spans=[c["spans"] for c in rows],
                    ms_at_4096=rows[1]["us"] / 1e3)
    line["gemma2_9b"] = dict(_stack_numbers(gemma[:1]), launches=gemma2_launches,
                             heads=gemma[0]["heads"], d=gemma[0]["d"],
                             options=gemma[0]["options"])
    if kid == "K5":
        line["gemma2_9b"].update(ms_at_4096=gemma[1]["us"] / 1e3,
                                 bound_ms_at_4096=gemma[1]["bound_us"] / 1e3,
                                 library_ms_at_4096=gemma[1]["library_us"] / 1e3)
    return line


def decided_steps(logits, tol=THRESHOLDS[torch.bfloat16]):
    """Which rows of ``logits`` [..., V] have a top-1/top-2 margin above
    twice ``tol`` of their largest logit ([...] bools)."""
    top2 = torch.topk(logits.float(), 2, dim=-1).values
    scale = logits.float().abs().amax(dim=-1)
    return (top2[..., 0] - top2[..., 1]) > 2 * tol * scale


def paged_dense(dev, results, name, engine, trajectory, layout):
    """PagedEngine with dense prefill on ``engine``'s model (an Engine of
    phase 4: w4sym on K1, W3 on K3) and the 8 prompts, every request
    admitted at once (each prompt's bucketed rows on the route the plan
    gives them: the mid route from 17 rows), held to the Engine's tokens
    before every near tie, first-token logits within the bf16 threshold,
    decode logits within 0.25 while the histories agree."""
    from flute_tpu_torch.models import llama

    config = llama.LlamaConfig.llama31_8b()
    prompts = serving_prompts(config)
    budget = dict(max_new_tokens=NEW_TOKENS)
    out, logits = trajectory
    serving, eng, tokens, first, rows = serve_paged(
        dev, name, engine.params, config, [(p, budget) for p in prompts],
        dict(num_slots=8, block_size=16, num_blocks=8 * 4 + 1, max_len=256), layout,
        keep_logits=True)
    _, decided = hold_tokens(name, tokens, out, logits[:, : len(prompts)])
    # every request was admitted at once, request i into slot i: while its
    # tokens equal Engine's, decode step k's row i is Engine's step k + 1.
    # Engine and K5 both round attention probabilities to bf16, but sum
    # them in other orders (K5 over its spans and warps), which alone moves
    # 32-layer logits by a few percent (PERF.md §6); a wrong position or
    # block would move them by their whole size.
    if serving["calls"]["waits"]:
        raise AssertionError(f"{name}: a request waited for blocks")
    if not serving["mid_launches"][f"{layout}_mid"]:
        raise AssertionError(f"{name}: no admission took the mid route: {serving['forward_rows']}")
    step_err, compared = 0.0, 0
    for k, row in enumerate(rows[: NEW_TOKENS - 1]):
        for i in range(len(prompts)):
            if tokens[i][: k + 1] == out[i][: k + 1]:
                want_k = logits[k + 1, i]
                step_err = max(step_err, float((row[i] - want_k).abs().max() / want_k.abs().max()))
                compared += 1
    if not step_err < 0.25:
        raise AssertionError(f"{name}: decode logits differ from Engine's: {step_err}")
    first = torch.stack(first)
    want = logits[0, : len(prompts)]
    first_err = float(((first - want).abs().amax(dim=-1) / want.abs().amax(dim=-1)).max())
    if not first_err < THRESHOLDS[torch.bfloat16]:
        raise AssertionError(f"{name}: first-token logits differ from Engine: {first_err}")
    same = sum(a == b for a, b in zip(tokens, out))
    log(f"  [{name}] tokens equal Engine's before every low-margin step (decided share "
        f"{decided:.2f}; {same}/{len(out)} sequences identical in full); first-token logits "
        f"within {first_err:.2e}; decode logits within {step_err:.2e} of Engine's over "
        f"{compared} (step, request) pairs with the same history; "
        f"{serving['mid_launches'][f'{layout}_mid']} launches on the mid route (admissions of "
        f"{sorted(r for r in serving['forward_rows'] if r != 8)} rows)")
    serving.update(first_token_rel_err=first_err, decided_share=decided,
                   identical_sequences=same, decode_logits_rel_err=step_err,
                   decode_rows_compared=compared)
    del eng
    release()
    return serving


def phase_paged(dev, results, engines, trajectories):
    """PagedEngine with dense prefill at w4sym (K1) and at W3 (K3) against
    Engine, then the HIGGS-W4 model with pool prefill, prefix sharing, pool
    pressure and sampling."""
    from flute_tpu_torch.models import llama

    config = llama.LlamaConfig.llama31_8b()
    prompts = serving_prompts(config)
    budget = dict(max_new_tokens=NEW_TOKENS)
    for layout in ("w4sym", "w3wide"):
        results["serving"][f"paged_{layout}"] = paged_dense(
            dev, results, f"paged {'w4sym' if layout == 'w4sym' else 'W3'}", engines[layout],
            trajectories[layout], layout)

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
    serving, eng, tokens, first, _ = serve_paged(dev, "paged HIGGS-W4", params, config,
                                                 list(zip(all_prompts, kws)), engine_kw, "pair")
    if serving["prefix_hits"] < 1 or serving["calls"]["waits"] < 1:
        raise AssertionError(f"paged HIGGS-W4: prefix hits {serving['prefix_hits']}, "
                             f"admission waits {serving['calls']['waits']}")
    # one request's pool prefill at a time, at most 64 rows: K4 on the mid
    # route from its mid bound (serve_paged held the exact counts)
    if not serving["mid_launches"]["pair_mid"]:
        raise AssertionError(f"paged HIGGS-W4: no admission took the mid route: "
                             f"{serving['forward_rows']}")
    results["serving"]["paged_higgs_w4"] = serving
    greedy = [i for i in range(len(prompts)) if "seed" not in kws[i]]
    results["serving"]["higgs_w4"] = serve_higgs_engine(
        dev, params, config, prompts, {i: tokens[i] for i in greedy},
        {i: first[i] for i in greedy})
    return eng, prompts


def serve_higgs_engine(dev, params, config, prompts, paged_tokens, paged_first):
    """Phase 4's HIGGS-W4 model (the PagedEngine's params) through Engine on
    the 8 prompts: its 512-row prefill runs K4 on the wide-M kernel (32 x 4
    launches), its decode steps the loop. The greedy requests' tokens
    (``paged_tokens`` by request) are held to the paged engine's (pool
    prefill through K6, one request's rows at a time on the loop) before
    every near tie, and their first-token logits (``paged_first``) within
    the paged-against-dense limit of phase 4 (0.25); the prefill is
    profiled on both routes."""
    from flute_tpu_torch.serving import Engine

    eng = Engine(params=params, config=config, batch_size=8, max_len=256, device=dev)
    serving, (out, logits) = serve_engine("HIGGS-W4", eng, prompts, "pair")
    idx = sorted(paged_tokens)
    ties, decided = hold_tokens("HIGGS-W4 Engine", [paged_tokens[i] for i in idx],
                                [out[i] for i in idx], logits[:, idx])
    first = torch.stack([paged_first[i].float() for i in idx])
    want = logits[0, idx]
    first_err = float(((first - want).abs().amax(dim=-1) / want.abs().amax(dim=-1)).max())
    if not first_err < 0.25:
        raise AssertionError(f"HIGGS-W4 Engine: first-token logits differ from the paged "
                             f"engine's: {first_err}")
    same = sum(paged_tokens[i] == out[i] for i in idx)
    log(f"  [HIGGS-W4] Engine's greedy tokens equal PagedEngine's before every low-margin step "
        f"(requests {idx}; first ties {ties}; decided share {decided:.2f}; {same}/{len(idx)} "
        f"identical in full); first-token logits within {first_err:.2e} of the paged "
        "engine's (pool prefill through K6)")
    serving.update(first_token_rel_err=first_err, decided_share=decided, first_ties=ties,
                   identical_sequences=same, held_requests=idx)
    serving["prefill_profile"] = profile_prefill(dev, "HIGGS-W4", eng, "K4")
    del eng
    release()
    return serving


GEMMA2_LONG = 4160  # past the window of 4096: sliding layers mask its first positions
GEMMA2_MAX_LEN = 4352  # 17 spans of 256: K5 merges them


def hold_tokens(name, got, want, logits):
    """Each sequence's tokens equal ``want``'s (the dense Engine's) before
    its first near tie in ``logits`` [steps, B, V]; returns the ties and the
    decided share."""
    decided = decided_steps(logits)
    ties, _ = hold_to_oracle(name, got, want, decided)
    return ties, float(decided.float().mean())


def phase_gemma2(dev, results):
    """Gemma-2-9B at full width and depth (42 layers, 16/8 heads of 256,
    vocab 256128; w4sym, g64, fused qkv/gate_up; random weights from a
    seed, quantized on the card): the 8 prompts through Engine (batch 8,
    max_len 256), a prompt of 4160 tokens through a batch-1 Engine (max_len
    4352), then all nine through PagedEngine with pool prefill (blocks of
    16, 8 slots, 400 blocks, max_len 4352: the long prompt first, so it
    decodes beside seven others while the last waits for a slot), each
    graphed and with exact launches. The long request runs the sliding
    layers' window in K6 (its last chunk) and in K5, whose 17 spans its
    merge kernel adds. Paged tokens are held to the Engines' before their
    first near tie, and first-token logits (K6 against dense attention)
    within the paged-against-dense limit of phase 4 (0.25)."""
    from flute_tpu_torch.models import gemma2
    from flute_tpu_torch.ops import paged_attention as pa
    from flute_tpu_torch.serving import Engine

    config = gemma2.Gemma2Config.gemma2_9b()
    held = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    params = gemma2.init_params(config, seed=0, device=dev)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    qparams = gemma2.quantize_model(params, group_size=GROUP, fuse=True, device=dev)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    del params
    torch.cuda.empty_cache()
    log(f"  [gemma2] init {t1 - t0:.1f} s, quantize {t2 - t1:.1f} s, "
        f"{(torch.cuda.memory_allocated(dev) - held) / 2**30:.2f} GiB allocated after "
        "quantization")
    prompts = serving_prompts(config)
    long_prompt = np.random.default_rng(6).integers(1, config.vocab_size, GEMMA2_LONG).tolist()
    family = dict(forward=gemma2.forward, init_cache=gemma2.init_cache)
    out = {}

    eng = Engine(params=qparams, config=config, batch_size=8, max_len=256, device=dev, **family)
    serving, (tokens8, logits8) = serve_engine("gemma2 w4sym", eng, prompts, "w4sym")
    serving["profile"] = profile_decode(dev, "gemma2 w4sym", eng)
    check_copies("gemma2 w4sym", serving["profile"])
    out["engine"] = serving
    del eng
    release()
    eng = Engine(params=qparams, config=config, batch_size=1, max_len=GEMMA2_MAX_LEN, device=dev,
                 **family)
    out["engine_long"], (tokens1, logits1) = serve_engine("gemma2 w4sym long", eng,
                                                          [long_prompt], "w4sym")
    del eng
    release()

    budget = dict(max_new_tokens=NEW_TOKENS)
    engine_kw = dict(num_slots=8, block_size=16, num_blocks=400, max_len=GEMMA2_MAX_LEN,
                     pool_prefill=True)
    spans = pa.decode_spans(GEMMA2_MAX_LEN // 16, 16)
    if spans != 17:
        raise AssertionError(f"gemma2 paged: {spans} spans per sequence, expected 17")
    paged, peng, tokens, first, _ = serve_paged(
        dev, "paged gemma2 w4sym", qparams, config,
        [(long_prompt, budget)] + [(p, budget) for p in prompts], engine_kw, "w4sym")
    ties1, decided1 = hold_tokens("paged gemma2 (long)", tokens[:1], tokens1, logits1)
    ties8, decided8 = hold_tokens("paged gemma2", tokens[1:], tokens8, logits8[:, :8])
    first = torch.stack(first)
    want = torch.cat([logits1[0, :1], logits8[0, :8]])
    first_err = float(((first - want).abs().amax(dim=-1) / want.abs().amax(dim=-1)).max())
    if not first_err < 0.25:
        raise AssertionError(f"paged gemma2: first-token logits differ from Engine's: "
                             f"{first_err}")
    same = sum(a == b for a, b in zip(tokens, tokens1 + tokens8))
    log(f"  [paged gemma2 w4sym] a {GEMMA2_LONG}-token request (sliding window 4096, {spans} "
        f"spans merged) and 8 others: tokens equal the Engines' before every low-margin step "
        f"(first ties {ties1} and {ties8}; decided shares {decided1:.2f}, {decided8:.2f}; "
        f"{same}/9 sequences identical in full); first-token logits within {first_err:.2e} "
        "of the dense Engines' (pool prefill through K6)")
    paged.update(first_token_rel_err=first_err, identical_sequences=same,
                 first_ties=ties1 + ties8, decided_share=[decided1, decided8], spans=spans)
    out["paged"] = paged
    out["peak_gib"] = (torch.cuda.max_memory_allocated(dev) - held) / 2**30
    log(f"  [gemma2] peak {out['peak_gib']:.1f} GiB")
    del peng, qparams
    release()
    results["serving"]["gemma2_w4sym"] = out
    return out


# ---------------------------------------------------------------------------
# Phase 6: ContinuousBatchingEngine and speculative decoding, dense and paged
# ---------------------------------------------------------------------------

def sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


class Calls:
    """Counts calls of wrapped methods; a call made inside a wrapped step
    (``step=True``) is not counted, so that a forward is counted only where
    it runs outside the steps (prefill)."""

    def __init__(self):
        self.n = {}
        self.rows = {}  # key -> the rows of each counted call, where asked
        self.depth = 0
        self.held = {}  # step -> its replay held against the eager step

    def count(self, obj, attr, key=None, step=False, after=None, tokens=None):
        """Count calls of ``obj.attr``; with ``tokens``, the index of the
        call's token tensor, also keep its rows (B x T)."""
        key = key or attr

        def enter(*a):
            if not self.depth:
                self.n[key] = self.n.get(key, 0) + 1
                if tokens is not None:
                    self.rows.setdefault(key, []).append(a[tokens].numel())
            self.depth += step

        def leave(r, t0, *a):
            if after is not None:  # inside the step: its eager holds count no call
                after(r)
            self.depth -= step

        wrap(obj, attr, leave, enter)

    def __getitem__(self, key):
        return self.n.get(key, 0)


def hold_replay(name, calls, key, at, result, eager):
    """At call ``at`` of step ``key`` (a replay on the card), hold its
    output bit for bit against ``eager()`` on the same state."""
    if calls[key] == at and key not in calls.held:
        calls.held[key] = hold_graph_step(f"{name} {key}", result.clone(), eager)


def hold_steps(label, eng, calls, draft_eager, verify_eager):
    """Count the draft and verify steps of a speculative engine and hold
    the third draft call and the second verify call (replays) bit for bit
    against the eager steps."""
    calls.count(eng, "_draft_step", key="draft", step=True, after=lambda r: hold_replay(
        label, calls, "draft", 3, r, draft_eager))
    calls.count(eng, "_verify_step", key="verify", step=True, after=lambda r: hold_replay(
        label, calls, "verify", 2, r, verify_eager))


def hold_to_oracle(name, got, want, decided):
    """Each sequence's tokens equal the oracle's before its first near tie
    (``decided`` [steps, B]); returns the first ties and identical count."""
    ties = [int(torch.argmin(col.int())) if not bool(col.all()) else col.numel()
            for col in decided.T]
    for i, tie in enumerate(ties):
        tie = min(tie, len(got[i]))
        if got[i][:tie] != want[i][:tie]:
            raise AssertionError(f"[{name}] request {i} differs from its oracle before step {tie}: "
                                 f"{got[i][:tie]} != {want[i][:tie]}")
    same = sum(a == b[:len(a)] for a, b in zip(got, want))
    return ties, same


def check_launches(name, expected):
    got = launches_now()
    want = {k: 0 for k in got}
    want.update(expected)
    if got != want:
        raise AssertionError(f"[{name}] launches {got}, expected {want}")
    return got


def serve_continuous(dev, config, params, trajectory):
    """ContinuousBatchingEngine at w4sym (K1): 12 requests into 8 slots,
    max_len 512, chunked prefill (64), a prefix store (blocks of 16) that
    three requests hit on the first 32 tokens of a fourth, 2 sampled; its
    greedy tokens held to Engine's before near ties, one replayed step bit
    for bit against the eager step, exact K1 launches."""
    from flute_tpu_torch.models import llama
    from flute_tpu_torch.serving import ContinuousBatchingEngine, Engine
    from flute_tpu_torch.utils.benchmark import bench_cycled, cold_copies

    prompts = serving_prompts(config)
    v = config.vocab_size
    rng = np.random.default_rng(7)
    extra = [prompts[1][:32] + rng.integers(1, v, n).tolist() for n in (9, 14, 3)]
    long_prompt = rng.integers(1, v, 100).tolist()
    sampled = dict(temperature=0.8, top_k=50, top_p=0.9)
    requests = [(p, {}) for p in prompts] + [(extra[0], {}), (long_prompt, {}),
                                               (extra[1], dict(sampled, seed=21)),
                                               (extra[2], dict(sampled, seed=22))]
    # the oracle of the two greedy requests that are not the 8 prompts
    oracle = Engine(params=params, config=config, batch_size=2, max_len=256, device=dev)
    _, (extra_out, extra_logits) = serve_engine("continuous oracle", oracle,
                                                [extra[0], long_prompt], "w4sym")
    del oracle
    release()

    eng = ContinuousBatchingEngine(params=params, config=config, num_slots=8,
                                   max_len=SPEC_MAX_LEN, prefill_chunk=64,
                                   prefix_cache_entries=16, prefix_block=16, device=dev)
    calls = Calls()
    decode_s, prefill_s = [], []
    calls.count(eng, "_step_logits", key="decode", step=True, after=lambda r: hold_replay(
        "continuous", calls, "decode", 3, r,
        lambda: eng._decode_logits(eng._step_tokens, eng._step_pos)))
    calls.count(eng, "forward", key="prefill_forward", tokens=2)
    timed(eng, "_decode", decode_s)
    timed(eng, "_prefill", prefill_s, dev)
    reset_counters()
    rids = [eng.submit(p, max_new_tokens=NEW_TOKENS, **kw) for p, kw in requests]
    t0 = time.perf_counter()
    out = eng.run()
    total = time.perf_counter() - t0
    layers = config.num_layers
    launches = check_launches("continuous", {
        "w4sym": (calls["decode"] + calls["prefill_forward"]) * layers * 4})
    # the decode steps' 8 rows and each prefill chunk's (at most 64)
    mid = check_route("continuous", mid_of(layers, [(
        "w4sym", 4, [eng.num_slots] * calls["decode"] + calls.rows.get("prefill_forward", []))]),
        "mid")
    if eng.prefix_hits < 3:
        raise AssertionError(f"[continuous] prefix hits {eng.prefix_hits}, expected 3")
    tokens = [out[r] for r in rids]
    if [len(t) for t in tokens] != [NEW_TOKENS] * len(requests):
        raise AssertionError(f"[continuous] tokens {[len(t) for t in tokens]}")
    lps = [eng.finished_logprobs[r] for r in rids]
    if not all(len(lp) == NEW_TOKENS and all(np.isfinite(x) and x <= 0 for x in lp)
               for lp in lps):
        raise AssertionError("[continuous] logprobs missing, not finite or positive")
    want, logits = trajectory
    ties, decided = hold_tokens("continuous", tokens[:8], want, logits[:, :len(prompts)])
    hold_tokens("continuous (prefix hit, long prompt)", tokens[8:10], extra_out,
                extra_logits[:, :2])
    same = sum(a == b for a, b in zip(tokens[:10], list(want) + list(extra_out)))
    steps = calls["decode"]
    serving = dict(
        requests=len(requests), prompt_lengths=[len(p) for p, _ in requests],
        new_tokens=NEW_TOKENS, decode_steps=steps, prefill_forward_calls=calls["prefill_forward"],
        launches=launches, mid_launches=mid, prefix_hits=eng.prefix_hits,
        prefix_block_hits=eng.prefix_block_hits,
        prefill_ms_per_admission=float(np.median(prefill_s)) * 1e3,
        decode_ms_per_step=float(np.median(decode_s)) * 1e3,
        decode_ms_quickest=min(decode_s) * 1e3, decode_ms_steps=[x * 1e3 for x in decode_s],
        end_to_end_tok_s=len(requests) * NEW_TOKENS / total, first_ties=ties,
        decided_share=decided,
        identical_sequences=same, graph_step=calls.held.get("decode"))
    if dev.type == "cuda":
        with uncounted():
            serving["replay_device_ms"] = replay_ms(lambda i: eng._graph())
        serving["idle_share"] = 1 - serving["replay_device_ms"] / serving["decode_ms_per_step"]
        # the dense cache's attention: one layer's gqa_attention over the
        # 8 x 512 cache, L2-cold, times the layers
        cache = eng._cache
        hkv, d = config.num_kv_heads, config.head_dim
        q = torch.randn((8, 1, config.num_heads, d), device=dev).to(config.dtype)
        mask = torch.ones((8, 1, SPEC_MAX_LEN), dtype=torch.bool, device=dev)
        sets = [(q, cache["k"][i % layers], cache["v"][i % layers])
                for i in range(cold_copies(2 * cache["k"][0].numel() * 2))]
        attn_s = bench_cycled(lambda q_, k_, v_: llama.gqa_attention(q_, k_, v_, mask), sets)
        serving["attention_ms_per_step"] = attn_s * layers * 1e3
        serving["attention_share"] = serving["attention_ms_per_step"] / serving[
            "replay_device_ms"]
        serving["cache_bound_ms"] = (2 * layers * cache["k"][0].numel() * 2
                                     / HBM_BYTES_PER_S * 1e3)
        log(f"  [continuous] device {serving['replay_device_ms']:.2f} ms per replay, idle "
            f"share {serving['idle_share']:.2f}; the dense cache's attention "
            f"{serving['attention_ms_per_step']:.2f} ms per step ({hkv} KV heads x "
            f"{SPEC_MAX_LEN} positions x 8 slots x {layers} layers; bytes bound "
            f"{serving['cache_bound_ms']:.3f} ms), {100 * serving['attention_share']:.0f}% of "
            "the replay")
    log(f"  [continuous] {len(requests)} requests into 8 slots, {steps} decode steps: prefill "
        f"{serving['prefill_ms_per_admission']:.1f} ms per admission (median), decode "
        f"{serving['decode_ms_per_step']:.2f} ms/step graphed (median; quickest "
        f"{serving['decode_ms_quickest']:.2f}), {serving['end_to_end_tok_s']:.1f} tok/s end to end "
        f"(admissions and the capture included), prefix hits "
        f"{eng.prefix_hits} ({eng.prefix_block_hits} blocks); greedy tokens equal Engine's "
        f"before every near tie ({same}/10 identical in full); launches {launches}, "
        f"{mid['w4sym_mid']} of them on the mid route")
    del eng
    release()
    return serving


def timed(obj, attr, into, dev=None):
    """Wrap ``obj.attr`` to append its host-clock seconds to ``into`` (after
    a device sync when ``dev`` is given)."""

    def after(r, t0, *a):
        if dev is not None:
            sync(dev)
        into.append(time.perf_counter() - t0)

    wrap(obj, attr, after)


class RoundTimer:
    """The host-clock seconds of each round of a speculative engine
    (``eng._round``, which ends on the host), except ``n`` rounds from round
    ``at`` on (none when ``at`` is None): those run under torch.profiler,
    and their wall from the first one's start to the last one's end (the
    engine's work between rounds included) gives ``profile``; ``lengths()``
    is kept at the first one's start."""

    def __init__(self, name, eng, at=None, n=3, lengths=None):
        self.s, self.profile, self.rounds, self.lengths = [], None, 0, None
        window = range(at, at + n) if at is not None else range(0)

        def before(*a):
            if self.rounds == window.start and window:
                if lengths is not None:
                    self.lengths = lengths()
                self._prof = profiler()
                self._prof.start()
                self._t = time.perf_counter()

        def after(r, t0, *a):
            i = self.rounds
            self.rounds += 1
            if i not in window:
                self.s.append(time.perf_counter() - t0)
            elif i == window[-1]:
                torch.cuda.synchronize()
                wall = time.perf_counter() - self._t
                self._prof.stop()
                self.profile = profile_summary(f"{name}: {n} rounds", self._prof, wall, n)

        wrap(eng, "_round", after, before)


def spec_numbers(name, stats, round_s, tokens, replay, profile=None):
    """A timed speculative run's numbers: acceptance, bonus tokens, ms per
    round (median over the rounds not profiled), tokens per round (all
    rounds), tok/s (the two together), the graphs' device ms per replay, and
    the idle share and host waits of the profiled rounds."""
    out = dict(rounds=stats.rounds, proposed=stats.proposed, accepted=stats.accepted,
               acceptance_rate=stats.acceptance_rate, bonus_tokens=stats.bonus,
               ms_per_round=float(np.median(round_s)) * 1e3, ms_per_round_quickest=min(round_s)
               * 1e3, tokens_per_round=tokens / stats.rounds,
               tok_s=tokens / stats.rounds / float(np.median(round_s)),
               rounds_s=[float(x) for x in round_s])
    out.update(replay)
    if replay:
        # k draft replays and a verify: a round's device time, less the
        # catch-up fills and the small ops around the replays
        out["replays_ms_per_round"] = SPEC_K * replay["draft_replay_ms"] + replay[
            "verify_replay_ms"]
    if profile is not None:
        out["profile"] = profile
        out["idle_share"] = profile["idle_share"]
        out["host_waits_per_round"] = profile["host_waits_per_step"]
    log(f"  [{name}] {stats.rounds} rounds: acceptance {stats.acceptance_rate:.3f}, "
        f"{stats.bonus} bonus tokens (slot-rounds fully accepted), {out['ms_per_round']:.2f} ms "
        f"per round (median of {len(round_s)}; quickest "
        f"{out['ms_per_round_quickest']:.2f}), {out['tokens_per_round']:.2f} tokens per round, "
        f"{out['tok_s']:.1f} tok/s"
        + (f"; device {replay['draft_replay_ms']:.2f} ms per draft replay, "
           f"{replay['verify_replay_ms']:.2f} ms per verify replay" if replay else "")
        + (f", idle share {out['idle_share']:.2f}, {out['host_waits_per_round']:.1f} host waits "
           "per round" if out.get("idle_share") is not None else ""))
    return out


def spec_replays(eng) -> dict:
    """Device ms per replay of the draft and verify graphs (on the state the
    engine is in: they rewrite the same K/V)."""
    with uncounted():
        return dict(draft_replay_ms=replay_ms(lambda i: eng._draft_graph()),
                    verify_replay_ms=replay_ms(lambda i: eng._verify_graph()))


def serve_dense_spec(dev, config, target, drafts, trajectory):
    """SpeculativeEngine (dense caches), batch 8, k = 4, max_len 512: the
    self-draft and the W2 draft. A checked run on the 8 prompts (tokens held
    to Engine's before near ties, the graphed draft and verify steps bit for
    bit against the eager steps, exact launches), then a timed run of
    bench_serving's prompts and length with the graphs captured and no
    hold, three of its rounds profiled, then the verify rows against
    Engine's logits."""
    from flute_tpu_torch.serving import SpecStats, SpeculativeEngine

    prompts = serving_prompts(config)
    want, logits = trajectory
    layers = config.num_layers
    cuda = dev.type == "cuda"
    out = {}
    for name, (dparams, layout) in drafts.items():
        label = f"dense spec {name}"
        eng = SpeculativeEngine(target, config, dparams, config, k=SPEC_K, max_len=SPEC_MAX_LEN,
                                batch_size=8, device=dev)
        calls = Calls()
        hold_steps(label, eng, calls,
                   lambda: eng.draft_logits(eng._d_tok, eng._d_pos_buf, eng._offsets),
                   lambda: eng.verify_logits(eng._v_toks, eng._t_pos, eng._offsets))
        calls.count(eng, "_t_fwd", key="target_prefill", tokens=2)
        calls.count(eng, "_d_fwd", key="draft_prefill", tokens=2)
        reset_counters()
        tokens = eng.generate(prompts, max_new_tokens=NEW_TOKENS)
        # one target and one draft prefill; each draft step and verify
        expected = {"w4sym": (calls["verify"] + 1) * layers * 4}
        expected[layout] = expected.get(layout, 0) + (calls["draft"] + 1) * layers * 4
        if calls["target_prefill"] != 1 or calls["draft_prefill"] != 1:
            raise AssertionError(f"[{label}] prefills {calls.n}, expected one of each")
        launches = check_launches(label, expected)
        # the verify's 8 (k + 1) rows, the draft steps' 8, the prefills'
        mid = check_route(label, mid_of(layers, [
            ("w4sym", 4, [VERIFY_M] * calls["verify"] + calls.rows["target_prefill"]),
            (layout, LAYOUT_BITS[layout], [8] * calls["draft"] + calls.rows["draft_prefill"])]),
            "mid")
        ties, same = hold_to_oracle(label, tokens, want, decided_steps(logits[:, :8]))
        if any(len(t) != NEW_TOKENS for t in tokens):
            raise AssertionError(f"[{label}] tokens {[len(t) for t in tokens]}")
        checked = dict(draft_calls=calls["draft"],
                       verify_calls=calls["verify"], first_ties=ties, identical_sequences=same,
                       graph_steps=dict(calls.held), stats=dataclasses.asdict(eng.stats))
        log(f"  [{label}] tokens equal Engine's before every near tie ({same}/8 identical in "
            f"full); launches {launches}, on the mid route {mid}")
        eng.stats = SpecStats()
        timer = RoundTimer(label, eng, at=10 if cuda else None)
        n_tokens = SPEC_BUDGETS[name]
        with uncounted():
            timed_out = eng.generate(spec_prompts(config), max_new_tokens=n_tokens)
        if [len(t) for t in timed_out] != [n_tokens] * 8:
            raise AssertionError(f"[{label}] timed run: tokens {[len(t) for t in timed_out]}")
        replay = spec_replays(eng) if cuda else {}
        numbers = spec_numbers(f"{label}, 8 x {n_tokens} tokens", eng.stats, timer.s,
                               sum(len(t) - 1 for t in timed_out), replay, timer.profile)
        numbers.update(launches=launches, mid_launches=mid, checked_run=checked,
                       tokens_per_request=n_tokens)
        if cuda and name == "self-draft":
            numbers["verify_route_ab"] = verify_route_ab(dev, config, target, dparams, timed_out)
        # once more, untimed and uncounted: every verify row with Engine's
        # history against Engine's logits (prompts left-padded to 64)
        rows = VerifyRows(eng, lambda: eng._t_pos, lambda b: 64, want, logits)
        with uncounted():
            eng.generate(prompts, max_new_tokens=NEW_TOKENS)
        numbers["verify_logits"] = rows.check(label)
        out[name] = numbers
        del eng
        release()
    return out


def verify_route_ab(dev, config, target, draft, want):
    """The self-draft SpeculativeEngine's timed run once more on each route
    of the verify's 40 rows, in turns (mid, loop, loop, mid: the mid route
    at the plan's MID_MIN_M, the loop with MID_MIN_M past 40), each on a
    new engine that captures its graphs anew: ms per round (median),
    tok/s and the graphs' device ms per replay, within one call. Every run
    must give the timed run's tokens: the routes give a row the same
    bits. Uncounted."""
    from flute_tpu_torch.ops import kernel_config
    from flute_tpu_torch.serving import SpeculativeEngine

    runs = {"mid": [], "loop": []}
    for route in ("mid", "loop", "loop", "mid"):
        with route_bounds(mid=None if route == "mid" else 1 << 30):
            if kernel_config.mma_route(VERIFY_M, 4, 256, "w4sym", GROUP) != route:
                raise AssertionError(f"[verify route A/B] the verify does not take the {route} "
                                     "route")
            eng = SpeculativeEngine(target, config, draft, config, k=SPEC_K,
                                    max_len=SPEC_MAX_LEN, batch_size=8, device=dev)
            timer = RoundTimer(f"verify on the {route} route", eng)
            with uncounted():
                out = eng.generate(spec_prompts(config), max_new_tokens=len(want[0]))
            if out != want:
                raise AssertionError(f"[verify route A/B] the {route} route gave other tokens")
            replay = spec_replays(eng)
        runs[route].append(dict(
            ms_per_round=float(np.median(timer.s)) * 1e3, rounds=eng.stats.rounds,
            tok_s=sum(len(t) - 1 for t in out) / eng.stats.rounds / float(
                np.median(timer.s)), **replay))
        del eng
        release()
    out = {route: {key: float(np.mean([r[key] for r in rs])) for key in rs[0]}
           for route, rs in runs.items()}
    out["runs"] = runs
    log(f"  [verify route A/B] dense self-draft, mid / loop (mean of two turns each): "
        f"{out['mid']['ms_per_round']:.2f} / {out['loop']['ms_per_round']:.2f} ms per round, "
        f"{out['mid']['tok_s']:.1f} / {out['loop']['tok_s']:.1f} tok/s, verify replay "
        f"{out['mid']['verify_replay_ms']:.2f} / {out['loop']['verify_replay_ms']:.2f} ms, "
        f"draft replay {out['mid']['draft_replay_ms']:.2f} / "
        f"{out['loop']['draft_replay_ms']:.2f} ms; the same tokens")
    return out


def spec_prompts(config):
    """scripts/bench_serving.py's prompts: 16 tokens each, request i from
    default_rng(i) over [1, 1000) (the vocabulary, if smaller)."""
    top = min(1000, config.vocab_size)
    return [np.random.default_rng(i).integers(1, top, 16).tolist() for i in range(8)]


def paged_oracle(dev, config, params, prompts, budget):
    """PagedEngine's greedy tokens (T = 1 steps, K5) for the paged
    speculative runs, and which of their steps are decided (first token from
    the prefill row, then each decode step's row)."""
    from flute_tpu_torch.serving import PagedEngine

    eng = PagedEngine(params=params, config=config, num_slots=8, block_size=SPEC_BLOCK,
                      num_blocks=8 * (SPEC_MAX_LEN // SPEC_BLOCK) + 8, max_len=SPEC_MAX_LEN,
                      device=dev)
    decided, first, decode_s, rows = [], {}, [], []

    def recorded(r, t0):
        decided.append(decided_steps(r).cpu())
        if len(rows) < NEW_TOKENS - 1:
            rows.append(r.cpu())

    wrap(eng, "_step_logits", recorded)
    timed(eng, "_decode", decode_s)  # ends with a copy to the host
    record_first(eng, first)
    rids = [eng.submit(p, max_new_tokens=budget) for p in prompts]
    t0 = time.perf_counter()
    out = eng.run()
    total = time.perf_counter() - t0
    first_decided = decided_steps(torch.stack([first[r] for r in rids]))
    # request i sits in slot i throughout: every one is admitted at once
    table = torch.stack([first_decided] + decided[: budget - 1])
    # row t: the logits that chose output token t of each request
    logits = torch.stack([torch.stack([first[r] for r in rids])] + rows)
    numbers = dict(steps=len(decided), s=total,
                   decode_ms_per_step=float(np.median(decode_s)) * 1e3,
                   decode_tok_s=8 / float(np.median(decode_s)))
    log(f"  [paged oracle] PagedEngine greedy, 8 requests x {budget} tokens in {total:.1f} s: "
        f"{len(decided)} graphed T=1 steps, {numbers['decode_ms_per_step']:.2f} ms per step "
        f"(median), {numbers['decode_tok_s']:.1f} decode tok/s")
    del eng
    release()
    return [out[r] for r in rids], table, logits, numbers


# a verify row's largest logit error relative to the oracle's largest
# logit: sound verifies read 4.5e-2 to 5.7e-2 at Llama-3.1-8B widths
# (K6 and torch attention at T = 5 against K5 and torch attention at T = 1);
# phase 6 holds each paged run to it and shows that a planted fault reads
# above it
VERIFY_LIMIT = 0.25


class VerifyRows:
    """Holds a speculative engine's verify rows to its T = 1 oracle's
    logits: query j of slot b at cache position ``pos[b] + j`` predicts
    output token ``t = pos[b] + j - start + 1`` of request b from the tokens
    written at positions ``start .. pos[b] + j``; where those are the
    oracle's first t tokens and t is within ``logits`` [T, B, V] (row t:
    the oracle's logits for token t), the row's largest difference from the
    oracle's, relative to the oracle's largest logit, is kept. Wraps
    ``eng._verify_step``; ``positions()`` reads the step's positions and
    ``start(b)`` where request b's outputs begin.

    With ``probe`` (a paged engine), the first verify with such rows is
    also run eagerly twice more on the same inputs: with K6 given lengths
    one short (a planted fault: no query attends its own position), whose
    rows must read above the limit, and with K6's plain version
    (``paged_verify_reference``) on the same pools, which the served rows
    must match within the limit; a third eager run with K6 then writes the
    step's own K/V back."""

    def __init__(self, eng, positions, start, want, logits, probe=False):
        self.written = [dict() for _ in want]
        self.errs, self.probed = [], {}

        def checked(r, t0):
            toks = eng._v_toks.cpu().numpy()
            pos = positions().cpu().numpy()
            rows = []
            for b, row in enumerate(want):
                for j, tok in enumerate(toks[b]):
                    self.written[b][int(pos[b]) + j] = int(tok)
                for j in range(toks.shape[1]):
                    s0, p = start(b), int(pos[b]) + j
                    t = p - s0 + 1
                    hist = [self.written[b].get(q) for q in range(s0, p + 1)]
                    if 0 < t < logits.shape[0] and hist == row[:t]:
                        rows.append((b, j, logits[t, b].to(r.device)))
            self.errs += [rel(r[b, j], ref) for b, j, ref in rows]
            if probe and rows and not self.probed:
                self.probed = self._probe(eng, r.clone(), rows)

        def rel(got, ref):
            return float((got - ref).abs().max() / ref.abs().max())

        self._rel = rel
        wrap(eng, "_verify_step", checked)

    def _probe(self, eng, served, rows):
        from flute_tpu_torch.ops import paged_attention as pa
        from flute_tpu_torch.serving import paged_fwd

        k6 = paged_fwd.paged_verify_attention
        args = (eng._step_tables, eng._step_lengths, eng._v_toks)

        def verify_with(attention):
            paged_fwd.paged_verify_attention = attention
            try:
                return eng._verify_logits(*args).clone()
            finally:
                paged_fwd.paged_verify_attention = k6

        fault = verify_with(lambda q, kp, vp, tb, ln, **kw: k6(q, kp, vp, tb, ln - 1, **kw))
        plain = verify_with(lambda q, kp, vp, tb, ln, **kw: pa.paged_verify_reference(
            q, kp, vp, torch.clamp(tb.long(), 0, kp.shape[0] - 1), ln, **kw))
        eng._verify_logits(*args)  # K6 again: the step's own K/V
        live = sorted({b for b, _, _ in rows})
        return dict(fault_rel_err=max(self._rel(fault[b, j], ref) for b, j, ref in rows),
                    plain_rel_err=float((served[live] - plain[live]).abs().max()
                                        / plain[live].abs().max()))

    def check(self, name, limit=VERIFY_LIMIT):
        """The rows compared and their largest error, within ``limit``; with
        a probe, the plain version's reading within it and the planted
        fault's above it."""
        err = max(self.errs, default=float("nan"))
        if not self.errs or not err < limit:
            raise AssertionError(f"[{name}] verify logits against the T=1 oracle's: "
                                 f"{len(self.errs)} rows, max rel err {err}")
        out = dict(rows=len(self.errs), max_rel_err=err, limit=limit, **self.probed)
        probe = ""
        if self.probed:
            fault, plain = self.probed["fault_rel_err"], self.probed["plain_rel_err"]
            if not plain < limit <= fault:
                raise AssertionError(f"[{name}] the verify check at limit {limit}: K6 against "
                                     f"its plain version {plain:.3e}, a planted fault (lengths "
                                     f"one short) {fault:.3e}")
            probe = (f"; against K6's plain version on the same pools {plain:.2e}; a planted "
                     f"fault (lengths one short) reads {fault:.2e}")
        log(f"  [{name}] {len(self.errs)} verify rows with the oracle's history: logits within "
            f"{err:.2e} of the T=1 oracle's (limit {limit}){probe}")
        return out


def paged_spec_engine(dev, config, target, draft, pool=False):
    """bench_serving's PagedSpeculativeEngine: 8 slots, k = 4, blocks of
    32, max_len 512, a block per slot and position plus 8."""
    from flute_tpu_torch.serving import PagedSpeculativeEngine

    return PagedSpeculativeEngine(
        params=target, config=config, draft_params=draft, draft_config=config, k=SPEC_K,
        num_slots=8, block_size=SPEC_BLOCK, num_blocks=8 * (SPEC_MAX_LEN // SPEC_BLOCK) + 8,
        max_len=SPEC_MAX_LEN, pool_prefill=pool, prefill_chunk=16 if pool else None, device=dev)


def count_paged_spec(label, eng, calls):
    """Count a paged speculative engine's calls and hold its replays."""
    hold_steps(label, eng, calls, lambda: eng._draft_logits(eng._d_tok, eng._d_pos_buf),
               lambda: eng._verify_logits(eng._step_tables, eng._step_lengths, eng._v_toks))
    calls.count(eng, "forward", key="target_prefill", tokens=2)
    calls.count(eng, "_dfwd", key="draft_prefill", tokens=2)
    if eng._pool_fwd is not None:
        calls.count(eng, "_pool_fwd", key="pool_chunks", tokens=5)


def check_paged_spec_launches(label, calls, layers, layout):
    """K1 four times a layer per target forward (verify, dense prefill or
    pool chunk) and the draft's kernel per draft forward (step or
    prefill); K6 once a layer per verify and pool chunk; nothing else; and
    of those, on the mid route, each forward whose rows the plan sends
    there (the verify's 8 (k + 1), a 32-row draft prefill). Returns the
    launches and the mid route's."""
    target_calls = calls["verify"] + calls["target_prefill"] + calls["pool_chunks"]
    draft_calls = calls["draft"] + calls["draft_prefill"]
    expected = {"w4sym": target_calls * layers * 4,
                "paged_verify": (calls["verify"] + calls["pool_chunks"]) * layers}
    expected[layout] = expected.get(layout, 0) + draft_calls * layers * 4
    launches = check_launches(label, expected)
    mid = check_route(label, mid_of(layers, [
        ("w4sym", 4, [VERIFY_M] * calls["verify"] + calls.rows.get("target_prefill", [])
         + calls.rows.get("pool_chunks", [])),
        (layout, LAYOUT_BITS[layout], [8] * calls["draft"] + calls.rows.get("draft_prefill",
                                                                              []))]), "mid")
    return launches, mid


def serve_paged_spec(dev, config, target, drafts):
    """PagedSpeculativeEngine, batch 8, k = 4, blocks of 32, max_len 512,
    16-token prompts (scripts/bench_serving.py:97-125): the self-draft (248
    tokens per request, about 48 rounds) and the W2 draft (56 tokens) with
    dense prefill, then the self-draft with pool prefill. A checked run
    (tokens held to PagedEngine's before near ties, exact K6 and K1/K2
    launches, each graphed draft and verify replay bit for bit against its
    eager step, the graphs' device ms per replay at round 10, no block in
    use at the end), then the same requests again, timed with no hold
    (three rounds from round 10 profiled: K6's µs per served verify call),
    which must give the same tokens; then the verify rows against
    PagedEngine's logits, with a planted fault and K6's plain version."""
    from flute_tpu_torch.serving import SpecStats

    prompts = spec_prompts(config)
    layers = config.num_layers
    cuda = dev.type == "cuda"
    budget = max(SPEC_BUDGETS.values())
    want, decided, oracle_logits, oracle = paged_oracle(dev, config, target, prompts, budget)
    out = {"oracle": oracle}
    runs = [(name, draft, layout, SPEC_BUDGETS[name], False)
            for name, (draft, layout) in drafts.items()]
    runs.append(("self-draft pool prefill", drafts["self-draft"][0], "w4sym", 24, True))
    for name, dparams, layout, n_tokens, pool in runs:
        label = f"paged spec {name}"
        eng = paged_spec_engine(dev, config, target, dparams, pool)
        calls = Calls()
        count_paged_spec(label, eng, calls)
        replay, peak = {}, 0
        reset_counters()
        rids = [eng.submit(p, max_new_tokens=n_tokens) for p in prompts]
        while eng.step():
            peak = max(peak, eng.blocks_in_use)
            if eng.stats.rounds == 10 and cuda and not replay:
                replay = spec_replays(eng)
        res = eng.run()
        tokens = [res[r] for r in rids]
        if eng.blocks_in_use != 0:
            raise AssertionError(f"[{label}] {eng.blocks_in_use} blocks in use after the run")
        if [len(t) for t in tokens] != [n_tokens] * len(prompts):
            raise AssertionError(f"[{label}] tokens {[len(t) for t in tokens]}")
        launches, mid = check_paged_spec_launches(label, calls, layers, layout)
        ties, same = hold_to_oracle(label, tokens, want, decided)
        checked = dict(calls=dict(calls.n), first_ties=ties,
                       identical_sequences=same, graph_steps=dict(calls.held),
                       peak_blocks_in_use=peak, stats=dataclasses.asdict(eng.stats))
        log(f"  [{label}] tokens equal PagedEngine's before every near tie ({same}/8 identical "
            f"over their length); no block in use at the end (peak {peak}); launches "
            f"{launches}, on the mid route {mid}")
        eng.stats = SpecStats()
        timer = RoundTimer(label, eng, at=10 if cuda and not pool else None,
                           lengths=lambda: eng._lengths.tolist())
        with uncounted():
            rids = [eng.submit(p, max_new_tokens=n_tokens) for p in prompts]
            res = eng.run()
        if [res[r] for r in rids] != tokens or eng.blocks_in_use != 0:
            raise AssertionError(f"[{label}] the timed run of the same requests gave other "
                                 f"tokens, or left {eng.blocks_in_use} blocks in use")
        numbers = spec_numbers(f"{label}, 8 x {n_tokens} tokens", eng.stats, timer.s,
                               sum(len(t) - 1 for t in tokens), replay, timer.profile)
        numbers.update(launches=launches, mid_launches=mid, checked_run=checked,
                       tokens_per_request=n_tokens)
        if not pool:
            # the same requests once more, untimed and uncounted: every
            # verify row with the oracle's history against its logits
            rows = VerifyRows(eng, lambda: eng._step_lengths, lambda b: len(prompts[b]), want,
                              oracle_logits, probe=True)
            with uncounted():
                for p in prompts:
                    eng.submit(p, max_new_tokens=NEW_TOKENS)
                eng.run()
            numbers["verify_logits"] = rows.check(label)
        if timer.profile is not None and timer.profile["groups_ms_per_step"] is not None:
            k6_us = timer.profile["groups_ms_per_step"]["K6"] * 1e3 / layers
            numbers["k6_us_per_served_call"] = k6_us
            numbers["k6_bound_us"] = verify_bound_us(config, timer.lengths)
            log(f"  [{label}] K6 {k6_us:.2f} us per served verify call (T={SPEC_K + 1}, 8 "
                f"slots; bound about {numbers['k6_bound_us']:.2f} us at the profiled "
                "lengths)")
        numbers["over_paged_engine"] = numbers["tok_s"] / oracle["decode_tok_s"]
        log(f"  [{label}] {numbers['over_paged_engine']:.2f}x PagedEngine's decode tok/s")
        out[name] = numbers
        del eng
        release()
    out["sampled"] = serve_paged_sampled(dev, config, target, prompts, want, decided)
    return out


def serve_paged_sampled(dev, config, target, prompts, want, decided):
    """The sampled round on the card: the self-draft PagedSpeculativeEngine
    with requests 0 and 1 sampled (temperature 0.8, top-k 50, top-p 0.9),
    request 3 the prompt of request 2 at top-k 1, and the rest greedy; then
    the same sampled requests beside other greedy neighbours. A sampled
    request's tokens depend on its seed alone (the same in both runs); the
    top-k 1 request is its greedy twin's stream; greedy tokens equal
    PagedEngine's before near ties; exact launches; no block in use. The
    second run's rounds are timed, three of them profiled."""
    from flute_tpu_torch.serving import SamplingParams, SpecStats

    n_tokens, layers, label = 40, config.num_layers, "paged spec sampled"
    eng = paged_spec_engine(dev, config, target, target)
    sampled = [SamplingParams(temperature=0.8, top_k=50, top_p=0.9, seed=s) for s in (21, 22)]
    top1 = SamplingParams(temperature=1.0, top_k=1, seed=23)
    greedy = SamplingParams()
    runs = []
    for order in ((4, 5, 6, 7), (7, 6, 5, 4)):
        requests = [(prompts[0], sampled[0]), (prompts[1], sampled[1]), (prompts[2], greedy),
                    (prompts[2], top1)] + [(prompts[i], greedy) for i in order]
        calls, timer = Calls(), None
        if runs:
            eng.stats = SpecStats()
            timer = RoundTimer(label, eng, at=3 if dev.type == "cuda" else None)
        else:
            count_paged_spec(label, eng, calls)
            reset_counters()
        rids = [eng.submit(p, max_new_tokens=n_tokens, sampling=sp) for p, sp in requests]
        res = eng.run()
        tokens = [res[r] for r in rids]
        if [len(t) for t in tokens] != [n_tokens] * 8 or eng.blocks_in_use != 0:
            raise AssertionError(f"[{label}] tokens {[len(t) for t in tokens]}, "
                                 f"{eng.blocks_in_use} blocks in use at the end")
        if tokens[3] != tokens[2]:
            raise AssertionError(f"[{label}] top-k 1 {tokens[3]} != greedy {tokens[2]}")
        idx = [2] + list(order)
        hold_to_oracle(label, [tokens[i] for i in [2, 4, 5, 6, 7]], [want[i] for i in idx],
                       decided[:, idx])
        if not runs:
            launches, mid = check_paged_spec_launches(label, calls, layers, "w4sym")
        runs.append(dict(tokens=tokens, timer=timer))
    if runs[0]["tokens"][:2] != runs[1]["tokens"][:2]:
        raise AssertionError(f"[{label}] sampled tokens changed with their neighbours")
    timer = runs[1]["timer"]
    numbers = spec_numbers(f"{label}, 8 x {n_tokens} tokens (2 sampled, 1 top-k 1)", eng.stats,
                           timer.s, sum(len(t) - 1 for t in runs[1]["tokens"]), {},
                           timer.profile)
    numbers.update(launches=launches, mid_launches=mid, tokens_per_request=n_tokens,
                   sampled_tokens=runs[0]["tokens"][:2])
    log(f"  [{label}] the sampled requests' tokens are the same beside other neighbours; the "
        f"top-k 1 request is its greedy twin's stream; greedy tokens equal PagedEngine's before "
        f"every near tie; no block in use at the end; launches {launches}")
    del eng
    release()
    return numbers


def check_verify_rows(dev, config, models):
    """The verify's LUT-GEMM rows: each projection of layer 0 called at
    M = 8 (k+1) = 40 gives, on every fifth row, the bits of the M = 8 call
    on those rows (the loop's split does not follow M); and one layer's
    four projections timed at M = 8 and M = 40, L2-cold over the 32
    layers."""
    from flute_tpu_torch.utils.benchmark import bench_cycled

    m = 8 * (SPEC_K + 1)
    gen = torch.Generator(device=dev)
    gen.manual_seed(9)
    out = {}
    for kid, params in models.items():
        layers = params["layers"]
        same = {}
        for proj in ("qkv", "o", "gate_up", "down"):
            lin = layers[0][proj]
            x = torch.randn((m, lin.in_features), generator=gen, device=dev).to(config.dtype)
            with torch.inference_mode():
                y = lin(x)
                y8 = lin(x[::SPEC_K + 1])
            same[proj] = torch.equal(y[::SPEC_K + 1].view(torch.int16), y8.view(torch.int16))
        if not all(same.values()):
            raise AssertionError(f"[verify rows] {kid}: rows at M={m} differ from M=8: {same}")
        numbers = dict(bit_identical=same)
        if dev.type == "cuda":
            for rows in (8, m):
                xs = {proj: torch.randn((rows, layers[0][proj].in_features), generator=gen,
                                        device=dev).to(config.dtype)
                      for proj in ("qkv", "o", "gate_up", "down")}

                def layer_call(layer):
                    for proj, x in xs.items():
                        layer[proj](x)

                with torch.inference_mode():
                    numbers[f"us_per_layer_m{rows}"] = bench_cycled(
                        layer_call, [(layer,) for layer in layers]) * 1e6
        out[kid] = numbers
        log(f"  [verify rows] {kid}: every row of each layer-0 projection at M={m} has the bits "
            f"of the M=8 call" + (f"; one layer's four projections "
                                  f"{numbers['us_per_layer_m8']:.1f} us at M=8, "
                                  f"{numbers[f'us_per_layer_m{m}']:.1f} us at M={m}"
                                  if dev.type == "cuda" else ""))
    return out


def verify_bound_us(config, lengths, t=SPEC_K + 1, bs=SPEC_BLOCK):
    """The least time of one K6 call at the served verify shape: each slot's
    live blocks read once and q/out moved (bytes), or 4 H D per attended
    position (operations), the larger."""
    h, hkv, d = config.num_heads, config.num_kv_heads, config.head_dim
    blocks = sum(-(-(n + t) // bs) for n in lengths)
    nbytes = blocks * hkv * bs * d * 2 * 2 + 2 * len(lengths) * t * h * d * 2
    flops = 4 * h * d * sum(n + j + 1 for n in lengths for j in range(t))
    return max(nbytes / HBM_BYTES_PER_S, flops / BF16_OPS_PER_S) * 1e6


def phase_spec(dev, results, trajectory, config=None):
    """Phase 6: Llama-3.1-8B (random weights from seed 0, as phase 4's),
    quantized on the card at g64, fused: the w4sym target (K1) and a W2
    draft of the same weights (general 2-bit table, K2); then
    ContinuousBatchingEngine, SpeculativeEngine and PagedSpeculativeEngine."""
    from flute_tpu_torch.models import llama

    config = config or llama.LlamaConfig.llama31_8b()
    held = torch.cuda.memory_allocated(dev) if dev.type == "cuda" else 0
    t0 = time.perf_counter()
    params = llama.init_params(config, seed=0, device=dev)
    target = llama.quantize_model(params, group_size=GROUP, fuse=True, device=dev)
    draft = llama.quantize_model(params, num_bits=2, group_size=GROUP, fuse=True, device=dev)
    del params
    release()
    sync(dev)
    gib = ((torch.cuda.memory_allocated(dev) - held) / 2**30) if dev.type == "cuda" else 0.0
    log(f"  [spec] built the w4sym target and the W2 draft in {time.perf_counter() - t0:.1f} s, "
        f"{gib:.2f} GiB allocated")
    drafts = {"self-draft": (target, "w4sym"), "W2 draft": (draft, "plane")}
    out = dict(verify_rows=check_verify_rows(dev, config, {"K1": target, "K2": draft}),
               continuous=serve_continuous(dev, config, target, trajectory),
               dense_spec=serve_dense_spec(dev, config, target, drafts, trajectory),
               paged_spec=serve_paged_spec(dev, config, target, drafts))
    # the mid route's launches over the phase's checked runs
    runs = [out["continuous"], *out["dense_spec"].values(),
            *(v for key, v in out["paged_spec"].items() if key != "oracle")]
    out["mid_launches"] = {key: sum(run["mid_launches"][key] for run in runs)
                           for key in runs[0]["mid_launches"]}
    log(f"  [spec] mid-route launches over the phase's checked runs: {out['mid_launches']}")
    del target, draft, drafts
    release()
    results["serving"]["spec"] = out
    return out


# ---------------------------------------------------------------------------
# Phase 7: the quantized lm_head, the HTTP server and perplexity
# ---------------------------------------------------------------------------

# the quantized heads, [N = vocab padded to a multiple of 2048, K = hidden]:
# Llama-3.1-8B's (128256 -> 129024) and Gemma-2-9B's tied head (its 256000
# tokens, already a multiple)
HEAD_SHAPES = {"llama31_8b": (129024, 4096, 128256), "gemma2_9b": (256000, 3584, 256000)}
HEAD_M = (1, 8)
HEAD_CONTRACT = 0.15  # tests/test_quantized_head.py:30
SERVER_TOKENS = 24
PAGED_SERVER_TOKENS = 12
PPL_SEQ = 2048
PPL_WINDOWS = 2


def k1_case(dev, gen, name, n, k, m, dense_n=None, dense_t=False):
    """K1 (w4sym, bf16) at one shape: held against its plain version
    (relative Frobenius error), rows 0 and M-1 to the one-row call's bits
    and a repeat call to the same bits; then K1, its plain version and the
    yardstick timed, L2-cold: ``matmul_f32`` on a dense bf16 weight of
    ``dense_n`` columns (the head the step multiplies today: ``[K, N]``, or
    ``[N, K]`` read through its transpose with ``dense_t``, as Gemma-2's
    tied head is), else a bf16 ``torch.matmul`` on the dequantized weight.
    Random planes: any bits are valid w4sym codes. Against the dequantized
    weight the kernel is held to the threshold too."""
    from flute_tpu_torch.models.llama import matmul_f32
    from flute_tpu_torch.ops import lut_gemm
    from flute_tpu_torch.ops.kernel_config import KernelConfig
    from flute_tpu_torch.utils.benchmark import bench_cycled, cold_copies

    planes = [torch.randint(-2**31, 2**31 - 1, (k // 8, n), generator=gen, device=dev,
                            dtype=torch.int32)]
    scales = (torch.rand((k // GROUP, n), generator=gen, device=dev) + 0.5).bfloat16()
    mags = torch.randn(8, generator=gen, device=dev).abs().sort().values
    table = torch.cat([mags, -mags])
    x = torch.randn((m, k), generator=gen, device=dev).bfloat16()
    kw = dict(num_bits=4, layout="w4sym", config=KernelConfig(chunk=256))
    label = f"{name} M={m}"
    y = lut_gemm.lut_qgemm(x, planes, scales, table, **kw)
    y_plain = lut_gemm.lut_qgemm_plain(x, planes, scales, table, num_bits=4, chunk=256,
                                       layout="w4sym")
    again = lut_gemm.lut_qgemm(x, planes, scales, table, **kw)
    if not torch.equal(again.view(torch.int16), y.view(torch.int16)):
        raise AssertionError(f"K1 {label}: a repeat call gave other bits")
    if m > 1:
        check_rows("K1", label, x, y, lambda xr: lut_gemm.lut_qgemm(xr, planes, scales, table,
                                                                    **kw))
    err = rel_err(y, y_plain)
    max_abs = float((y.float() - y_plain.float()).abs().max())
    if not err < THRESHOLDS[torch.bfloat16]:
        raise AssertionError(f"K1 {label}: rel err {err}")
    del y, y_plain, again
    wbytes = planes[0].numel() * 4 + scales.numel() * 2
    args = [([p.clone() for p in planes], scales.clone()) for _ in range(cold_copies(wbytes))]
    t_k = bench_cycled(lambda p, s: lut_gemm.lut_qgemm(x, p, s, table, **kw), args)
    t_p = bench_cycled(lambda p, s: lut_gemm.lut_qgemm_plain(x, p, s, table, num_bits=4, chunk=256,
                                                         layout="w4sym"),
                   args[:2], min_launches=2)
    del args
    if dense_n is not None:
        shape = (dense_n, k) if dense_t else (k, dense_n)
        dense = [torch.randn(shape, generator=gen, device=dev).bfloat16()
                 for _ in range(cold_copies(k * dense_n * 2))]
        t_l = bench_cycled(lambda w: matmul_f32(x, w.T if dense_t else w), [(w,) for w in dense])
        library_bytes = k * dense_n * 2 + m * k * 2 + m * dense_n * 4
        yardstick = "matmul_f32 on the dense bf16 head"
    else:
        deq = lut_gemm.dequantize_codes(
            lut_gemm._packing.unpack(planes, 4, chunk=256, layout="w4sym"), scales, table,
            torch.bfloat16)
        library_err = rel_err(lut_gemm.lut_qgemm(x, planes, scales, table, **kw),
                              torch.matmul(x, deq))
        if not library_err < THRESHOLDS[torch.bfloat16]:
            raise AssertionError(f"K1 {label}: rel err {library_err} against torch.matmul on "
                                 "the dequantized weight")
        deq_c = [deq.clone() for _ in range(cold_copies(deq.numel() * 2))]
        del deq
        t_l = bench_cycled(lambda w: torch.matmul(x, w), [(w,) for w in deq_c])
        del deq_c
        library_bytes = k * n * 2 + m * k * 2 + m * n * 2
        yardstick = "torch.matmul on the dequantized bf16 weight"
    nbytes = wbytes + table.numel() * 4 + m * k * 2 + m * n * 2
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, 2 * m * n * k / BF16_OPS_PER_S
    case = dict(kernel="K1", name=name, n=n, k=k, m=m, dtype="bfloat16", rel_err=err,
                max_abs_err=max_abs, path=kernel_path("K1", torch.bfloat16, 4), bytes=nbytes,
                us=t_k * 1e6, plain_us=t_p * 1e6, library_us=t_l * 1e6,
                bound_us=max(t_bytes, t_ops) * 1e6,
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                library_bound_us=library_bytes / HBM_BYTES_PER_S * 1e6, yardstick=yardstick)
    case["share_of_bound"] = case["bound_us"] / case["us"]
    log(f"    {label:22s} err={err:.2e} kernel {case['us']:9.1f} us  bound "
        f"{case['bound_us']:7.1f} us ({case['bound_by']}, {100 * case['share_of_bound']:5.1f}%)  "
        f"plain {case['plain_us']:9.1f} us  yardstick {case['library_us']:8.1f} us (its bound "
        f"{case['library_bound_us']:.1f} us)")
    return case


def measured(value, unit="") -> str:
    return "not measured" if value is None else f"{value:.2f}{unit}"


def check_heads(dev):
    """Phase 7a: K1 at the two quantized heads (M = 1 and 8) and at the
    perplexity prefill (M = 2047, one Llama-3.1-8B layer's projections)."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(7)
    cases = []
    for model, (n, k, vocab) in HEAD_SHAPES.items():
        log(f"  K1 at {model}'s quantized head [{n}, {k}] (vocab {vocab})")
        for m in HEAD_M:
            cases.append(dict(k1_case(dev, gen, f"{model} head", n, k, m, dense_n=vocab,
                                      dense_t=model == "gemma2_9b"), model=model))
    log(f"  K1 at the perplexity prefill, M = {PPL_SEQ - 1} (one window of {PPL_SEQ})")
    for name, n, k in LAYER_SHAPES:
        cases.append(dict(k1_case(dev, gen, name, n, k, PPL_SEQ - 1), model="llama31_8b"))
    release()
    return cases


def head_stack(cases, model, m):
    return [c for c in cases if c["model"] == model and c["m"] == m and c["name"].endswith("head")]


class StubTokenizer:
    """The duck-typed tokenizer of tests/test_server.py:291-310: the chat
    template flattens the messages' ids with a 7 after each; a token
    decodes to a space and its number."""

    eos_token_id = None

    def apply_chat_template(self, messages, add_generation_prompt=True):
        ids = []
        for m in messages:
            ids.extend(int(t) for t in m["content"].split())
            ids.append(7)
        return ids

    def __call__(self, text):
        return {"input_ids": [int(t) for t in text.split()]}

    def decode(self, toks):
        return "".join(f" {t}" for t in toks)


class Client:
    """HTTP calls to a served engine, each with a timeout; counts the
    requests the engine was given and the tokens that came back."""

    def __init__(self, srv):
        # a server object, or the base URL of a server in another process
        self.base = srv if isinstance(srv, str) else f"http://127.0.0.1:{srv.server_address[1]}"
        self.requests = 0
        self.tokens = 0
        self._lock = threading.Lock()  # concurrent() posts from several threads

    def _count(self, requests, tokens):
        with self._lock:
            self.requests += requests
            self.tokens += tokens

    def _request(self, path, payload):
        return urllib.request.Request(self.base + path, data=json.dumps(payload).encode(),
                                      headers={"Content-Type": "application/json"})

    def post(self, payload, path="/v1/completions", engine_requests=1):
        try:
            with urllib.request.urlopen(self._request(path, payload), timeout=300) as r:
                out = r.status, json.loads(r.read())
        except urllib.error.HTTPError as e:
            return e.code, json.loads(e.read())
        body = out[1]
        tokens = len(body.get("tokens", ()))
        for c in body.get("choices", ()):
            tokens += len(c["token_ids"] if "token_ids" in c else c["message"]["content"].split())
        self._count(engine_requests, tokens)
        return out

    def stream(self, payload):
        """A streamed completion: its tokens, the seconds to its first token
        and from its first token to its last, from the client's clock."""
        t0 = time.perf_counter()
        toks, first, last = [], None, None
        with urllib.request.urlopen(self._request("/v1/completions", payload), timeout=300) as r:
            for ln in r:
                ln = ln.decode().strip()
                if not ln:
                    continue
                if ln.startswith("data: "):
                    if ln == "data: [DONE]":
                        continue
                    ids = json.loads(ln[6:])["choices"][0]["token_ids"]
                else:
                    rec = json.loads(ln)
                    ids = [rec["token"]] if "token" in rec else []
                for t in ids:
                    now = time.perf_counter()
                    first = first if first is not None else now
                    last = now
                    toks.append(t)
        self._count(1, len(toks))
        return toks, first - t0, last - first

    def get(self, path):
        with urllib.request.urlopen(self.base + path, timeout=60) as r:
            return r.read().decode()

    def metrics(self) -> dict:
        vals = {}
        for ln in self.get("/metrics").splitlines():
            if ln and not ln.startswith("#"):
                k, v = ln.split()
                vals[k] = float(v)
        return vals


def concurrent(client, payloads):
    """Post ``payloads`` from one thread each, all at once."""
    got = [None] * len(payloads)

    def run(i):
        got[i] = client.post(payloads[i])

    threads = [threading.Thread(target=run, args=(i,)) for i in range(len(payloads))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    if any(g is None or g[0] != 200 for g in got):
        raise AssertionError(f"[server] concurrent requests failed: {[g and g[0] for g in got]}")
    return [g[1]["tokens"] for g in got]


def count_forwards(eng, decode_attr):
    """Count an engine's decode steps (``decode_attr``, graphed) and its
    prefill forwards (``eng.forward`` outside a decode step)."""
    calls = Calls()
    calls.count(eng, decode_attr, key="decode", step=True)
    calls.count(eng, "forward", key="prefill_forward")
    return calls


def trace_served(client, payload, log_dir):
    """torch.profiler over one streamed request, through the port's
    profiling.device_trace, while the server's device thread serves it: the
    trace file, its size, whether it names K1, and the device's idle share
    (1 - device busy / the trace's wall)."""
    from flute_tpu_torch.utils import profiling

    shutil.rmtree(log_dir, ignore_errors=True)
    t0 = time.perf_counter()
    with profiling.device_trace(log_dir) as prof:
        toks, _, _ = client.stream(payload)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    summary = profile_summary("server, one streamed request", prof, wall, len(toks))
    path = os.path.join(log_dir, profiling.TRACE_FILE)
    text = open(path).read() if os.path.isfile(path) else ""
    names_k1 = any(p in text for p in PROFILE_GROUPS["K1"])
    out = dict(trace_bytes=len(text), names_k1=names_k1, tokens=len(toks),
               wall_ms_per_token=wall / len(toks) * 1e3,
               device_ms_per_token=summary["device_ms_per_step"],
               idle_share=summary["idle_share"], k1_ms_per_token=(
                   summary["groups_ms_per_step"] or {}).get("K1"))
    shutil.rmtree(log_dir, ignore_errors=True)
    if not text or not names_k1:
        raise AssertionError(f"[server] the trace in {log_dir} is missing or names no K1 "
                             f"kernel ({len(text)} bytes)")
    return out


def serve_http(dev, config, qparams, oracle):
    """Phase 7b: ContinuousBatchingEngine (8 slots, max_len 512, the
    quantized head) run directly, then behind the port's server; then
    PagedEngine behind the server for a shorter run."""
    from flute_tpu_torch.serving import ContinuousBatchingEngine, PagedEngine, SamplingParams
    from flute_tpu_torch.serving.server import serve as http_serve

    prompts = serving_prompts(config)
    want, logits = oracle
    per_forward = config.num_layers * 4 + 1  # the quantized head: one more K1 launch
    eng = ContinuousBatchingEngine(params=qparams, config=config, num_slots=8,
                                   max_len=SPEC_MAX_LEN, device=dev)
    decode_s = []
    timed(eng, "_decode", decode_s)
    calls = count_forwards(eng, "_step_logits")
    reset_counters()
    rids = [eng.submit(p, max_new_tokens=SERVER_TOKENS) for p in prompts]
    direct = eng.run()
    direct = [direct[r] for r in rids]
    check_launches("server: direct run", {"w4sym": (calls["decode"] + calls["prefill_forward"])
                                          * per_forward})
    ties, decided = hold_tokens("server: direct run", direct, want, logits[:, :8])
    step_ms = float(np.median(decode_s)) * 1e3
    log(f"  [server] the engine run directly: tokens equal Engine's before every near tie "
        f"(first ties {ties}), median step {step_ms:.2f} ms (host clock)")

    sampled = dict(temperature=0.8, top_k=50, seed=123)
    chat = [{"role": "user", "content": " ".join(map(str, prompts[3]))}]
    srv = http_serve(eng, port=0, tokenizer=StubTokenizer(), model_id="llama31-8b-w4sym")
    client = Client(srv)
    out = dict(direct_median_step_ms=step_ms, first_ties=ties, decided_share=decided)
    try:
        if json.loads(client.get("/health"))["status"] != "ok":
            raise AssertionError("[server] /health")
        if json.loads(client.get("/v1/models"))["data"][0]["id"] != "llama31-8b-w4sym":
            raise AssertionError("[server] /v1/models")
        reset_counters()
        calls.n.clear()
        # everything below runs in the server's device thread; the main
        # thread only speaks HTTP until the server is shut down
        t0 = time.perf_counter()
        http = concurrent(client, [{"prompt": p, "max_tokens": SERVER_TOKENS} for p in prompts])
        out["concurrent_s"] = time.perf_counter() - t0
        hold_tokens("server: 8 concurrent requests", http, want, logits[:, :8])
        same = sum(a == b for a, b in zip(http, direct))
        plain = client.post({"prompt": prompts[0], "max_tokens": SERVER_TOKENS})[1]["tokens"]
        ndjson, ttft, rest = client.stream({"prompt": prompts[0], "max_tokens": SERVER_TOKENS,
                                            "stream": True})
        sse, ttft_sse, rest_sse = client.stream({"prompt": prompts[0],
                                                 "max_tokens": SERVER_TOKENS, "stream": True,
                                                 "model": "m"})
        if not plain == ndjson == sse:
            raise AssertionError(f"[server] plain {plain}, NDJSON {ndjson}, SSE {sse} differ")
        _, n2 = client.post({"prompt": prompts[1], "max_tokens": SERVER_TOKENS, "model": "m",
                             "n": 2, **sampled}, engine_requests=2)
        choices = [c["token_ids"] for c in n2["choices"]]
        code, chat_out = client.post({"messages": chat, "max_tokens": SERVER_TOKENS},
                                     path="/v1/chat/completions")
        templated = client.post({"prompt": StubTokenizer().apply_chat_template(chat),
                                 "max_tokens": SERVER_TOKENS})[1]["tokens"]
        if code != 200 or chat_out["choices"][0]["message"]["content"].split() != [
                str(t) for t in templated]:
            raise AssertionError(f"[server] chat {chat_out} != completion {templated}")
        bad = [client.post(p)[0] for p in ({"prompt": "text", "n": 0}, {"prompt": []},
                                            {"prompt": [1, 2], "n": 2, "stream": True})]
        if bad != [400, 400, 400]:
            raise AssertionError(f"[server] malformed requests answered {bad}")
        launches = check_launches("server", {"w4sym": (calls["decode"] + calls["prefill_forward"])
                                             * per_forward})
        served_calls = dict(calls.n)
        vals = client.metrics()
        sent = (client.requests, client.tokens)
        if (vals["flute_requests_total"], vals["flute_tokens_generated_total"]) != sent:
            raise AssertionError(f"[server] metrics {vals} count other than the {sent[0]} "
                                 f"requests and {sent[1]} tokens")
        trace = trace_served(client, {"prompt": prompts[2], "max_tokens": SERVER_TOKENS,
                                      "stream": True},
                             os.path.join(HERE, "build", "server_trace"))
    finally:
        srv.shutdown()
        srv.server_close()
        srv.loop.shutdown()
    # the n = 2 choices against direct submissions with seeds s and s + 1
    seeds = [eng.submit(prompts[1], max_new_tokens=SERVER_TOKENS,
                        sampling=SamplingParams(**dict(sampled, seed=sampled["seed"] + i)))
             for i in range(2)]
    alone = eng.run()
    if choices != [alone[r] for r in seeds]:
        raise AssertionError(f"[server] n = 2 choices {choices} differ from direct submissions "
                             f"with seeds s, s + 1: {[alone[r] for r in seeds]}")
    if dev.type == "cuda" and not eng._graph.captured:
        raise AssertionError("[server] the decode step was not graphed")
    out.update(
        identical_to_direct=same, launches=launches, calls=served_calls, metrics=vals,
        requests_sent=sent[0], tokens_received=sent[1],
        ttft_ms=ttft * 1e3, ms_per_token=rest / (len(ndjson) - 1) * 1e3,
        ttft_sse_ms=ttft_sse * 1e3, ms_per_token_sse=rest_sse / (len(sse) - 1) * 1e3,
        trace=trace)
    log(f"  [server] 8 concurrent requests x {SERVER_TOKENS} tokens in "
        f"{out['concurrent_s']:.2f} s: tokens equal the direct run's before every near tie "
        f"({same}/8 identical in full); plain, NDJSON and SSE answers identical; n = 2 choices "
        f"equal direct submissions with seeds s, s + 1; chat equals the templated completion; "
        f"malformed requests 400; metrics count {sent[0]} requests and {sent[1]} "
        f"tokens; launches {launches} ({served_calls})")
    log(f"  [server] streamed: time to first token {out['ttft_ms']:.1f} ms (SSE "
        f"{out['ttft_sse_ms']:.1f}), {out['ms_per_token']:.2f} ms per token (SSE "
        f"{out['ms_per_token_sse']:.2f}) against the engine's median step {step_ms:.2f} ms; "
        f"traced request: {trace['wall_ms_per_token']:.2f} ms per token, device "
        f"{measured(trace['device_ms_per_token'], ' ms')} (K1 "
        f"{measured(trace['k1_ms_per_token'], ' ms')}), idle share "
        f"{measured(trace['idle_share'])}; the trace ({trace['trace_bytes']} bytes) names K1")
    del eng
    release()

    # PagedEngine (K1 and K5) behind the server: the same prompts, fewer tokens
    peng = PagedEngine(params=qparams, config=config, num_slots=8, block_size=16, num_blocks=48,
                       max_len=256, device=dev)
    pcalls = count_forwards(peng, "_step_logits")
    srv = http_serve(peng, port=0)
    client = Client(srv)
    try:
        reset_counters()
        paged = concurrent(client, [{"prompt": p, "max_tokens": PAGED_SERVER_TOKENS}
                                    for p in prompts])
        launches = check_launches("paged server", {
            "w4sym": (pcalls["decode"] + pcalls["prefill_forward"]) * per_forward,
            "paged_decode": pcalls["decode"] * config.num_layers})
        vals = client.metrics()
    finally:
        srv.shutdown()
        srv.server_close()
        srv.loop.shutdown()
    pties, _ = hold_tokens("paged server", paged, want, logits[:, :8])
    if peng.blocks_in_use != 0 or vals["flute_paged_blocks_in_use"] != 0:
        raise AssertionError(f"[paged server] {peng.blocks_in_use} blocks still in use")
    out["paged"] = dict(new_tokens=PAGED_SERVER_TOKENS, launches=launches, calls=dict(pcalls.n),
                        first_ties=pties, blocks_in_use=peng.blocks_in_use,
                        identical_to_engine=sum(a == b[:PAGED_SERVER_TOKENS]
                                                for a, b in zip(paged, want)))
    log(f"  [paged server] PagedEngine behind the server, 8 requests x {PAGED_SERVER_TOKENS} "
        f"tokens (cut from {SERVER_TOKENS} to keep the phase short): tokens equal Engine's "
        f"before every near tie, no block in use at the end; launches {launches}")
    del peng
    release()
    return out


def perplexity_runs(dev, config, params, qhead) -> dict:
    """Phase 7c: perplexity of 4096 tokens from a numpy seed, as two windows
    of 2048, through the quantized model at batch 1 and 2 (the two within
    1e-3), with the quantized head, and through the dense bf16 params (the
    quantized ones within 5% of it); exact K1 launches per run (forward
    calls x (layers x 4, plus 1 with the quantized head)), seconds per
    window."""
    from flute_tpu_torch import eval as teval
    from flute_tpu_torch.models import llama

    toks = np.random.default_rng(11).integers(0, config.vocab_size, PPL_SEQ * PPL_WINDOWS)
    qdense = dict(qhead, lm_head=params["lm_head"])
    ppl = {}
    for name, p, batch, head in (("quantized", qdense, 1, 0), ("quantized", qdense, 2, 0),
                                 ("quantized head", qhead, 1, 1), ("dense", params, 1, None)):
        forwards, rows = [0], []

        def forward(*a, **kw):
            forwards[0] += 1
            rows.append(a[2].numel())  # forward(params, config, tokens, ...)
            return llama.forward(*a, **kw)

        reset_counters()
        sync(dev)
        t0 = time.perf_counter()
        value = teval.perplexity(p, config, toks, forward=forward, seq_len=PPL_SEQ,
                                 batch_size=batch, device=dev)
        sync(dev)
        seconds = time.perf_counter() - t0
        k1 = 0 if head is None else forwards[0] * (config.num_layers * 4 + head)
        launches = check_launches(f"perplexity {name} batch {batch}", {"w4sym": k1})
        wide = check_route(f"perplexity {name} batch {batch}", {"w4sym": 0 if head is None else sum(
            route_expected("wide", "w4sym", 4, r, config.num_layers * 4 + head) for r in rows)})
        ppl[f"{name} batch {batch}"] = dict(ppl=value, forwards=forwards[0], launches=launches,
                                            wide_launches=wide, rows=sorted(set(rows)),
                                            s_per_window=seconds / PPL_WINDOWS)
        log(f"  [perplexity] {name}, batch {batch}: {value:.2f} over {PPL_WINDOWS} windows of "
            f"{PPL_SEQ}, {seconds / PPL_WINDOWS:.3f} s per window, {forwards[0]} forwards, "
            f"{launches['w4sym']} K1 launches, {wide['w4sym_wide']} on the wide-M kernel")
    q1, q2 = ppl["quantized batch 1"]["ppl"], ppl["quantized batch 2"]["ppl"]
    if not abs(q2 - q1) / q1 < 1e-3:
        raise AssertionError(f"[perplexity] batch 2 {q2} against batch 1 {q1}")
    dense = ppl["dense batch 1"]["ppl"]
    for name in ("quantized batch 1", "quantized head batch 1"):
        if not abs(ppl[name]["ppl"] - dense) / dense < 0.05:
            raise AssertionError(f"[perplexity] {name} {ppl[name]['ppl']} against dense {dense}")
    if not all(np.isfinite(v["ppl"]) and v["ppl"] > 1 for v in ppl.values()):
        raise AssertionError(f"[perplexity] {ppl}")
    head = ppl["quantized head batch 1"]["ppl"]
    log(f"  [perplexity] batch 2 within {abs(q2 - q1) / q1:.1e} of batch 1; quantized within "
        f"{abs(q1 - dense) / dense:.2%} and with the head within {abs(head - dense) / dense:.2%} "
        "of dense")
    return ppl


def phase_head_server_ppl(dev, results, trajectory):
    """Phase 7: the quantized lm_head (K1 at both heads, the first logits
    against the dense head), the HTTP server over ContinuousBatchingEngine
    and PagedEngine, and perplexity at 2048-token windows, on Llama-3.1-8B
    (phase 4's random weights, seed 0, full width and depth, w4sym, g64,
    fused, quantized on the card with the head)."""
    from flute_tpu_torch.models import llama
    from flute_tpu_torch.serving import Engine

    out = dict(head_cases=check_heads(dev))
    config = llama.LlamaConfig.llama31_8b()
    t0 = time.perf_counter()
    params = llama.init_params(config, seed=0, device=dev)
    qhead = llama.quantize_model(params, group_size=GROUP, fuse=True, quantize_lm_head=True,
                                 device=dev)
    sync(dev)
    log(f"  [head] quantized the model with its head [{qhead['lm_head'].scales.shape[1]}, "
        f"{config.hidden_size}] in {time.perf_counter() - t0:.1f} s")

    # the quantized head's Engine: the oracle of the served runs
    eng = Engine(params=qhead, config=config, batch_size=8, max_len=256, device=dev)
    engine, oracle = serve_engine("w4sym, quantized head", eng, serving_prompts(config), "w4sym",
                                  new_tokens=SERVER_TOKENS, head=1)
    engine["profile"] = profile_decode(dev, "w4sym, quantized head", eng)
    check_copies("w4sym, quantized head", engine["profile"])
    del eng
    release()
    dense_first = trajectory[1][0, :8].float()
    head_err = float((oracle[1][0, :8] - dense_first).abs().max() / dense_first.abs().max())
    if not head_err < HEAD_CONTRACT:
        raise AssertionError(f"[head] first logits {head_err:.3f} of the largest dense-head logit "
                             f"away from the dense head's (limit {HEAD_CONTRACT})")
    out.update(engine=engine, first_logits_err=head_err)
    log(f"  [head] first decode logits within {head_err:.4f} of the largest dense-head logit "
        f"(limit {HEAD_CONTRACT}); median step {engine['decode_ms_per_step']:.2f} ms against "
        f"phase 4's {results['serving']['w4sym']['decode_ms_per_step']:.2f} ms with the dense "
        "head")

    out["server"] = serve_http(dev, config, qhead, oracle)

    out["perplexity"] = perplexity_runs(dev, config, params, qhead)
    del params, qhead
    release()
    results["serving"]["phase7"] = out
    return out


def phase7_numbers(phase7) -> dict:
    """What phase 7 adds to K1's kernel line: K1 at each quantized head
    (M = 8; ``m1`` at M = 1) beside its yardstick, the dense head's
    ``matmul_f32``, with the launches of the head in phase 7's runs (one per
    forward), and one Llama-3.1-8B layer at the perplexity prefill (M =
    2047) beside the perplexity runs' launches."""
    cases = phase7["head_cases"]
    server = phase7["server"]
    forwards = {"engine": phase7["engine"]["steps"],
                "server": sum(server["calls"].values()),
                "paged server": sum(server["paged"]["calls"].values()),
                **{f"perplexity {name}": run["forwards"]
                   for name, run in phase7["perplexity"].items() if "head" in name}}
    heads = {}
    for model in HEAD_SHAPES:
        m8, m1 = head_stack(cases, model, 8), head_stack(cases, model, 1)
        heads[model] = dict(_stack_numbers(m8), m=8, n=m8[0]["n"], k=m8[0]["k"],
                            max_abs_err=max(c["max_abs_err"] for c in m1 + m8),
                            library=m8[0]["yardstick"],
                            library_bound_ms=m8[0]["library_bound_us"] / 1e3,
                            m1=_stack_numbers(m1))
    heads["llama31_8b"]["launches"] = forwards
    prefill = [c for c in cases if c["m"] == PPL_SEQ - 1]
    ppl_launches = {name: run["launches"]["w4sym"] for name, run in phase7["perplexity"].items()
                    if run["launches"]["w4sym"]}
    launches = {"engine": phase7["engine"]["launches"]["w4sym"],
                "server": server["launches"]["w4sym"],
                "paged server": server["paged"]["launches"]["w4sym"], **ppl_launches}
    return dict(heads=heads, prefill=dict(_stack_numbers(prefill), m=PPL_SEQ - 1,
                                          launches=ppl_launches),
                phase7=dict(launches=launches))


# ---------------------------------------------------------------------------
# Phase 8: the CLI driven from an HF directory (quantize, generate, the
# tuner, NFL, the importers, serve)
# ---------------------------------------------------------------------------

CLI_DEVICE = "cuda"
CLI_LAYERS = 4  # the HF directory's depth, of Llama-3.1-8B's 32
CLI_IMPORT_LAYERS = 1  # the bnb and reference-FLUTE checkpoints' depth
CLI_TOKENS = 8
CLI_MAX_LEN = 256
CLI_TEMPLATE = 20  # a reference template id whose tileP is 32 at 2, 3 and 4 bits
TUNE_SHAPES = {"qkv": (6144, 4096), "o": (4096, 4096), "gate_up": (28672, 4096),
               "down": (4096, 14336)}
TUNE_M = (8, 40)  # a decode step of 8 requests; the verify of 8 x (k + 1)
# the JAX CLI's batch and length; 8 steps over one batch at a learning rate
# of 1e-3: at the CLI's 1e-4 the loss on random weights moves by less than
# the jumps of the straight-through codes (a CPU check at a narrow width)
NFL = dict(steps=8, batch=2, seq=512, lr=1e-3)
HF_PROJ = {"q": "self_attn.q_proj", "k": "self_attn.k_proj", "v": "self_attn.v_proj",
           "o": "self_attn.o_proj", "gate": "mlp.gate_proj", "up": "mlp.up_proj",
           "down": "mlp.down_proj"}
FP4_TABLE = [0.0, 0.0052, 0.6667, 1.0, 0.3333, 0.5, 0.1667, 0.25,
             -0.0, -0.0052, -0.6667, -1.0, -0.3333, -0.5, -0.1667, -0.25]


def cli_config(layers):
    from flute_tpu_torch.models import llama

    return dataclasses.replace(llama.LlamaConfig.llama31_8b(), num_layers=layers)


def hf_config_json(c) -> dict:
    return {"model_type": "llama", "vocab_size": c.vocab_size, "hidden_size": c.hidden_size,
            "intermediate_size": c.intermediate_size, "num_hidden_layers": c.num_layers,
            "num_attention_heads": c.num_heads, "num_key_value_heads": c.num_kv_heads,
            "head_dim": c.head_dim, "rms_norm_eps": c.rms_norm_eps, "rope_theta": c.rope_theta,
            "rope_scaling": {"rope_type": "llama3", "factor": c.rope_scaling_factor,
                             "low_freq_factor": c.rope_low_freq_factor,
                             "high_freq_factor": c.rope_high_freq_factor,
                             "original_max_position_embeddings": c.rope_original_max_position},
            "tie_word_embeddings": False, "torch_dtype": "bfloat16"}


def proj_shapes(c) -> dict:
    """HF ``[out, in]`` of each projection."""
    qdim, kvdim = c.num_heads * c.head_dim, c.num_kv_heads * c.head_dim
    return {"q": (qdim, c.hidden_size), "k": (kvdim, c.hidden_size), "v": (kvdim, c.hidden_size),
            "o": (c.hidden_size, qdim), "gate": (c.intermediate_size, c.hidden_size),
            "up": (c.intermediate_size, c.hidden_size),
            "down": (c.hidden_size, c.intermediate_size)}


def write_hf_dir(path, config, dev, seed) -> dict:
    """An HF Llama directory (``config.json``, ``model.safetensors`` in bf16)
    written with the port's writer, the weights drawn on the card from a
    seeded generator; returns the host tensors by HF name."""
    from flute_tpu_torch.integrations import safetensors_io

    os.makedirs(path, exist_ok=True)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)

    def randn(shape, scale=0.02):
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(torch.bfloat16).cpu()

    def norm(n):
        return (1 + 0.1 * torch.randn((n,), generator=gen, device=dev)).to(torch.bfloat16).cpu()

    c = config
    tensors = {"model.embed_tokens.weight": randn((c.vocab_size, c.hidden_size)),
               "model.norm.weight": norm(c.hidden_size),
               "lm_head.weight": randn((c.vocab_size, c.hidden_size))}
    for li in range(c.num_layers):
        pre = f"model.layers.{li}."
        tensors[pre + "input_layernorm.weight"] = norm(c.hidden_size)
        tensors[pre + "post_attention_layernorm.weight"] = norm(c.hidden_size)
        for key, shape in proj_shapes(c).items():
            tensors[pre + HF_PROJ[key] + ".weight"] = randn(shape)
    safetensors_io.save_file(tensors, os.path.join(path, "model.safetensors"))
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(hf_config_json(c), f)
    return tensors


def run_cli(argv) -> list:
    """``cli.main(argv)``; the lines it printed."""
    from flute_tpu_torch.integrations import cli

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        cli.main(argv)
    lines = out.getvalue().splitlines()
    for ln in lines:
        log(f"    | {ln}")
    return lines


def nonzero(launches) -> dict:
    return {k: v for k, v in launches.items() if v}


def expect_launches(name, got, expected):
    if nonzero(got) != expected:
        raise AssertionError(f"[{name}] launches {nonzero(got)}, expected {expected}")


def cli_generate(label, ckpt, prompt, kernel, layers, *extra):
    """``generate`` through the CLI (counts set to 0 just before), held to
    an Engine built directly on the loaded params; returns its tokens and
    launches. With ``--retune`` the counts are read and set to 0 again
    once the tuned load returns, so the served launches are held exactly
    and the tuner's are reported apart."""
    from flute_tpu_torch.integrations import huggingface
    from flute_tpu_torch.integrations.huggingface import load_quantized_model
    from flute_tpu_torch.serving import Engine

    params, config, _ = load_quantized_model(ckpt, device=CLI_DEVICE)
    with uncounted():
        eng = Engine(params=params, config=config, max_len=CLI_MAX_LEN, batch_size=1,
                     device=CLI_DEVICE)
        want = eng.generate([prompt], max_new_tokens=CLI_TOKENS)[0]
    del eng, params
    release()
    tuner = {}

    def tuned_load(*a, **kw):
        out = load_quantized_model(*a, **kw)
        tuner.update(nonzero(launches_now()))
        reset_counters()
        return out

    reset_counters()
    t0 = time.perf_counter()
    with (unittest.mock.patch.object(huggingface, "load_quantized_model", tuned_load)
          if "--retune" in extra else contextlib.nullcontext()):
        lines = run_cli(["generate", "--checkpoint", ckpt, "--prompt",
                         " ".join(map(str, prompt)), "--max-new-tokens", str(CLI_TOKENS),
                         "--max-len", str(CLI_MAX_LEN), "--device", CLI_DEVICE, *extra])
    seconds = time.perf_counter() - t0
    got = json.loads(lines[-1])
    launches = nonzero(launches_now())
    if got != want:
        raise AssertionError(f"[{label}] generate gave {got}, the direct Engine {want}")
    # one launch per projection and forward
    expect_launches(label, launches, {kernel: CLI_TOKENS * 7 * layers})
    if "--retune" in extra and set(tuner) != {kernel}:
        raise AssertionError(f"[{label}] the tuner launched {tuner}, expected {kernel} only")
    log(f"  [{label}] generate: {got} = the direct Engine's; launches {launches}"
        + (f", the tuner's {tuner}" if tuner else "") + f" ({seconds:.1f} s with the load)")
    return dict(tokens=got, launches=launches, tuner_launches=tuner, seconds=seconds)


def cli_quantize(root, hf_dir, prompt):
    """Phase 8 step 1: quantize at 4 bits (w4sym, K1) and 3 bits (wide, K3),
    in memory and streaming, every .npy file of the two equal; generate
    from each, and with --retune."""
    from flute_tpu_torch import tune

    out = {}
    for bits, kernel in ((4, "w4sym"), (3, "w3wide")):
        dirs, seconds = {}, {}
        for mode in ("memory", "streaming"):
            dirs[mode] = os.path.join(root, f"w{bits}" + ("" if mode == "memory" else "_stream"))
            t0 = time.perf_counter()
            run_cli(["quantize", "--model-dir", hf_dir, "--output-dir", dirs[mode],
                     "--num-bits", str(bits), "--device", CLI_DEVICE]
                    + (["--streaming"] if mode == "streaming" else []))
            seconds[mode] = time.perf_counter() - t0
        files = sorted(f for f in os.listdir(dirs["memory"]) if f.endswith(".npy"))
        if files != sorted(f for f in os.listdir(dirs["streaming"]) if f.endswith(".npy")):
            raise AssertionError(f"[quantize {bits}-bit] the two products hold other files")
        _, mismatch, errors = filecmp.cmpfiles(dirs["memory"], dirs["streaming"], files,
                                               shallow=False)
        if mismatch or errors:
            raise AssertionError(f"[quantize {bits}-bit] files differ: {mismatch} {errors}")
        size = sum(os.path.getsize(os.path.join(dirs["memory"], f)) for f in files)
        shutil.rmtree(dirs["streaming"])
        log(f"  [quantize {bits}-bit] in memory {seconds['memory']:.1f} s, streaming "
            f"{seconds['streaming']:.1f} s; all {len(files)} .npy files ({size / 1e9:.2f} GB) "
            "byte-equal")
        out[f"w{bits}"] = dict(seconds=seconds, npy_files=len(files), bytes=size,
                               generate=cli_generate(f"{bits}-bit", dirs["memory"], prompt,
                                                     kernel, CLI_LAYERS))
    tune._MEMO.clear()
    retuned = cli_generate("4-bit --retune", os.path.join(root, "w4"), prompt, "w4sym",
                           CLI_LAYERS, "--retune")
    if retuned["tokens"] != out["w4"]["generate"]["tokens"]:
        raise AssertionError("[4-bit --retune] tokens differ from the plain generate's")
    tuned = {"|".join(map(str, k[1:5])): tune.launch_name(v) for k, v in tune._MEMO.items()}
    retuned["tuned"] = tuned
    log(f"  [4-bit --retune] the same tokens; tuned launches {tuned}")
    out["w4"]["generate_retune"] = retuned
    return out


def cli_tuner(dev):
    """Phase 8 step 2: the tuner at the fused projections' shapes (w4sym,
    bf16) at M = 8 and 40: every candidate's time and checks, the winner
    against the planner's launch, and the winner's bits against the
    planner's on other random weights."""
    from flute_tpu_torch import packing, tune
    from flute_tpu_torch.ops import lut_gemm
    from flute_tpu_torch.ops.kernel_config import KernelConfig, get_candidate_configs

    rows = []
    gen = torch.Generator(device=dev)
    gen.manual_seed(5)
    for name, (n, k) in TUNE_SHAPES.items():
        for m in TUNE_M:
            report = []
            reset_counters()
            best = tune.tune_config(m, n, k, 4, GROUP, torch.bfloat16, layout="w4sym", device=dev,
                                    use_memo=False, report=report)
            launches = nonzero(launches_now())
            want = [tune.launch_name(c) for c in get_candidate_configs(m, n, k, 4, GROUP,
                                                                     torch.bfloat16, "w4sym")]
            if [r["launch"] for r in report] != want:
                raise AssertionError(f"[tuner] {name} M={m}: report {report}, candidates {want}")
            bad = [r["launch"] for r in report if not (r["passed"] and r["same_bits_as_planner"])]
            if bad:
                raise AssertionError(f"[tuner] {name} M={m}: {bad} failed its checks")
            with uncounted():
                codes = torch.randint(0, 16, (k, n), generator=gen, device=dev, dtype=torch.int32)
                plane = packing.pack_w4_sym(codes)
                mags = torch.sort(torch.rand(8, generator=gen, device=dev)).values
                table = torch.cat([mags, -mags])
                scales = (torch.rand((k // GROUP, n), generator=gen, device=dev) + 0.5).to(
                    torch.bfloat16)
                x = torch.randn((m, k), generator=gen, device=dev).to(torch.bfloat16)
                ys = [lut_gemm.lut_qgemm(x, [plane], scales, table, num_bits=4, config=cfg,
                                         layout="w4sym") for cfg in (KernelConfig(), best)]
            if not torch.equal(*ys):
                raise AssertionError(f"[tuner] {name} M={m}: the winner changes the bits")
            planner = next(r for r in report if r["planner"])
            winner = next(r for r in report if r["chosen"])
            for r in report:
                log(f"  [tuner] {name} ({n}x{k}) M={m} {r['launch']}: {r['us']:.1f} us, "
                    f"rel err {r['rel_err']:.2e}, {'pass' if r['passed'] else 'FAIL'}")
            log(f"  [tuner] {name} M={m}: winner {winner['launch']} {winner['us']:.1f} us against "
                f"the planner's {planner['launch']} {planner['us']:.1f} us "
                f"({planner['us'] / winner['us']:.2f}x); bit-equal to it; launches {launches}")
            rows.append(dict(proj=name, n=n, k=k, m=m, candidates=report,
                             winner=winner["launch"], winner_us=winner["us"],
                             planner=planner["launch"], planner_us=planner["us"],
                             launches=launches))
    return rows


def cli_calibrate(root, hf_dir, prompt):
    """Phase 8 step 3: NFL through ``calibrate`` (batch 2 x 512, 8 steps over
    one fixed batch of seeded tokens): the loss falls; the checkpoint's
    projections are w4sym and it serves on K1."""
    from flute_tpu_torch.integrations.huggingface import load_quantized_model
    from flute_tpu_torch.nn import QuantizedLinear

    n = NFL["batch"] * NFL["seq"]
    batch = np.random.default_rng(8).integers(0, cli_config(1).vocab_size, n).astype(np.int32)
    tok_path = os.path.join(root, "nfl_tokens.npy")
    np.save(tok_path, np.tile(batch, NFL["steps"]))
    from flute_tpu_torch.quantize import learnable

    out_dir = os.path.join(root, "nfl")
    steps = []  # (host clock at the step's start, its loss unrounded)
    clm_loss = wrap(learnable, "clm_loss", after=lambda r, t0, *a: steps.append((t0, r.item())))
    t0 = time.perf_counter()
    try:
        run_cli(["calibrate", "--model-dir", hf_dir, "--output-dir", out_dir,
                 "--tokens-npy", tok_path, "--steps", str(NFL["steps"]),
                 "--batch-size", str(NFL["batch"]), "--seq-len", str(NFL["seq"]),
                 "--lr", str(NFL["lr"]), "--device", CLI_DEVICE])
    finally:
        learnable.clm_loss = clm_loss
    seconds = time.perf_counter() - t0
    losses = [loss for _, loss in steps]
    step_s = np.diff([t for t, _ in steps]).tolist()
    if len(losses) != NFL["steps"] or not np.isfinite(losses).all() or losses[-1] >= losses[0]:
        raise AssertionError(f"[NFL] losses {losses} do not fall")
    params, _, sidecar = load_quantized_model(out_dir, device=CLI_DEVICE)
    layouts = {v.layout for layer in params["layers"] for v in layer.values()
               if isinstance(v, QuantizedLinear)}
    if not sidecar["model_config"]["nfl"] or layouts != {"w4sym"}:
        raise AssertionError(f"[NFL] sidecar {sidecar}, layouts {layouts}")
    del params
    release()
    log(f"  [NFL] losses {losses}; {np.median(step_s):.3f} s per step (median of steps "
        f"1-{NFL['steps'] - 1}, start to start), {seconds:.1f} s in all with the load and save")
    served = cli_generate("NFL", out_dir, prompt, "w4sym", CLI_LAYERS)
    return dict(losses=losses, step_s=step_s, seconds=seconds, generate=served)


def import_model(dense, qlayers, norms) -> tuple:
    """Params of a one-layer model whose projections are ``qlayers`` (modules
    or dense [in, out] tensors), its embedding, head and norms dense."""
    layer = dict(qlayers, attn_norm=norms[0], mlp_norm=norms[1])
    return {"embed": dense["embed"], "final_norm": dense["final_norm"],
            "lm_head": dense["lm_head"], "layers": [layer]}


def hold_import(label, qparams, dparams, prompt, kernel):
    """The imported model's logits within the bf16 threshold of the dense
    model of the same weights; then it serves through an Engine with exact
    launches."""
    from flute_tpu_torch.serving import Engine

    config = cli_config(CLI_IMPORT_LAYERS)
    got, want = import_logits(qparams, prompt), import_logits(dparams, prompt)
    err = float((got - want).abs().max() / want.abs().max())
    if not err <= THRESHOLDS[torch.bfloat16]:
        raise AssertionError(f"[{label}] logits {err:.3e} from the dense model's")
    reset_counters()
    eng = Engine(params=qparams, config=config, max_len=CLI_MAX_LEN, batch_size=1,
                 device=CLI_DEVICE)
    toks = eng.generate([prompt], max_new_tokens=CLI_TOKENS)[0]
    launches = nonzero(launches_now())
    expect_launches(label, launches, {kernel: CLI_TOKENS * 7 * CLI_IMPORT_LAYERS})
    log(f"  [{label}] logits within {err:.2e} of the dense model's; served {toks}, "
        f"launches {launches}")
    return dict(logits_rel_err=err, tokens=toks, launches=launches)


def bnb_tensors(gen, dev, prefix, n, k, quant_type):
    """An HF-serialized bnb Linear4bit: random nibbles, absmax (NF4 double-
    quantized per 256 blocks, FP4 plain), the quant map and the JSON
    quant_state tensor."""
    bs = 64
    codes = torch.randint(0, 16, (n * k,), generator=gen, device=dev, dtype=torch.int32)
    packed = ((codes[0::2] << 4) | codes[1::2]).to(torch.uint8)
    absmax = torch.rand((n * k // bs,), generator=gen, device=dev) * 0.04 + 0.01
    meta = {"quant_type": quant_type, "blocksize": bs, "shape": [n, k], "dtype": "bfloat16"}
    from flute_tpu_torch.quantize.nf import QLORA_NF4

    table = QLORA_NF4 if quant_type == "nf4" else np.asarray(FP4_TABLE, np.float32)
    t = {prefix + ".weight": packed.reshape(-1, 1).cpu(),
         prefix + ".weight.quant_map": torch.from_numpy(np.array(table))}
    if quant_type == "nf4":  # nested: uint8 codes of a 256-entry map per 256 blocks
        offset = float(absmax.mean())
        centered = absmax - offset
        pad = (-centered.numel()) % 256
        blocks = torch.nn.functional.pad(centered, (0, pad)).reshape(-1, 256)
        nested_absmax = blocks.abs().amax(dim=1)
        nested_absmax[nested_absmax == 0] = 1.0
        q = torch.round((blocks / nested_absmax[:, None] + 1) * 127.5).clamp(0, 255)
        t[prefix + ".weight.absmax"] = q.reshape(-1)[: centered.numel()].to(torch.uint8).cpu()
        t[prefix + ".weight.nested_absmax"] = nested_absmax.cpu()
        t[prefix + ".weight.nested_quant_map"] = torch.linspace(-1, 1, 256)
        meta.update(nested_blocksize=256, nested_offset=offset)
    else:
        t[prefix + ".weight.absmax"] = absmax.cpu()
    t[prefix + f".weight.quant_state.bitsandbytes__{quant_type}"] = torch.from_numpy(
        np.frombuffer(json.dumps(meta).encode(), np.uint8).copy())
    return t


def import_logits(params, prompt):
    from flute_tpu_torch.models import llama

    config = cli_config(CLI_IMPORT_LAYERS)
    tokens = torch.tensor([prompt], device=CLI_DEVICE)
    with torch.inference_mode(), uncounted():
        cache = llama.init_cache(config, 1, 32, device=CLI_DEVICE)
        return llama.forward(params, config, tokens, cache, 0)[0]


def cli_bnb(dev, root, hf, dense, prompt):
    """Phase 8 step 4: an NF4 (nested absmax) and an FP4 bnb checkpoint of
    one decoder layer at 8B widths, written with the port's writer, loaded
    with ``load_bnb_checkpoint``: each layer's weight is bnb's decode
    (``unpack_nibbles``, ``decode_absmax`` and the quant map, as
    ``dequantize_bnb`` reads them) rounded as the layer keeps it (table and
    absmax in bf16, their product rounded to bf16), bit for bit; the model
    serves on K2 within the bf16 threshold of the dense model of those
    weights. Its distance to the dense model of ``dequantize_bnb``'s f32
    weights is measured too: bf16 absmax moves each weight by up to 2^-9,
    and random weights amplify that through the layer."""
    from flute_tpu_torch.integrations import safetensors_io
    from flute_tpu_torch.quantize import bitsandbytes as bnb

    config = cli_config(CLI_IMPORT_LAYERS)
    gen = torch.Generator(device=dev)
    gen.manual_seed(11)
    norms = [dense["layers"][0]["attn_norm"], dense["layers"][0]["mlp_norm"]]
    out = {}
    for quant_type in ("nf4", "fp4"):
        d = os.path.join(root, f"bnb_{quant_type}")
        os.makedirs(d, exist_ok=True)
        tensors = {}
        for key, (n, k) in proj_shapes(config).items():
            tensors.update(bnb_tensors(gen, dev, f"model.layers.0.{HF_PROJ[key]}", n, k,
                                       quant_type))
        safetensors_io.save_file(tensors, os.path.join(d, "model.safetensors"))
        t0 = time.perf_counter()
        loaded = bnb.load_bnb_checkpoint(d, device=CLI_DEVICE)
        seconds = time.perf_counter() - t0
        qlayers, dlayers, f32layers = {}, {}, {}
        for key, (n, k) in proj_shapes(config).items():
            prefix = f"model.layers.0.{HF_PROJ[key]}"
            qlayers[key] = loaded[prefix]
            state = bnb.quant_state_from_tensors(tensors, prefix)
            packed = tensors[prefix + ".weight"].numpy()
            codes = torch.from_numpy(bnb.unpack_nibbles(packed, n * k)).to(CLI_DEVICE).long()
            absmax = torch.from_numpy(bnb.decode_absmax(state)).to(CLI_DEVICE)
            table = torch.from_numpy(state.code).to(CLI_DEVICE).to(torch.bfloat16)
            w = table[codes] * absmax.to(torch.bfloat16).repeat_interleave(state.blocksize)
            dlayers[key] = w.reshape(n, k).T  # [in, out]
            with uncounted():
                if not torch.equal(qlayers[key].dequantize(torch.bfloat16), dlayers[key]):
                    raise AssertionError(f"[bnb {quant_type}] {key}: the layer's weight is not "
                                         "bnb's decode")
            f32layers[key] = torch.from_numpy(bnb.dequantize_bnb(state, packed)).to(CLI_DEVICE).T
        qparams = import_model(dense, qlayers, norms)
        err32 = float((import_logits(qparams, prompt) - import_logits(
            import_model(dense, f32layers, norms), prompt)).abs().max())
        log(f"  [bnb {quant_type}] loaded {len(qlayers)} layers in {seconds:.1f} s; each weight "
            "bnb's decode, bit for bit")
        out[quant_type] = dict(load_s=seconds, **hold_import(
            f"bnb {quant_type}", qparams, import_model(dense, dlayers, norms), prompt, "plane"))
        want32 = float(import_logits(import_model(dense, f32layers, norms), prompt).abs().max())
        out[quant_type]["logits_rel_err_f32_decode"] = err32 / want32
        log(f"  [bnb {quant_type}] logits within {err32 / want32:.2e} of the dense model of "
            "dequantize_bnb's f32 weights (measured, not held)")
        del loaded, qlayers, dlayers, f32layers
        shutil.rmtree(d)
        release()
    return out


def reference_layer(gen, dev, bits, n, k, higgs):
    """One reference FluteLinear: codes [K, N] on the card, and its f16
    scales [N, K/g], f16 table (and a vector tables2); the int16 weight is
    packed from the codes afterwards (:func:`pack_reference`)."""
    e = 2**bits
    codes = torch.randint(0, e, (k, n), generator=gen, device=dev, dtype=torch.int32)
    scales = ((torch.rand((n, k // GROUP), generator=gen, device=dev) + 0.5) * 0.02).half()
    table = torch.sort(torch.randn(e, generator=gen, device=dev)).values.half()
    t = {"scales": scales.cpu(), "tables": table.cpu()}
    if higgs:
        grid = torch.randn((e, e, 2), generator=gen, device=dev).half()
        halves = grid.view(torch.int16).cpu().numpy().view(np.uint16).astype(np.uint32)
        t2 = (halves[..., 0] | (halves[..., 1] << 16)).view(np.float32)
        t["tables2"] = np.ascontiguousarray(t2.reshape(e, e, 1))
    return codes, t


def cli_import_flute(dev, root, hf, dense, prompt):
    """Phase 8 step 5: reference-FLUTE checkpoints of one decoder layer at
    8B widths (W4, W3, and HIGGS W4 with a vector tables2), packed with
    ``pack_reference_weight``, imported with ``import-flute`` and served:
    W4 and W3 on K2 (the pair planes the JAX package's importer packs), HIGGS
    on K4; each held to the dense model of its codes, scales and table."""
    from concurrent.futures import ThreadPoolExecutor

    from flute_tpu_torch.integrations import flute_format as ff
    from flute_tpu_torch.integrations import safetensors_io
    from flute_tpu_torch.integrations.huggingface import load_quantized_model
    from flute_tpu_torch.ops import lut_gemm

    config = cli_config(CLI_IMPORT_LAYERS)
    gen = torch.Generator(device=dev)
    gen.manual_seed(12)
    norms = [dense["layers"][0]["attn_norm"], dense["layers"][0]["mlp_norm"]]
    out = {}
    for name, bits, higgs, kernel in (("W4", 4, False, "plane"), ("W3", 3, False, "plane"),
                                      ("HIGGS W4", 4, True, "pair")):
        src = os.path.join(root, f"ref_{bits}{'h' if higgs else ''}")
        dst = src + "_imported"
        os.makedirs(src, exist_ok=True)
        t0 = time.perf_counter()
        made = {key: reference_layer(gen, dev, bits, n, k, higgs)
                for key, (n, k) in proj_shapes(config).items()}
        with ThreadPoolExecutor(max_workers=7) as ex:  # the host packs the seven at once
            packed = ex.map(lambda c: ff.pack_reference_weight(c.cpu().numpy(), bits,
                                                               template_id=CLI_TEMPLATE),
                            [codes for codes, _ in made.values()])
            for (_, t), weight in zip(made.values(), packed):
                t["weight"] = weight
        tensors = {"model.norm.weight": hf["model.norm.weight"],
                   "model.layers.0.input_layernorm.weight":
                       hf["model.layers.0.input_layernorm.weight"],
                   "model.layers.0.post_attention_layernorm.weight":
                       hf["model.layers.0.post_attention_layernorm.weight"]}
        for key, (_, t) in made.items():
            tensors.update({f"model.layers.0.{HF_PROJ[key]}.{part}": v for part, v in t.items()})
        safetensors_io.save_file(tensors, os.path.join(src, "model.safetensors"))
        with open(os.path.join(src, "flute_config.json"), "w") as f:
            json.dump({"num_bits": bits, "group_size": GROUP, "template_id": CLI_TEMPLATE}, f)
        with open(os.path.join(src, "config.json"), "w") as f:
            json.dump(hf_config_json(config), f)
        write_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        run_cli(["import-flute", "--model-dir", src, "--output-dir", dst])
        import_s = time.perf_counter() - t0
        params, _, sidecar = load_quantized_model(dst, device=CLI_DEVICE)
        qlayers = {key: params["layers"][0][key] for key in HF_PROJ}
        dlayers = {}
        for key, (codes, t) in made.items():
            layer = qlayers[key]
            if (layer.pair_values is not None) != higgs or layer.num_bits != bits:
                raise AssertionError(f"[import {name}] {key} came back as {layer}")
            s = t["scales"].to(CLI_DEVICE).float().T.contiguous().to(torch.bfloat16)
            if higgs:
                w = lut_gemm.dequantize_codes_pair(codes, s, layer.pair_values, torch.bfloat16)
            else:
                w = lut_gemm.dequantize_codes(codes, s, t["tables"].to(CLI_DEVICE).float(),
                                              torch.bfloat16)
            dlayers[key] = w
        log(f"  [import {name}] reference checkpoint written in {write_s:.1f} s, imported in "
            f"{import_s:.1f} s")
        out[name] = dict(write_s=write_s, import_s=import_s, **hold_import(
            f"import {name}", import_model(dense, qlayers, norms),
            import_model(dense, dlayers, norms), prompt, kernel))
        del params, qlayers, dlayers, made
        shutil.rmtree(src)
        shutil.rmtree(dst)
        release()
    return out


def cli_serve(root, prompt):
    """Phase 8 step 6: ``serve``'s engines from ``build_serve_engine`` (the
    4-bit checkpoint; the paged speculative one with the 3-bit checkpoint
    as its draft): one streamed HTTP request each, its tokens and launches
    those of the same engine driven directly."""
    from flute_tpu_torch.integrations import cli
    from flute_tpu_torch.serving.server import serve as http_serve

    common = ["serve", "--checkpoint", os.path.join(root, "w4"), "--num-slots", "2",
              "--max-len", str(CLI_MAX_LEN), "--block-size", "16", "--num-blocks", "64",
              "--device", CLI_DEVICE]
    modes = {"continuous": [], "paged pool-prefill": ["--paged", "--pool-prefill"],
             "paged speculative": ["--paged", "--pool-prefill", "--draft-checkpoint",
                                   os.path.join(root, "w3"), "--speculative-k", "4"]}
    out = {}
    for name, extra in modes.items():
        args = cli.build_parser().parse_args(common + extra)
        eng, _ = cli.build_serve_engine(args)
        reset_counters()
        rid = eng.submit(prompt, max_new_tokens=CLI_TOKENS)
        want = eng.run()[rid]
        direct = nonzero(launches_now())
        kind = type(eng).__name__
        del eng
        release()
        eng, tok = cli.build_serve_engine(args)
        srv = http_serve(eng, port=0, tokenizer=tok, model_id="phase8")
        try:
            reset_counters()
            toks, ttft, rest = Client(srv).stream({"prompt": prompt, "max_tokens": CLI_TOKENS,
                                                   "stream": True})
            launches = nonzero(launches_now())
        finally:
            srv.shutdown()
            srv.loop.shutdown()
        if toks != want or launches != direct:
            raise AssertionError(f"[serve {name}] HTTP {toks} {launches}, direct {want} {direct}")
        log(f"  [serve {name}] {kind}: one streamed request, {toks} = the engine driven "
            f"directly; TTFT {ttft * 1e3:.1f} ms, then {rest * 1e3:.1f} ms; launches {launches}")
        out[name] = dict(engine=kind, tokens=toks, ttft_s=ttft, rest_s=rest, launches=launches)
        del eng, srv
        release()
    return out


def phase_cli(dev, results):
    """Phase 8: an HF Llama directory at Llama-3.1-8B widths (4 layers) from a
    seed, driven through the port's CLI and the functions it calls."""
    from flute_tpu_torch.integrations.huggingface import load_hf_params

    root = os.path.join(HERE, "build", "phase8")
    shutil.rmtree(root, ignore_errors=True)
    hf_dir = os.path.join(root, "hf")
    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    hf = write_hf_dir(hf_dir, cli_config(CLI_LAYERS), dev, seed=0)
    size = os.path.getsize(os.path.join(hf_dir, "model.safetensors"))
    log(f"  HF directory: {CLI_LAYERS} layers at Llama-3.1-8B widths, {size / 1e9:.2f} GB of "
        f"bf16 shards, written in {time.perf_counter() - t0:.1f} s")
    prompt = np.random.default_rng(3).integers(0, cli_config(1).vocab_size, 12).tolist()
    out = dict(hf_bytes=size)
    try:
        out["quantize"] = cli_quantize(root, hf_dir, prompt)
        out["tuner"] = cli_tuner(dev)
        out["nfl"] = cli_calibrate(root, hf_dir, prompt)
        with torch.inference_mode():
            dense = load_hf_params(hf_dir, device=CLI_DEVICE)
        dense["layers"] = dense["layers"][:CLI_IMPORT_LAYERS]
        release()
        out["bnb"] = cli_bnb(dev, root, hf, dense, prompt)
        out["import_flute"] = cli_import_flute(dev, root, hf, dense, prompt)
        del dense
        release()
        out["serve"] = cli_serve(root, prompt)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    out["seconds"] = time.perf_counter() - t_phase
    log(f"  phase 8 took {out['seconds']:.0f} s")
    results["cli"] = out
    return out


def phase8_launches(cli_out) -> dict:
    """Each kernel's launches in each phase-8 run, by kernel counter."""
    runs = {f"generate {k}": v["generate"]["launches"] for k, v in cli_out["quantize"].items()}
    runs["generate w4 --retune"] = cli_out["quantize"]["w4"]["generate_retune"]["launches"]
    runs["nfl generate"] = cli_out["nfl"]["generate"]["launches"]
    for row in cli_out["tuner"]:
        runs[f"tuner {row['proj']} M={row['m']}"] = row["launches"]
    for fmt, r in cli_out["bnb"].items():
        runs[f"bnb {fmt}"] = r["launches"]
    for name, r in cli_out["import_flute"].items():
        runs[f"import {name}"] = r["launches"]
    for name, r in cli_out["serve"].items():
        runs[f"serve {name}"] = r["launches"]
    by_kernel = {}
    for run, launches in runs.items():
        for key, n in launches.items():
            by_kernel.setdefault(key, {})[run] = n
    return by_kernel


def report_served_idle(name, serving):
    """The served decode step's idle share: one minus the replay's device
    time (CUDA events) over the median host-clock step."""
    profile = serving["profile"]
    share = 1 - profile["replay_device_ms_per_step"] / serving["decode_ms_per_step"]
    serving["served_idle_share"] = share
    log(f"  [{name}] decode step: median {serving['decode_ms_per_step']:.2f} ms, quickest "
        f"{serving['decode_ms_quickest']:.2f} ms (host clock); device "
        f"{profile['replay_device_ms_per_step']:.2f} ms per replay; idle share {share:.2f}")


# ---------------------------------------------------------------------------
# Phase 9: tensor and pipeline parallelism, the host packer
# ---------------------------------------------------------------------------

TP_SIZES = (2, 4)
# phase 9's model: a LlamaConfig preset and fields replaced in it (a CPU
# rehearsal takes "tiny" with heads and widths that split 4 ways)
P9_CONFIG = ("llama31_8b", {})
P9_DEVICE = "cuda"  # where the ranks run (a CPU rehearsal sets "cpu")
# every world also serves Engine at this depth. A TP run adds o's and
# down's K shards in bf16, another summation order, which random layers
# amplify with depth (as phase 4's paged attention against dense): a run
# is held to the bf16 threshold or to twice what that order alone moves
# tp = 1's logits by (p9_floor), the larger, as phase 3 holds HIGGS, but
# never to more than P9_LIMIT_CAP
P9_SHORT = 2
# the limit's cap, whatever the floor: a tenth of the largest logit
P9_LIMIT_CAP = 0.1
P9_DIR = os.path.join(HERE, "build", "phase9")
SHARED_CARD = "ranks share one H100; gloo all-reduce staged through the host"
# the engines the world of 2 also serves through serve --tp's loop over
# HTTP (a run's kind: P9_HTTP, then the engine's)
P9_HTTP = "HTTP "
P9_HTTP_RUNS = ("PagedEngine", "ContinuousBatchingEngine")
# the entry point's depth and its engines' flags (serve --tp 2 as a process)
P9_ENTRY_MODES = {"paged pool-prefill": ["--paged", "--pool-prefill"],
                  "paged speculative": ["--paged", "--speculative-k", str(SPEC_K)]}
# the entry point's pool (15 usable blocks of 16: 240 positions) and a
# prompt it cannot hold (with 16 new tokens) though max_len (512) could
P9_ENTRY_BLOCKS = 16
P9_ENTRY_REFUSED = 300
# the engines phase 9 serves at tp = 1 and tp = 2, with their settings
P9_RUNS = {
    "Engine": dict(batch_size=8, max_len=256),
    "PagedEngine": dict(num_slots=8, block_size=16, num_blocks=64, max_len=256,
                        pool_prefill=True),
    "ContinuousBatchingEngine": dict(num_slots=8, max_len=256),
    "PagedSpeculativeEngine": dict(k=SPEC_K, num_slots=8, block_size=16, num_blocks=96,
                                   max_len=256),
}


def p9_config(layers=None, preset=None):
    """Phase 9's LlamaConfig (``preset``, default ``P9_CONFIG``), cut to
    ``layers``."""
    from flute_tpu_torch.models import llama

    name, fields = preset or P9_CONFIG
    config = dataclasses.replace(getattr(llama.LlamaConfig, name)(), **fields)
    return config if layers is None else dataclasses.replace(config, num_layers=layers)


def shard_shapes(tp: int) -> list:
    """One Llama-3.1-8B layer's projections as one of ``tp`` ranks holds
    them: qkv and gate_up split over N, o and down over K."""
    return [(name, n // tp if name in ("qkv", "gate_up") else n,
             k // tp if name in ("o", "down") else k) for name, n, k in LAYER_SHAPES]


def p9_attention_cases() -> list:
    """K5's and K6's calls at the local heads: first the decode batch at
    1024 and a chunk of 256 over 1024 (phase 2's shapes), then the shapes
    the TP engines give them: the decode of the 8 served prompts at its
    last step, the pool prefill's chunks (one prompt, a bucket of 16, 32
    or 64 over an empty cache) and the speculative verify (8 slots, k + 1
    queries over the prompts and some accepted tokens). Each is (kernel,
    lengths, queries, block size)."""
    lengths = [len(p) for p in serving_prompts(p9_config(layers=1))]
    bs = P9_RUNS["PagedEngine"]["block_size"]
    return ([("K5", [1024] * 8, 0, ATTN["bs"]), ("K6", [1024], 256, ATTN["bs"]),
             ("K5", [n + NEW_TOKENS - 1 for n in lengths], 0, bs)]
            + [("K6", [0], t, bs) for t in (16, 32, 64)]
            + [("K6", [n + 8 for n in lengths], SPEC_K + 1,
                P9_RUNS["PagedSpeculativeEngine"]["block_size"])])


def p9_kernels(dev) -> dict:
    """K1 at the shard shapes of tp = 2 and 4 (M = 8, bf16), K5 and K6 at
    the local heads (16/4 and 8/2) at the calls of p9_attention_cases: each
    against its plain version (K1 also against torch.matmul on the
    dequantized shard, and its rows against the one-row call), timed beside
    its bound and its yardstick."""
    rng = np.random.default_rng(9)
    gen = torch.Generator(device=dev)
    gen.manual_seed(9)
    out = {}
    for tp in TP_SIZES:
        log(f"  K1 at the tp = {tp} shard shapes, M = 8")
        k1 = [k1_case(dev, gen, f"tp{tp} {name}", n, k, 8) for name, n, k in shard_shapes(tp)]
        attn = dict(ATTN, h=ATTN["h"] // tp, hkv=ATTN["hkv"] // tp)
        log(f"  K5 and K6 at the tp = {tp} local heads {attn['h']}/{attn['hkv']}")
        out[tp] = dict(K1=k1, K5=[], K6=[])
        for kid, lengths, t, bs in p9_attention_cases():
            out[tp][kid].append(time_attention(dev, rng, gen, "llama31_8b", dict(attn, bs=bs),
                                               kid, lengths, t, {}))
    release()
    return out


def p9_engine(kind, params, config, dev, mesh=None):
    """Phase 9's ``kind`` engine at tp = 1 or on ``mesh``, recording: the
    engine, each forward's f32 logits rows of the live slots in call order
    (``steps``: [((key, request ids), rows)]), and its calls by method."""
    from flute_tpu_torch import serving

    kw = dict(P9_RUNS[kind], **({"device": dev} if mesh is None else {"mesh": mesh}))
    if kind == "PagedSpeculativeEngine":
        kw.update(draft_params=params, draft_config=config)
    eng = getattr(serving, kind)(params=params, config=config, **kw)
    steps, calls = [], {}

    def record(attr, key_of=None):
        """Count ``attr``'s calls; with ``key_of`` (of the call's arguments:
        its tag, the slots of its rows and their requests) keep its logits
        rows too."""
        fn = getattr(eng, attr)

        def wrapped(*a, **k):
            out = fn(*a, **k)
            calls[attr] = calls.get(attr, 0) + 1
            if key_of is not None:
                rows = out[0] if isinstance(out, tuple) else out
                tag, slots, ids = key_of(*a)
                rows = rows[None] if rows.dim() == 1 else rows[slots]
                steps.append(((tag, ids), rows.float().cpu()))
            return out

        setattr(eng, attr, wrapped)

    if kind == "Engine":
        every = list(range(P9_RUNS[kind]["batch_size"]))
        record("prefill", lambda *a: ("prefill", every, every))
        record("decode_step", lambda *a: ("step", every, every))
    elif kind == "ContinuousBatchingEngine":
        def live():
            slots = [s for s, r in enumerate(eng._slots) if r is not None]
            return slots, [eng._slots[s].rid for s in slots]

        record("_prefill", lambda req: ("prefill", [0], [req.rid]))
        record("_step_logits", lambda *a: ("step", *live()))
        record("forward")
    else:
        def live():
            slots = [s for s, r in enumerate(eng._slot_req) if r is not None]
            return slots, [eng._slot_req[s] for s in slots]

        if kind == "PagedEngine":
            record("_pool_fwd")
            record("_step_logits", lambda *a: ("step", *live()))
        else:
            record("forward")
            record("_dfwd")
            record("_verify_fwd")
            record("_draft_step", lambda *a: ("draft", *live()))
            record("_verify_step", lambda *a: ("verify", *live()))
        fn = eng._start

        def start(slot, prompt, sampling, last_row):
            steps.append((("first", [eng._slot_req[slot]]), last_row[None].float().cpu()))
            return fn(slot, prompt, sampling, last_row)

        eng._start = start
    return eng, steps, calls


def p9_replay(eng, schedule) -> list:
    """Make an engine's calls of a served run again: ``schedule`` is its
    submissions and steps in order (p9_http); the tokens by request id."""
    done = {}
    for op in schedule:
        if op[0] == "submit":
            eng.submit(op[1], max_new_tokens=op[2])
        else:
            eng.step()
            done.update(eng._finished)
            eng._finished = {}
    return [done[r] for r in range(len(done))]


def p9_run(eng, steps, calls, kind, dev, drive) -> dict:
    """``drive()`` (the tokens) on a recording engine of p9_engine: the
    tokens, the recorded steps and calls, the launches and all-reduces of
    the run, its seconds and ms per step."""
    from flute_tpu_torch.parallel import comm

    launches0, reduces0 = launches_now(), comm.COUNTS["all_reduce"]
    sync(dev)
    t0 = time.perf_counter()
    tokens = drive()
    sync(dev)
    seconds = time.perf_counter() - t0
    launches = {k: v - launches0[k] for k, v in launches_now().items()}
    if kind == "Engine":
        calls["forward"] = calls["prefill"] + calls["decode_step"]
        ms_step = float(np.median(eng.last_timings["decode_s"])) * 1e3
    else:
        n_steps = calls.get("_step_logits", calls.get("_verify_step", 0))
        ms_step = seconds * 1e3 / max(n_steps, 1)
    out = dict(tokens=tokens, steps=steps, calls=calls, launches=launches,
               all_reduces=comm.COUNTS["all_reduce"] - reduces0, graphed=eng.graphed,
               blocks_in_use=getattr(eng, "blocks_in_use", None), seconds=seconds,
               ms_per_step=ms_step)
    return out


def p9_free(dev) -> None:
    """Free an engine of p9_engine once its last reference is gone (its
    recording wrappers hold it in a cycle)."""
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()


def p9_drive(kind, params, config, dev, mesh=None, schedule=None) -> dict:
    """Serve phase 9's 8 prompts (16 new tokens each) through ``kind`` at tp
    = 1 or on ``mesh`` (p9_run's record), all submitted at once, or make the
    calls of a served run again (``schedule``)."""
    prompts = serving_prompts(config)
    eng, steps, calls = p9_engine(kind, params, config, dev, mesh)

    def drive():
        if kind == "Engine":
            return eng.generate(prompts, max_new_tokens=NEW_TOKENS)
        if schedule is not None:
            return p9_replay(eng, schedule)
        rids = [eng.submit(p, max_new_tokens=NEW_TOKENS) for p in prompts]
        done = eng.run()
        return [done[r] for r in rids]

    out = p9_run(eng, steps, calls, kind, dev, drive)
    del eng, drive
    p9_free(dev)
    return out


def p9_clients(srv, prompts) -> tuple:
    """Phase 9's HTTP traffic: the first 6 prompts posted at once, then the
    last 2 streamed one after the other (16 new tokens each). The tokens by
    request id (the server's ids: the streams come last) and each stream's
    seconds to its first token and ms per later token, from the client."""
    from concurrent.futures import ThreadPoolExecutor

    client = Client(srv)
    with ThreadPoolExecutor(6) as pool:
        answers = list(pool.map(lambda p: client.post({"prompt": p, "max_tokens": NEW_TOKENS}),
                                prompts[:6]))
    if any(status != 200 for status, _ in answers):
        raise AssertionError(f"[served] answers {answers}")
    tokens = {body["id"]: body["tokens"] for _, body in answers}
    streams = []
    for p in prompts[6:]:
        toks, ttft, rest = client.stream({"prompt": p, "max_tokens": NEW_TOKENS, "stream": True})
        tokens[len(tokens)] = toks
        streams.append(dict(ttft_ms=ttft * 1e3, ms_per_token=rest * 1e3 / (len(toks) - 1)))
    return [tokens[r] for r in range(len(tokens))], streams


def p9_http(kind, params, config, mesh, rank) -> dict:
    """One rank's part of ``serve --tp``'s loop in a world: rank 0 serves
    the engine over HTTP to phase 9's clients (p9_clients), every other
    rank follows its steps (serving.server.follow). p9_run's record, with
    the engine's submissions and steps in order (``schedule``) and rank 0's
    streams."""
    from flute_tpu_torch.serving import server

    eng, steps, calls = p9_engine(kind, params, config, mesh.device, mesh)
    schedule, streams = [], []
    submit, step = eng.submit, eng.step

    def logged_submit(prompt, max_new_tokens, sampling=None):
        rid = submit(prompt, max_new_tokens=max_new_tokens, sampling=sampling)
        schedule.append(("submit", list(prompt), max_new_tokens))
        return rid

    def logged_step():
        schedule.append(("step",))
        return step()

    eng.submit, eng.step = logged_submit, logged_step

    def drive():
        if rank:
            done = {}
            server.follow(eng, on_finish=lambda rid, toks: done.__setitem__(rid, list(toks)))
            return [done[r] for r in range(len(done))]
        srv = server.serve(eng, port=0)
        try:
            tokens, timed = p9_clients(srv, serving_prompts(config))
        finally:
            srv.shutdown()
            srv.loop.shutdown()
        streams.extend(timed)
        return tokens

    out = p9_run(eng, steps, calls, kind, mesh.device, drive)
    del eng, drive, submit, step, logged_submit, logged_step
    p9_free(mesh.device)
    return dict(out, schedule=schedule, streams=streams)


def p9_expected(kind, calls, layers) -> dict:
    """The exact launches and all-reduces of a TP run: 4 K1 per layer per
    forward (a paged decode step is a forward), one K5 per layer per paged
    decode step, one K6 per layer per pool-prefill chunk or verify, and 2
    all-reduces per layer per forward."""
    if kind == "PagedEngine":
        forwards, k5, k6 = calls["_pool_fwd"] + calls["_step_logits"], calls["_step_logits"], \
            calls["_pool_fwd"]
    elif kind == "PagedSpeculativeEngine":
        forwards = calls["forward"] + calls["_dfwd"] + calls["_verify_fwd"]
        k5, k6 = 0, calls["_verify_fwd"]
    else:
        forwards, k5, k6 = calls["forward"], 0, 0
    return dict(w4sym=4 * layers * forwards, paged_decode=layers * k5, paged_verify=layers * k6,
                all_reduce=2 * layers * forwards)


def p9_cut(params, config, layers):
    """``params`` and ``config`` cut to their first ``layers`` (None: all)."""
    if layers is None:
        return params, config
    return dict(params, layers=params["layers"][:layers]), dataclasses.replace(
        config, num_layers=layers)


def p9_name(kind, layers) -> str:
    return kind if layers is None else f"{kind}, {layers} layers"


def p9_rank(rank, world, ckpt, runs, device, preset):
    """One rank of a phase-9 world: load the checkpoint on the host,
    permute its fused layers rank-major, and serve each of ``runs`` (kind,
    depth; a kind after ``P9_HTTP`` through serve --tp's loop, p9_http) on
    the tp mesh of the world. Every rank returns a digest of its tokens and
    logits; rank 0 the logits too."""
    import hashlib

    from flute_tpu_torch.integrations import checkpoint
    from flute_tpu_torch.parallel import make_mesh, permute_fused_params

    torch.backends.cuda.matmul.allow_tf32 = False
    mesh = make_mesh(tp=world, device=device)
    config = p9_config(preset=preset)
    params, _ = checkpoint.load_quantized(ckpt, device="cpu")
    params = permute_fused_params(params, config, world)
    out = {}
    for kind, layers in runs:
        if kind.startswith(P9_HTTP):
            run = p9_http(kind[len(P9_HTTP):], *p9_cut(params, config, layers), mesh, rank)
        else:
            run = p9_drive(kind, *p9_cut(params, config, layers), mesh.device, mesh)
        h = hashlib.sha256(json.dumps(run["tokens"]).encode())
        for _, rows in run["steps"]:
            h.update(rows.numpy().tobytes())
        run["digest"] = h.hexdigest()
        if rank:
            del run["steps"]
        out[p9_name(kind, layers)] = run
    return out


def p9_compare(label, got, ref, limit, decided_flips_fail=True):
    """Each forward's logits rows of ``got`` against ``ref``'s, slot by
    slot, within ``limit`` (relative to the largest logit): a slot is
    compared until its argmax differs, which must be at a near tie of
    ``ref``'s (its later rows follow other tokens); once the runs' forwards
    differ in kind or slots, none is compared. The greedy tokens of every
    slot that never diverged are equal. Returns the worst error, the rows
    compared, the diverged slots and the forwards compared by kind
    (prefill, step, ...; with ``decided_flips_fail`` False a flip at a
    decided margin only ends that slot's comparison)."""
    worst, compared, diverged, forwards = 0.0, 0, set(), {}
    for i, ((kg, lg), (kr, lr)) in enumerate(zip(got["steps"], ref["steps"])):
        if kg != kr:
            if not diverged:
                raise AssertionError(f"[{label}] forward {i} runs {kg}, tp = 1 {kr}")
            break
        keep = [j for j, slot in enumerate(kg[1]) if slot not in diverged]
        if not keep:
            continue
        a, b = lg[keep], lr[keep]
        err = float((a - b).abs().max() / b.abs().max())
        if not err < limit:
            raise AssertionError(f"[{label}] forward {i} ({kg[0]}): logits rel err {err:.3e} "
                                 f"(limit {limit:.3g})")
        worst, compared = max(worst, err), compared + len(keep)
        forwards[kg[0]] = forwards.get(kg[0], 0) + 1
        differ = a.argmax(-1) != b.argmax(-1)
        if differ.any():
            if decided_flips_fail and decided_steps(b)[differ].any():
                raise AssertionError(f"[{label}] forward {i}: a token differs where tp = 1's "
                                     "margin is decided")
            rows = differ.reshape(len(keep), -1).any(-1)
            diverged |= {kg[1][keep[j]] for j in rows.nonzero().flatten().tolist()}
    for slot, (a, b) in enumerate(zip(got["tokens"], ref["tokens"])):
        if slot not in diverged and a != b:
            raise AssertionError(f"[{label}] slot {slot}'s tokens differ with no near tie")
    return worst, compared, diverged, forwards


class KSplitSum(torch.nn.Module):
    """A row-parallel layer summed as ``tp`` ranks sum it, in one process
    and without the sharding code: ``torch.matmul`` on K slices of the
    dequantized weight, each product in x's dtype, added in that dtype."""

    def __init__(self, layer, tp):
        super().__init__()
        w = layer.dequantize(torch.bfloat16)
        k = w.shape[0] // tp
        self.slices = [w[i * k:(i + 1) * k].clone() for i in range(tp)]

    def forward(self, x):
        k = x.shape[-1] // len(self.slices)
        parts = [x[..., i * k:(i + 1) * k] @ w.to(x.dtype) for i, w in enumerate(self.slices)]
        return functools.reduce(torch.add, parts)


def p9_floor(dev, params, config, ref, tp) -> float:
    """How far another summation order alone moves ``ref``'s logits: the
    same tp = 1 Engine run with o and down summed as ``tp`` ranks sum them
    (KSplitSum), compared as a TP run is."""
    split = dict(params, layers=[dict(layer, o=KSplitSum(layer["o"], tp),
                                      down=KSplitSum(layer["down"], tp))
                                 for layer in params["layers"]])
    run = p9_drive("Engine", split, config, dev)
    return p9_compare(f"tp = 1, o and down summed {tp} ways", run, ref, float("inf"),
                      decided_flips_fail=False)[0]


def p9_hold(label, world, ref, name, kind, layers, limit) -> dict:
    """A TP run (``world``: every rank's results) against the tp = 1 run:
    the ranks' tokens and logits bit-identical; their launches and
    all-reduces exact; no block in use; not graphed; each forward's logits
    rows within the bf16 threshold of tp = 1's, and the same greedy tokens,
    up to the first row whose argmax differs, which must be a near tie of
    tp = 1's. ``limit`` bounds the logits' relative error; ``layers`` is
    the depth served."""
    runs = [w[name] for w in world]
    if len({r["digest"] for r in runs}) != 1:
        raise AssertionError(f"[{label}] the ranks' tokens or logits differ")
    got = runs[0]
    want = p9_expected(kind, got["calls"], layers)
    for r in runs:
        counts = dict(w4sym=r["launches"]["w4sym"], paged_decode=r["launches"]["paged_decode"],
                      paged_verify=r["launches"]["paged_verify"], all_reduce=r["all_reduces"])
        others = {k: v for k, v in r["launches"].items()
                  if k not in ("w4sym", "paged_decode", "paged_verify") and v}
        if counts != want or others:
            raise AssertionError(f"[{label}] launches {r['launches']}, all-reduces "
                                 f"{r['all_reduces']}; expected {want}")
        if r["graphed"] or r["blocks_in_use"] not in (None, 0):
            raise AssertionError(f"[{label}] graphed {r['graphed']}, blocks in use "
                                 f"{r['blocks_in_use']}")
    worst, compared, diverged, forwards = p9_compare(label, got, ref, limit)
    log(f"  [{label}] {len(world)} ranks bit-identical; {got['launches']['w4sym']} K1, "
        f"{got['launches']['paged_decode']} K5, {got['launches']['paged_verify']} K6 launches "
        f"and {got['all_reduces']} all-reduces a rank, as expected; logits of {compared} "
        f"rows in forwards {forwards} within {worst:.2e} of tp = 1's (limit {limit:.3g}); "
        "greedy tokens equal, "
        f"slots {sorted(diverged)} up to a near tie; not graphed (eager TP step); "
        f"{got['ms_per_step']:.1f} ms/step a rank "
        f"({len(world)} {SHARED_CARD}: not a TP speed), tp = 1 {ref['ms_per_step']:.1f} "
        f"ms/step, graphed {ref['graphed']}")
    return dict(ranks=len(world), layers=layers, limit=limit, launches_per_rank=got["launches"],
                all_reduces_per_rank=got["all_reduces"], calls=got["calls"],
                rows_compared=compared, forwards_compared=forwards, max_rel_err=worst,
                near_tie_slots=sorted(diverged),
                tokens_equal=got["tokens"] == ref["tokens"], graphed=got["graphed"],
                ms_per_step_per_rank=[r["ms_per_step"] for r in runs],
                seconds_per_rank=[r["seconds"] for r in runs], tp1_ms_per_step=ref["ms_per_step"],
                tp1_graphed=ref["graphed"], note=f"{len(world)} {SHARED_CARD}")


def p9_hold_http(label, world, name, kind, params, config, dev, limit) -> dict:
    """A run of serve --tp's loop (p9_http) held as p9_hold holds a TP run,
    against the same engine at tp = 1 making the same calls (rank 0's
    schedule); beside it the streams' times at tp = 2 and those of the
    same traffic to the tp = 1 engine behind serve() in this process."""
    from flute_tpu_torch.serving import server

    ref = p9_drive(kind, params, config, dev, schedule=world[0][name]["schedule"])
    held = p9_hold(label, world, ref, name, kind, config.num_layers, limit)
    eng, _, _ = p9_engine(kind, params, config, dev)
    srv = server.serve(eng, port=0)
    try:
        _, tp1 = p9_clients(srv, serving_prompts(config))
    finally:
        srv.shutdown()
        srv.loop.shutdown()
    del eng, srv
    p9_free(dev)
    tp2 = world[0][name]["streams"]
    held.update(streams=tp2, tp1_streams=tp1, schedule_ops=len(world[0][name]["schedule"]))
    log(f"  [{label}] served over HTTP by rank 0, {len(world) - 1} follower(s) in lock step: "
        "TTFT " + ", ".join(f"{a['ttft_ms']:.1f}" for a in tp2) + " ms, then "
        + ", ".join(f"{a['ms_per_token']:.1f}" for a in tp2) + " ms per token (two streams "
        "after 6 concurrent requests); the same traffic at tp = 1: TTFT "
        + ", ".join(f"{a['ttft_ms']:.1f}" for a in tp1) + " ms, "
        + ", ".join(f"{a['ms_per_token']:.1f}" for a in tp1) + f" ms per token ({SHARED_CARD}: "
        "not a TP speed)")
    return held


def p9_margins(params, config, dev, prompt, toks):
    """Which of the greedy ``toks`` after ``prompt`` the tp = 1 model
    decides: its logits along them (one forward), the margin above twice the
    bf16 threshold."""
    from flute_tpu_torch.models import llama

    seq = torch.tensor([list(prompt) + list(toks)], device=dev)
    cache = llama.init_cache(config, 1, seq.shape[1], device=dev)
    with torch.inference_mode():
        logits, _ = llama.forward(params, config, seq, cache, 0)
    return decided_steps(logits[0, len(prompt) - 1:len(prompt) - 1 + len(toks)]).cpu()


def p9_entry_traffic(client, prompts) -> dict:
    """The entry point's requests: the second prompt plain (the server's
    first request, which warms it), then the first streamed, then a prompt
    the pool cannot hold, plain and streamed."""
    t0 = time.perf_counter()
    status, body = client.post({"prompt": prompts[1], "max_tokens": NEW_TOKENS})
    first_s = time.perf_counter() - t0
    if status != 200:
        raise AssertionError(f"[entry] plain request: {status} {body}")
    toks, ttft, rest = client.stream({"prompt": prompts[0], "max_tokens": NEW_TOKENS,
                                      "stream": True})
    big = {"prompt": [1] * P9_ENTRY_REFUSED, "max_tokens": NEW_TOKENS}
    refused = [client.post(dict(big, stream=s)) for s in (False, True)]
    if any(code != 400 or "pool has" not in b["error"] for code, b in refused):
        raise AssertionError(f"[entry] the unfittable request: {refused}")
    return dict(tokens=[toks, body["tokens"]], first_request_s=first_s, ttft_ms=ttft * 1e3,
                ms_per_token=rest * 1e3 / (len(toks) - 1), refused=[b["error"] for _, b in refused])


def p9_entry_server(argv, log_path) -> tuple:
    """``python -m flute_tpu_torch.integrations.cli`` with ``argv`` in a
    process group of its own (stderr to ``log_path``): the process, its
    URL and rank processes, and the seconds to the URL."""
    import select

    t0 = time.perf_counter()
    err = open(log_path, "w")
    proc = subprocess.Popen([sys.executable, "-m", "flute_tpu_torch.integrations.cli", *argv],
                            stdout=subprocess.PIPE, stderr=err, text=True, cwd=HERE,
                            start_new_session=True)
    err.close()
    ready, _, _ = select.select([proc.stdout], [], [], 300)
    line = proc.stdout.readline() if ready else ""
    if not line.startswith("serving on "):
        os.killpg(proc.pid, signal.SIGKILL)
        proc.wait()
        raise AssertionError(f"[entry] no URL: {line!r}; {open(log_path).read()[-3000:]}")
    return proc, line.split()[-1], p9_spawned(proc.pid), time.perf_counter() - t0


def p9_spawned(pid) -> list[int]:
    """The processes ``pid`` spawned with multiprocessing (a world's ranks),
    in start order: its children whose command line is spawn_main's, each
    the leader of its thread group (a kernel may list a child's threads)."""
    with open(f"/proc/{pid}/task/{pid}/children") as f:
        children = [int(c) for c in f.read().split()]
    out = []
    for child in children:
        try:
            with open(f"/proc/{child}/status") as f:
                tgid = int(re.search(r"^Tgid:\s+(\d+)", f.read(), re.M).group(1))
            with open(f"/proc/{child}/cmdline", "rb") as f:
                if tgid == child and b"spawn_main" in f.read():
                    out.append(child)
        except FileNotFoundError:  # a thread that has ended
            continue
    return out


def p9_gone(pid) -> bool:
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().split(")")[-1].split()[0] == "Z"
    except FileNotFoundError:
        return True


def p9_entry(dev, qparams, config) -> dict:
    """serve --tp 2 through the entry point at P9_SHORT layers of phase 9's
    weights (a checkpoint with config.json beside it), for each of
    P9_ENTRY_MODES (the speculative one drafts with the same checkpoint):
    the server as a process, its requests (p9_entry_traffic), then SIGINT
    to its process group; its greedy tokens against the same server at tp
    = 1 in this process, up to the first near tie of the tp = 1 model."""
    from flute_tpu_torch.integrations import checkpoint, cli
    from flute_tpu_torch.serving import server

    short = p9_config(layers=P9_SHORT)
    params, _ = p9_cut(qparams, config, P9_SHORT)
    ckpt = os.path.join(P9_DIR, "entry")
    checkpoint.save_quantized(ckpt, params)
    with open(os.path.join(ckpt, "config.json"), "w") as f:
        json.dump(hf_config_json(short), f)
    prompts = serving_prompts(short)[:2]
    common = ["serve", "--checkpoint", ckpt, "--num-slots", "8", "--max-len", "512",
              "--block-size", "16", "--num-blocks", str(P9_ENTRY_BLOCKS), "--port", "0",
              "--device", P9_DEVICE]
    out = {}
    for mode, extra in P9_ENTRY_MODES.items():
        if "--speculative-k" in extra:
            extra = extra + ["--draft-checkpoint", ckpt]
        eng, _ = cli.build_serve_engine(cli.build_parser().parse_args(common + extra))
        srv = server.serve(eng, port=0)
        try:
            ref = p9_entry_traffic(Client(srv), prompts)
        finally:
            srv.shutdown()
            srv.loop.shutdown()
        del eng, srv
        release()
        proc, url, ranks, start_s = p9_entry_server(common + extra + ["--tp", "2"],
                                                    os.path.join(P9_DIR, "entry.log"))
        try:
            got = p9_entry_traffic(Client(url.rsplit("/v1/", 1)[0]), prompts)
            t0 = time.perf_counter()
            os.killpg(proc.pid, signal.SIGINT)
            rc = proc.wait(timeout=30)
            while not all(p9_gone(r) for r in ranks) and time.perf_counter() - t0 < 30:
                time.sleep(0.1)
            stop_s = time.perf_counter() - t0
        finally:
            if proc.poll() is None:
                os.killpg(proc.pid, signal.SIGKILL)
                proc.wait()
        if rc != 0 or len(ranks) != 2 or not all(p9_gone(r) for r in ranks):
            raise AssertionError(f"[entry {mode}] exit code {rc}, ranks {ranks} gone "
                                 f"{[p9_gone(r) for r in ranks]}; "
                                 f"{open(os.path.join(P9_DIR, 'entry.log')).read()[-3000:]}")
        ties = []
        for prompt, a, b in zip(prompts, got["tokens"], ref["tokens"]):
            if len(a) != NEW_TOKENS or len(b) != NEW_TOKENS:
                raise AssertionError(f"[entry {mode}] {len(a)} and {len(b)} tokens")
            differ = [i for i, (x, y) in enumerate(zip(a, b)) if x != y]
            if differ and p9_margins(params, short, dev, prompt, b)[differ[0]]:
                raise AssertionError(f"[entry {mode}] token {differ[0]} differs from tp = 1's "
                                     "where tp = 1 decides it")
            ties.append(differ[0] if differ else None)
        out[mode] = dict(start_s=start_s, stop_s=stop_s, exit_code=rc, first_difference=ties,
                         first_request_s=got["first_request_s"],
                         tp1_first_request_s=ref["first_request_s"],
                         ttft_ms=got["ttft_ms"], ms_per_token=got["ms_per_token"],
                         tp1_ttft_ms=ref["ttft_ms"], tp1_ms_per_token=ref["ms_per_token"],
                         refused=got["refused"])
        log(f"  [entry {mode}] serve --tp 2 --port 0 as a process, {P9_SHORT} layers: URL in "
            f"{start_s:.1f} s; streamed and plain greedy tokens = tp = 1's"
            + ("" if ties == [None, None] else f" (first difference {ties}, a near tie)")
            + f"; the unfittable request 400 plain and streamed; SIGINT: exit code {rc}, both "
            f"ranks gone in {stop_s:.1f} s; the first request {got['first_request_s']:.2f} s "
            f"(tp = 1 {ref['first_request_s']:.2f}); then the stream's TTFT "
            f"{got['ttft_ms']:.1f} ms, then "
            f"{got['ms_per_token']:.1f} ms per token; tp = 1 {ref['ttft_ms']:.1f} ms, "
            f"{ref['ms_per_token']:.1f} ms ({SHARED_CARD}: not a TP speed)")
    return out


def p9_pipeline(dev, params, config) -> dict:
    """PipelinedModel with 2 stages on one device at full depth: forward
    against llama.forward (prefill of 8 x 32 tokens, then 2 decode steps),
    forward_microbatched (2 microbatches, resident caches) against
    forward."""
    from flute_tpu_torch.models import llama
    from flute_tpu_torch.parallel.pp import PipelinedModel, split_cache_microbatches

    pm = PipelinedModel.build(params, config, num_stages=2, devices=[dev])
    toks = torch.from_numpy(np.random.default_rng(9).integers(1, config.vocab_size, (8, 32))).to(
        dev)
    s = 64

    def run(step):
        out = [step(toks, 0)]
        for i in range(2):
            out.append(step(out[-1][:, -1].argmax(-1)[:, None], 32 + i))
        return [o.float() for o in out]

    mono_cache = llama.init_cache(config, 8, s, device=dev)
    with torch.inference_mode():
        mono = run(lambda t, p: llama.forward(params, config, t, mono_cache, p)[0].clone())
    caches = pm.init_cache(8, s)
    reset_counters()
    seq = run(lambda t, p: pm.forward(t, caches, p)[0])
    seq_launches = launches_now()["w4sym"]
    caches_mb = split_cache_microbatches(pm.init_cache(8, s), 2)
    reset_counters()
    mb = run(lambda t, p: pm.forward_microbatched(t, caches_mb, p, num_microbatches=2)[0])
    mb_launches = launches_now()["w4sym"]
    out = {}
    for name, got, want in (("forward vs llama.forward", seq, mono),
                            ("forward_microbatched vs forward", mb, seq)):
        errs = [float((g - w).abs().max() / w.abs().max()) for g, w in zip(got, want)]
        bits = all(torch.equal(g, w) for g, w in zip(got, want))
        decided = [decided_steps(w[:, -1]) for w in want]
        tokens = all(torch.equal(g[:, -1].argmax(-1)[d], w[:, -1].argmax(-1)[d])
                     for g, w, d in zip(got, want, decided))
        if max(errs) >= THRESHOLDS[torch.bfloat16] or not tokens:
            raise AssertionError(f"[pp] {name}: rel errs {errs}, tokens equal {tokens}")
        out[name] = dict(max_rel_err=max(errs), bit_equal=bits, tokens_equal=tokens)
        log(f"  [pp] {name}: max rel err {max(errs):.2e}, bit-equal {bits}, tokens equal "
            "where decided")
    layers = config.num_layers
    if seq_launches != 3 * 4 * layers or mb_launches != 2 * 3 * 4 * layers:
        raise AssertionError(f"[pp] K1 launches {seq_launches} and {mb_launches}")
    out["launches"] = dict(forward=seq_launches, microbatched=mb_launches)
    return out


def p9_native() -> dict:
    """The native packer, built with g++ here, on one Llama-3.1-8B layer's
    four projections at 4 bits (planes), 3 bits (wide) and w4sym: bit-equal
    to the numpy packers, unpacked back to the codes, timed against them."""
    from flute_tpu_torch import native, packing

    t0 = time.perf_counter()
    if not native.available():
        raise AssertionError("the native packer did not build")
    build_s = time.perf_counter() - t0
    fmts = {
        "4-bit planes": (16, lambda c, n: packing.pack_np(c, 4, use_native=n),
                         lambda p: packing.unpack_np(p, 4)),
        "3-bit wide": (8, lambda c, n: packing.pack_w3_wide_np(c, use_native=n),
                       lambda p: packing.unpack_np(p, 3)),
        "w4sym": (16, lambda c, n: packing.pack_w4_sym_np(c, use_native=n),
                  lambda p: packing.unpack_w4_sym_np(p[0])),
    }
    rng = np.random.default_rng(9)
    out = dict(build_s=build_s, library=os.path.relpath(native.library_path(native.MARCHES[0]),
                                                        HERE))
    for fmt, (e, pack, unpack) in fmts.items():
        t_native = t_numpy = 0.0
        for name, n, k in LAYER_SHAPES:
            codes = rng.integers(0, e, (k, n), dtype=np.int32)
            t = time.perf_counter()
            got = pack(codes, True)
            t_native += time.perf_counter() - t
            t = time.perf_counter()
            want = pack(codes, False)
            t_numpy += time.perf_counter() - t
            if not all(np.array_equal(g, w) for g, w in zip(got, want)):
                raise AssertionError(f"[native] {fmt} {name}: differs from numpy")
            if not np.array_equal(unpack(got), codes):
                raise AssertionError(f"[native] {fmt} {name}: unpack round trip")
        out[fmt] = dict(native_s=t_native, numpy_s=t_numpy)
        log(f"  [native] {fmt}: one layer's 4 projections packed in {t_native:.3f} s, numpy "
            f"{t_numpy:.2f} s; bit-equal, unpacked back to the codes")
    log(f"  [native] {out['library']} loaded and checked in {build_s:.1f} s (built at its "
        "first use in this run)")
    return out


def phase_parallel(dev, results) -> dict:
    """Phase 9: the kernels at shard shapes; the seed-0 w4sym model of
    phase 4 through a checkpoint to gloo worlds on the card (Engine,
    PagedEngine with pool prefill, ContinuousBatchingEngine and
    PagedSpeculativeEngine at tp = 2, the first two also through serve
    --tp's loop over HTTP; Engine at tp = 4) against the same engines at
    tp = 1; serve --tp 2 through the entry point at P9_SHORT layers; the
    pipeline; the native packer."""
    from flute_tpu_torch.integrations import checkpoint
    from flute_tpu_torch.models import llama
    from flute_tpu_torch.parallel import launch, validate_tp

    t_start = time.perf_counter()
    out = dict(kernels=p9_kernels(dev) if dev.type == "cuda" else None)
    config = p9_config()
    params = llama.init_params(config, seed=0, device=dev)
    qparams = llama.quantize_model(params, group_size=GROUP, fuse=True, device=dev)
    del params
    gc.collect()
    for tp in TP_SIZES:
        validate_tp(qparams, config, tp)
    ckpt = os.path.join(P9_DIR, "w4sym")
    shutil.rmtree(P9_DIR, ignore_errors=True)
    t0 = time.perf_counter()
    checkpoint.save_quantized(ckpt, qparams)
    log(f"  wrote the {config.num_layers}-layer w4sym checkpoint in "
        f"{time.perf_counter() - t0:.1f} s")
    worlds = {2: [(kind, None) for kind in P9_RUNS] + [("Engine", P9_SHORT)]
                 + [(P9_HTTP + kind, None) for kind in P9_HTTP_RUNS],
              4: [("Engine", None), ("Engine", P9_SHORT)]}
    failures = []
    try:
        refs = {run: p9_drive(run[0], *p9_cut(qparams, config, run[1]), dev)
                for run in dict.fromkeys(worlds[2] + worlds[4])
                if not run[0].startswith(P9_HTTP)}
        floors = {(tp, layers): p9_floor(dev, *p9_cut(qparams, config, layers),
                                         refs["Engine", layers], tp)
                  for tp, runs in worlds.items() for _, layers in runs}
        for (tp, layers), floor in floors.items():
            log(f"  another summation order alone (o and down summed {tp} ways, tp = 1, "
                f"{layers or config.num_layers} layers): logits within {floor:.2e}")
        out["sum_order_floors"] = {f"tp{tp} {layers or config.num_layers} layers": f
                                   for (tp, layers), f in floors.items()}
        for tp, runs in worlds.items():
            t0 = time.perf_counter()
            world = launch.run(p9_rank, tp, ckpt, runs, P9_DEVICE, P9_CONFIG, threads=2,
                               timeout=600)
            log(f"  the world of {tp} ran in {time.perf_counter() - t0:.1f} s")
            out[f"tp{tp}"] = {}
            for kind, layers in runs:
                name = p9_name(kind, layers)
                limit = min(max(THRESHOLDS[torch.bfloat16], 2 * floors[tp, layers]),
                            P9_LIMIT_CAP)
                try:
                    if kind.startswith(P9_HTTP):
                        out[f"tp{tp}"][name] = p9_hold_http(
                            f"tp={tp} {name}", world, name, kind[len(P9_HTTP):], qparams,
                            config, dev, limit)
                    else:
                        out[f"tp{tp}"][name] = p9_hold(f"tp={tp} {name}", world,
                                                       refs[kind, layers], name, kind,
                                                       layers or config.num_layers, limit)
                except AssertionError as e:  # held after every run is read
                    log(f"  FAILED: {e}")
                    failures.append(str(e))
            del world
        del refs
        t0 = time.perf_counter()
        out["entry"] = p9_entry(dev, qparams, config)
        log(f"  the entry point's runs took {time.perf_counter() - t0:.1f} s")
    finally:
        shutil.rmtree(P9_DIR, ignore_errors=True)
    if failures:
        raise AssertionError("phase 9: " + "; ".join(failures))
    out["pp"] = p9_pipeline(dev, qparams, config)
    del qparams
    gc.collect()
    out["native"] = p9_native()
    out["seconds"] = time.perf_counter() - t_start
    log(f"  phase 9 took {out['seconds']:.0f} s")
    results["parallel"] = out
    return out


def p9_kernel_numbers(p9, kid) -> dict:
    """The ``tp`` entry of a kernel's line: its time at the shard shapes or
    local heads beside its bound and yardstick, and its launches a rank in
    each TP run."""
    entry = {}
    for tp in TP_SIZES:
        cases = p9["kernels"][tp][kid]
        if kid == "K1":
            entry[f"tp{tp}"] = _stack_numbers(cases)
            continue
        first, *served = cases
        entry[f"tp{tp}"] = dict(_stack_numbers([first]), heads=first["heads"], case=first["case"],
                                served=[dict(_stack_numbers([c]), case=c["case"])
                                        for c in served])
    key = KERNELS[kid][2]
    entry["launches_per_rank"] = {f"{tp} {kind}": run["launches_per_rank"][key]
                                  for tp in ("tp2", "tp4") for kind, run in p9[tp].items()
                                  if run["launches_per_rank"][key]}
    return entry


# the wide-M kernel's decoders, by a part of their mangled names
WIDE_DECODERS = (("W4SymFill", "K1"), ("ScalarFill", "K2"), ("JointFill", "K4"),
                 ("W3WideDecoder", "K3"))


def wide_ptxas(sources) -> list:
    """Registers and spill of every wide_m_kernel instantiation, from the
    libraries' ptxas logs; fails where ptxas serialized the kernel's wgmma
    (a C7510-C7520 line naming it: every product would wait)."""
    from flute_tpu_torch.ops import _build

    out = []
    for source in sources:
        ptxas = _build.library_path(source).with_suffix(".log").read_text()
        for block in re.split(r"(?=ptxas info\s*: Compiling entry function)", ptxas):
            head = re.match(r"ptxas info\s*: Compiling entry function '(\S+)'", block)
            if not head or "wide_m_kernel" not in head.group(1):
                continue
            mangled = head.group(1)
            if re.search(r"C75\d\d", block) and "wgmma" in block:
                raise AssertionError(f"{source}: ptxas serialized wgmma in {mangled}: {block}")
            regs = re.search(r"Used (\d+) registers", block)
            spill = re.search(r"(\d+) bytes spill stores", block)
            decoder = next((d for key, d in WIDE_DECODERS if key in mangled), "?")
            decoder += " f16" if "wide_m_kernelI6__half" in mangled else " bf16"
            if decoder.startswith("K3"):
                chunk_scales = re.search(r"W3WideDecoderI\w+?Lb([01])E", mangled)
                decoder += (" chunk scales" if chunk_scales and chunk_scales.group(1) == "1"
                            else " field scales")
            else:
                bits = re.search(r"Li(\d)E", mangled)
                decoder += f" {bits.group(1)}-bit" if bits else ""
            # the row tile and the route (the kernel's last template arguments)
            tile = re.search(r"Li(\d+)ELb([01])EE", mangled)
            route = "mid" if tile and tile.group(2) == "1" else "wide"
            decoder += f" {route} R={tile.group(1) if tile else '?'}"
            row = dict(source=source, decoder=decoder, route=route,
                       rows=int(tile.group(1)) if tile else None,
                       registers=int(regs.group(1)) if regs else None,
                       spill_store_bytes=int(spill.group(1)) if spill else 0)
            out.append(row)
            log(f"    ptxas wide_m_kernel {decoder:34s} {row['registers']} registers, "
                f"{row['spill_store_bytes']} bytes of spill stores ({source})")
    if not out:
        raise AssertionError("no wide_m_kernel in the ptxas logs")
    return out


def check_k4_ring(instances):
    """K4's joint table is K2's size ((2^b)^2 pairs in 8 copies): its wide
    kernel's shared memory equals K2's at every bit width, as
    kernel_config.wide_ring assumes."""
    wide = {(i["kernel"], i["bits"], i["instance"]): i["smem_bytes"] for i in instances
            if i["instance"].startswith("wide") and i["chunk"] == 256}
    for bits in (2, 3, 4):
        for dt in ("bfloat16", "float16"):
            k4, k2 = wide[("pair", bits, f"wide {dt}")], wide[("plane", bits, f"wide {dt}")]
            if k4 != k2:
                raise AssertionError(f"K4's wide ring at {bits} bits {dt}: {k4} bytes, K2's {k2}")


def check_mid_occupancy(instances, ptxas):
    """The mid route's instantiations (K1, K2 and K4 at each row tile, K3
    in both scale modes, bf16 and f16) fit the blocks an SM their registers
    and ring are sized for (kernel_config.MID_BLOCKS; K3 with the per-field
    scale cache one, kernel_config.mid_blocks), ptxas printed each of them,
    and K3's served mode (a chunk's scales once per field) spills nothing."""
    from flute_tpu_torch.ops import kernel_config

    mid = [i for i in instances if i["instance"].startswith("mid")]
    want_blocks = {(i["kernel"], i.get("scales")): 1 if i.get("scales") == "field"
                   else kernel_config.MID_BLOCKS for i in mid}
    short = [i for i in mid if i["blocks_per_sm"] < want_blocks[i["kernel"], i.get("scales")]]
    if not mid or short:
        raise AssertionError(f"mid route instantiations {len(mid)}, fewer blocks an SM than "
                             f"they are sized for: {short}")
    # K1's 4-bit row tiles, K2's and K4's at 2, 3 and 4 bits, K3's in two
    # scale modes, each in two dtypes
    want = 2 * len(kernel_config.MID_ROWS) * (1 + 3 + 3 + 2)
    rows = [r for r in ptxas if r["route"] == "mid"]
    if len(rows) != want:
        raise AssertionError(f"ptxas printed {len(rows)} mid instantiations, expected {want}")
    k3 = [r for r in rows if r["decoder"].startswith("K3") and "chunk scales" in r["decoder"]]
    if len(k3) != 2 * len(kernel_config.MID_ROWS) or any(r["spill_store_bytes"] for r in k3):
        raise AssertionError(f"K3's served mid instantiations spill: {k3}")
    log(f"  mid route: {len(mid)} instantiations, {min(i['blocks_per_sm'] for i in mid)}-"
        f"{max(i['blocks_per_sm'] for i in mid)} blocks an SM, "
        f"{min(i['registers'] for i in mid)}-{max(i['registers'] for i in mid)} registers, "
        f"at most {max(r['spill_store_bytes'] for r in rows)} bytes of spill stores; K3's "
        f"with a chunk's scales {max(r['registers'] for r in k3)} registers, no spill")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    from flute_tpu_torch.lab import ops as lab_ops
    from flute_tpu_torch.lab import ops2 as lab2_ops
    from flute_tpu_torch.models import llama
    from flute_tpu_torch.ops import _build, lut_gemm
    from flute_tpu_torch.ops import paged_attention as pa

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    results = {"torch": torch.__version__, "cuda": torch.version.cuda}
    t_start = time.perf_counter()

    header("1. card and build", t_start)
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
        if source not in lab_ops.LOOP_LIBRARIES:
            continue
        for kernel in loop_report(source, ptxas):
            log(f"    {kernel['decoder']:20s} {kernel['scaling']:9s} {kernel['registers']} "
                f"registers, {kernel['spill_bytes']} bytes of spill stores, "
                f"{kernel['smem_bytes']} bytes of shared memory at bk {kernel['bk']}, "
                f"{kernel['blocks_per_sm']} blocks per SM")
            results.setdefault("lab_loop_ptxas", []).append(kernel)
    results["build_s"] = build_s
    for kernel, chunk in (("w4sym", 256), ("plane", 256), ("pair", 256), ("w3wide", 256),
                          ("w3wide", 512)):
        for inst in lut_gemm.kernel_instances(kernel, chunk):
            scales = f" ({inst['scales']} scales)" if "scales" in inst else ""
            log(f"    {kernel} {inst['bits']}-bit {inst['instance']:20s}{scales} "
                f"{inst['registers']} registers, {inst['smem_bytes']} bytes of shared memory at "
                f"chunk {chunk}, {inst['blocks_per_sm']} blocks per SM")
            results.setdefault("tc_instances", []).append(inst)
    results["wide_ptxas"] = wide_ptxas(sources)
    check_k4_ring(results["tc_instances"])
    check_mid_occupancy(results["tc_instances"], results["wide_ptxas"])

    header("2. kernels against plain on the card", t_start)
    cases = phase_kernel(dev, results)
    attn_checks, attn_timed = phase_attention(dev, results)
    header("2b. the Hopper lab (L1-L6)", t_start)
    lab_cases, lab_checks, lab_launches = phase_lab(dev, results)
    header("2c. the Hopper lab, second half (L7-L12)", t_start)
    lab_floor = next(c for c in lab_cases if c["variant"] == "floor")
    lab2_cases, lab2_checks, lab2_launches = phase_lab2(dev, results,
                                                        lab_cases[0]["library_us"],
                                                        lab_floor["us"])
    lab_before = dict(lab_ops.LAUNCHES)
    lab2_before = dict(lab2_ops.LAUNCHES)
    header("3. model logits against the CPU plain path; checkpoint round trip", t_start)
    phase_logits(dev, results)
    header("4. serving Llama-3.1-8B widths, 32 layers", t_start)
    results["serving"] = {}
    launches = {}
    engines = {}
    trajectories = {}
    for name, (kw, kid) in SERVED.items():
        layout = KERNELS[kid][2]
        results["serving"][name], engines[name], trajectories[name] = serve(dev, name, kw,
                                                                            layout)
        launches[kid] = results["serving"][name]["launches"][layout]
    log("  prefill of 8 prompts (512 rows, host clock): " + ", ".join(
        f"{name} {results['serving'][name]['prefill_ms']:.1f} ms" for name in SERVED))
    paged_eng, prompts = phase_paged(dev, results, engines, trajectories)
    log(f"  prefill of 512 rows (host clock): HIGGS-W4 Engine "
        f"{results['serving']['higgs_w4']['prefill_ms']:.1f} ms, w4sym "
        f"{results['serving']['w4sym']['prefill_ms']:.1f} ms, W3 "
        f"{results['serving']['w3wide']['prefill_ms']:.1f} ms")
    higgs_launches = results["serving"]["paged_higgs_w4"]["launches"]
    for kid in ("K4", "K5", "K6"):
        launches[kid] = higgs_launches[KERNELS[kid][2]]
    for name, eng in engines.items():
        results["serving"][name]["profile"] = profile_decode(dev, name, eng)
        check_copies(name, results["serving"][name]["profile"])
    for name, kid in (("w4sym", "K1"), ("w3wide", "K3")):
        results["serving"][name]["prefill_profile"] = profile_prefill(dev, name, engines[name],
                                                                      kid)
    higgs_profile = profile_paged("paged HIGGS-W4", paged_eng, prompts)
    results["serving"]["paged_higgs_w4"]["profile"] = higgs_profile
    check_copies("paged HIGGS-W4", higgs_profile)
    for name in (*SERVED, "paged_higgs_w4"):
        report_served_idle(name, results["serving"][name])
    admission = higgs_profile["admission_step"]["groups_ms_per_step"]
    if higgs_profile["groups_ms_per_step"] is not None and admission is not None:
        groups = higgs_profile["groups_ms_per_step"]
        # one K5 call per layer and decode step
        k5_call_us = (groups["K5"] + groups["K5 merge"]) * 1e3 / llama.LlamaConfig.llama31_8b(
        ).num_layers
        higgs_profile["k5_us_per_call"] = k5_call_us
        log(f"  [paged HIGGS-W4] K4 {groups['K4']:.3f} ms (+ split-K reduction "
            f"{groups['split-K reduction']:.3f} ms) per decode "
            f"step; K5 {groups['K5']:.3f} ms (+ merge {groups['K5 merge']:.3f} ms), "
            f"{k5_call_us:.2f} us per call; K6 {admission['K6']:.3f} ms in the step that admits "
            f"8 requests; no decode step converts a tensor of {LARGE_COPY_ELEMENTS} elements "
            "or more")
        higgs = results["serving"]["paged_higgs_w4"]
        new = higgs_profile["admission_new_prompts"]
        log(f"  [paged HIGGS-W4] the step that admits the 8 prompts again (prefix hits: at most "
            f"16 rows an admission): K4 {admission['K4']:.2f} ms (on the mid route "
            f"{admission['mid-M (K1-K4)']:.2f} ms) + split-K reduction "
            f"{admission['split-K reduction']:.2f} ms of "
            f"{higgs_profile['admission_step']['device_ms_per_step']:.2f} ms busy; a step that "
            f"admits 8 new prompts: K4 {new['mid']['lut_ms']:.2f} ms (on the mid route "
            f"{new['mid']['mid_ms']:.2f}) of {new['mid']['busy_ms']:.2f} ms busy, with the mid "
            f"route off (the loop) K4 {new['loop']['lut_ms']:.2f} ms of "
            f"{new['loop']['busy_ms']:.2f} ms busy (mean of two turns each); prefill "
            f"{higgs['prefill_ms_per_admission']:.1f} ms per admission (median, host clock)")
    del engines, paged_eng
    release()
    header("5. serving Gemma-2-9B widths, 42 layers", t_start)
    gemma = phase_gemma2(dev, results)
    report_served_idle("gemma2 w4sym", gemma["engine"])
    gemma_launches = {"K1": {run: gemma[run]["launches"]["w4sym"]
                             for run in ("engine", "engine_long", "paged")},
                      "K5": gemma["paged"]["launches"]["paged_decode"],
                      "K6": gemma["paged"]["launches"]["paged_verify"]}
    header("6. continuous batching and speculative decoding, Llama-3.1-8B widths, 32 layers",
           t_start)
    spec = phase_spec(dev, results, trajectories["w4sym"])
    header("7. the quantized lm_head, the HTTP server and perplexity, Llama-3.1-8B widths, "
           "32 layers", t_start)
    phase7 = phase_head_server_ppl(dev, results, trajectories["w4sym"])
    release()
    header(f"8. the CLI from an HF directory at Llama-3.1-8B widths, {CLI_LAYERS} layers",
           t_start)
    phase8 = phase8_launches(phase_cli(dev, results))
    lab_served = {fn: lab_ops.LAUNCHES[fn] - lab_before[fn] for fn in lab_before}
    lab2_served = {fn: lab2_ops.LAUNCHES[fn] - lab2_before[fn] for fn in lab2_before}
    if any(lab_served.values()) or any(lab2_served.values()):
        raise AssertionError(f"phases 3-8 launched lab kernels: {lab_served}, {lab2_served}")
    log(f"  lab kernels launched in phases 3-8: {lab_served}, {lab2_served}")
    release()
    header("9. tensor and pipeline parallelism at Llama-3.1-8B widths; the host packer", t_start)
    p9 = phase_parallel(dev, results)

    kernels = [kernel_line(kid, cases, launches[kid], results["identity_paths"],
                           gemma_launches.get(kid), spec) for kid in LUT_KERNELS]
    kernels[0].update(phase7_numbers(phase7))
    # the wide-M route of K1-K4: launched by phase 4's Engine prefills (K4's
    # by the HIGGS-W4 Engine), K1's also by Gemma-2's (phase 5) and by
    # perplexity (phase 7)
    wide = {kid: results["serving"][name]["wide_launches"][f"{ROUTE_LAYOUT[kid]}_wide"]
            for kid, name in (("K1", "w4sym"), ("K2", "w4_general"), ("K3", "w3wide"),
                              ("K4", "higgs_w4"))}
    gemma_wide = {run: gemma[run]["wide_launches"]["w4sym_wide"]
                  for run in ("engine", "engine_long")}
    ppl_wide = {name: run["wide_launches"]["w4sym_wide"]
                for name, run in phase7["perplexity"].items()}
    if not (all(wide.values()) and all(gemma_wide.values())
            and ppl_wide["quantized batch 1"]):
        raise AssertionError(f"the wide-M route was not launched: phase 4 {wide}, phase 5 "
                             f"{gemma_wide}, phase 7 {ppl_wide}")
    wide_lines = [wide_line("K1", results["wide_sweep"], wide["K1"], gemma_wide, ppl_wide)] + [
        wide_line(kid, results["wide_sweep"], wide[kid]) for kid in ("K2", "K3", "K4")]
    # the mid route of K1 and K2: launched by phase 6's verifies (K1) and
    # its paged W2 draft's 32-row prefills (K2); of K3 and K4 by phase 4's
    # paged admissions (W3 with dense prefill, HIGGS-W4 with pool prefill)
    mid = dict(spec["mid_launches"],
               w3wide_mid=results["serving"]["paged_w3wide"]["mid_launches"]["w3wide_mid"],
               pair_mid=results["serving"]["paged_higgs_w4"]["mid_launches"]["pair_mid"])
    if not all(mid[f"{ROUTE_LAYOUT[kid]}_mid"] for kid in LUT_KERNELS):
        raise AssertionError(f"the mid route was not launched in phases 4 and 6: {mid}")
    wide_lines += [mid_line(kid, results["wide_sweep"], mid[f"{ROUTE_LAYOUT[kid]}_mid"])
                   for kid in LUT_KERNELS]
    kernels[0]["qkv_m8_warm_cold"] = results["k1_qkv_warm_cold"]
    kernels += [attention_line(kid, attn_checks, attn_timed, launches[kid], gemma_launches[kid],
                               spec)
                for kid in ("K5", "K6")]
    kernels += [lab_line(kid, LAB, lab_cases, lab_checks, lab_launches, lab_served)
                for kid in LAB]
    kernels += [lab_line(kid, LAB2, lab2_cases, lab2_checks, lab2_launches, lab2_served)
                for kid in LAB2]
    kernels += wide_lines
    for line, kid in zip(kernels, (*LUT_KERNELS, "K5", "K6")):
        if not phase8.get(KERNELS[kid][2]):
            raise AssertionError(f"phase 8 launched no {kid}")
        line["phase8"] = dict(launches=phase8[KERNELS[kid][2]])
        if kid in ("K1", "K5", "K6"):
            line["tp"] = p9_kernel_numbers(p9, kid)
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
