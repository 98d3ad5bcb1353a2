#!/usr/bin/env python3
"""End-to-end check of the PyTorch / CUDA port (flute_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero):
  1. print the card's name and power limit; build the w4sym kernel from
     flute_tpu_torch/csrc into build/flute_tpu_torch/;
  2. hold the kernel against its plain PyTorch version on the card at the
     Llama-3.1-8B decoder-layer shapes, M in {1, 8, 128, 512}, bf16 and f16
     (relative Frobenius error under 1.1e-2 / 2e-3), identity input bit-exact
     in bf16/f16/f32 and unpack_via_kernel round-tripping the codes; time the
     kernel, the plain version and a bf16/f16 torch.matmul on the
     pre-dequantized weight (a yardstick only), L2-cold, in CUDA graphs;
  3. logits of a 2-layer model at Llama-3.1-8B widths (fused, w4sym): one
     prefill and one decode step on the card against the same params on the
     CPU plain path (max error relative to the largest logit < 1.1e-2);
  4. serve 8 ragged prompts for 16 new tokens through Engine.generate on
     the full 32-layer Llama-3.1-8B-width model (random weights from a
     seed, quantized on the card), checking the kernel's launch count.

Prints a {"kernels": [...]} line, then as its last line
{"ok": true, "device": {...}}. Writes the full results to
chiprun_out/chip_smoke.json. Needs a CUDA device; exits non-zero without one.
"""

import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
BF16_OPS_PER_S = 989e12  # H100 SXM dense bf16/f16 tensor rate
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


def log(*a):
    print(*a, flush=True)


def rel_err(y, ref) -> float:
    y, ref = y.double(), ref.double()
    return float(torch.linalg.norm(y - ref) / torch.linalg.norm(ref))


def sym_table(rng, mixed_signs=False) -> np.ndarray:
    mags = rng.standard_normal(8).astype(np.float32)
    if not mixed_signs:
        mags = np.sort(np.abs(mags))
    return np.concatenate([mags, -mags])


def make_weight(rng, gen, n, k, dtype, dev, chunk=256):
    from flute_tpu_torch import packing

    codes = torch.randint(0, 16, (k, n), generator=gen, device=dev, dtype=torch.int32)
    plane = packing.pack_w4_sym(codes, chunk=chunk)
    scales = (torch.rand((k // GROUP, n), generator=gen, device=dev) + 0.5).to(dtype)
    table = torch.from_numpy(sym_table(rng)).to(dev)
    return codes, plane, scales, table


def phase_kernel(dev, results):
    from flute_tpu_torch import packing
    from flute_tpu_torch.ops import lut_gemm
    from flute_tpu_torch.utils.benchmark import bench_op, cold_copies

    rng = np.random.default_rng(0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    cases = []
    for name, n, k in LAYER_SHAPES:
        for dtype in (torch.bfloat16, torch.float16):
            codes, plane, scales, table = make_weight(rng, gen, n, k, dtype, dev)
            deq = lut_gemm.dequantize_codes(codes, scales, table, dtype)
            wbytes = plane.numel() * 4 + scales.numel() * scales.element_size()
            copies = cold_copies(wbytes)
            planes_c = [plane.clone() for _ in range(copies)]
            scales_c = [scales.clone() for _ in range(copies)]
            deq_c = [deq.clone() for _ in range(cold_copies(deq.numel() * deq.element_size()))]
            for m in M_CASES:
                x = torch.randn((m, k), generator=gen, device=dev).to(dtype)
                y = lut_gemm.lut_qgemm_w4sym_cuda(
                    x, plane, scales, table, group_size=GROUP, chunk=256
                )
                y_plain = lut_gemm.lut_qgemm_plain(
                    x, [plane], scales, table, num_bits=4, chunk=256, layout="w4sym"
                )
                torch.cuda.synchronize()
                err = rel_err(y, y_plain)
                max_abs = float((y.float() - y_plain.float()).abs().max())
                if not err < THRESHOLDS[dtype]:
                    raise AssertionError(f"{name} M={m} {dtype}: rel err {err}")

                def kern(p, s, x=x, table=table):
                    return lut_gemm.lut_qgemm_w4sym_cuda(
                        x, p, s, table, group_size=GROUP, chunk=256
                    )

                def plain(p, s, x=x, table=table):
                    return lut_gemm.lut_qgemm_plain(
                        x, [p], s, table, num_bits=4, chunk=256, layout="w4sym"
                    )

                def library(w, x=x):
                    return torch.matmul(x, w)

                args = list(zip(planes_c, scales_c))
                t_k = bench_op(kern, args)
                t_p = bench_op(plain, args[:2], min_launches=2)
                t_l = bench_op(library, [(w,) for w in deq_c])
                esz = torch.tensor([], dtype=dtype).element_size()
                nbytes = wbytes + table.numel() * 4 + m * k * esz + m * n * esz
                t_bytes = nbytes / HBM_BYTES_PER_S
                t_ops = 2 * m * n * k / BF16_OPS_PER_S
                case = dict(
                    name=name, n=n, k=k, m=m, dtype=str(dtype).split(".")[-1],
                    rel_err=err, max_abs_err=max_abs, bytes=nbytes,
                    us=t_k * 1e6, plain_us=t_p * 1e6, library_us=t_l * 1e6,
                    bound_us=max(t_bytes, t_ops) * 1e6,
                    bound_by="bytes" if t_bytes >= t_ops else "operations",
                )
                case["share_of_bound"] = case["bound_us"] / case["us"]
                cases.append(case)
                log(
                    f"  {name:8s} M={m:<4d} {case['dtype']:9s} err={err:.2e} "
                    f"kernel {case['us']:9.1f} us  bound {case['bound_us']:7.1f} us "
                    f"({case['bound_by']}, {100 * case['share_of_bound']:5.1f}%)  "
                    f"plain {case['plain_us']:9.1f} us  matmul {case['library_us']:7.1f} us"
                )
            del planes_c, scales_c, deq_c, deq
    results["kernel_cases"] = cases

    # identity input: bit-exact against the oracle, at two pack chunks
    n, k = 256, 512
    for chunk in (128, 256):
        for dtype in (torch.bfloat16, torch.float16, torch.float32):
            for mixed in (False, True):
                codes = torch.randint(0, 16, (k, n), generator=gen, device=dev, dtype=torch.int32)
                plane = packing.pack_w4_sym(codes, chunk=chunk)
                scales = (torch.rand((k // GROUP, n), generator=gen, device=dev) + 0.5).to(dtype)
                table = torch.from_numpy(sym_table(rng, mixed_signs=mixed)).to(dev)
                eye = torch.eye(k, dtype=dtype, device=dev)
                got = lut_gemm.lut_qgemm_w4sym_cuda(
                    eye, plane, scales, table, group_size=GROUP, chunk=chunk
                )
                want = lut_gemm.dequantize_codes(codes, scales, table, dtype)
                if not torch.equal(got.float(), want.float()):
                    raise AssertionError(f"identity not bit-exact: {dtype} chunk={chunk}")
        back = packing.unpack_via_kernel([plane], 4, n, k, chunk=chunk, layout="w4sym")
        if not torch.equal(back, codes):
            raise AssertionError(f"unpack_via_kernel does not round-trip (chunk={chunk})")
    log("  identity bit-exact (bf16/f16/f32, chunk 128/256, mixed-sign table); "
        "unpack_via_kernel round-trips")
    results["identity_bit_exact"] = True
    return cases


def phase_logits(dev, results):
    from flute_tpu_torch.interop import move_params
    from flute_tpu_torch.models import llama

    config = dataclasses.replace(llama.LlamaConfig.llama31_8b(), num_layers=2)
    params = llama.init_params(config, seed=1, device=dev)
    qparams = llama.quantize_model(params, num_bits=4, group_size=GROUP, fuse=True, device=dev)
    del params
    cpu = torch.device("cpu")
    qcpu = move_params(qparams, cpu)
    rng = np.random.default_rng(1)
    b, t, s = 2, 16, 32
    tokens = torch.from_numpy(rng.integers(0, config.vocab_size, (b, t)))
    offsets = torch.tensor([0, 5])
    nxt = torch.from_numpy(rng.integers(0, config.vocab_size, (b, 1)))
    out = {}
    for name, p, d in (("cuda", qparams, dev), ("cpu", qcpu, cpu)):
        with torch.inference_mode():
            cache = llama.init_cache(config, b, s, device=d)
            pre, cache = llama.forward(p, config, tokens.to(d), cache, 0, offsets.to(d))
            dec, _ = llama.forward(p, config, nxt.to(d), cache, t, offsets.to(d))
        out[name] = (pre.cpu(), dec.cpu())
    errs = {}
    for i, step in enumerate(("prefill", "decode")):
        a, ref = out["cuda"][i], out["cpu"][i]
        if not torch.isfinite(a).all():
            raise AssertionError(f"non-finite {step} logits")
        errs[step] = float((a - ref).abs().max() / ref.abs().max())
        if not errs[step] < THRESHOLDS[torch.bfloat16]:
            raise AssertionError(f"{step} logits differ from the CPU plain path: {errs[step]}")
    log(f"  2-layer 8B-width logits vs CPU plain path: prefill {errs['prefill']:.2e}, "
        f"decode {errs['decode']:.2e}")
    results["logits_rel_err"] = errs


def phase_serving(dev, results):
    from flute_tpu_torch.models import llama
    from flute_tpu_torch.ops import lut_gemm
    from flute_tpu_torch.serving import Engine

    config = llama.LlamaConfig.llama31_8b()
    t0 = time.perf_counter()
    params = llama.init_params(config, seed=0, device=dev)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    qparams = llama.quantize_model(params, num_bits=4, group_size=GROUP, fuse=True, device=dev)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    del params
    torch.cuda.empty_cache()
    log(f"  init {t1 - t0:.1f} s, quantize {t2 - t1:.1f} s, "
        f"{torch.cuda.memory_allocated(dev) / 2**30:.2f} GiB allocated after quantization")

    rng = np.random.default_rng(2)
    lengths = [3, 40, 17, 8, 29, 5, 36, 12]
    prompts = [rng.integers(1, config.vocab_size, n).tolist() for n in lengths]
    new_tokens = 16
    eng = Engine(params=qparams, config=config, batch_size=8, max_len=256, device=dev)

    logits_seen = []
    forward = eng.forward

    def checked_forward(*a, **kw):
        logits, cache = forward(*a, **kw)
        logits_seen.append(bool(torch.isfinite(logits).all()))
        return logits, cache

    eng.forward = checked_forward
    lut_gemm.LAUNCHES = 0
    out = eng.generate(prompts, max_new_tokens=new_tokens)
    launches = lut_gemm.LAUNCHES
    eng.forward = forward

    steps = len(logits_seen)  # one prefill + the decode steps
    expected = steps * config.num_layers * 4
    if steps != new_tokens or launches != expected:
        raise AssertionError(f"{launches} kernel launches over {steps} steps, expected {expected}")
    if not all(logits_seen):
        raise AssertionError("non-finite logits while serving")
    if any(len(o) != new_tokens for o in out):
        raise AssertionError(f"a prompt got {[len(o) for o in out]} tokens")
    tm = eng.last_timings
    decode_s = [float(d) for d in tm["decode_s"]]
    dec = float(np.median(decode_s))
    total = tm["prefill_s"] + sum(decode_s)
    serving = dict(
        prompts=len(prompts), prompt_lengths=lengths, new_tokens=new_tokens,
        steps=steps, launches=launches, prefill_ms=tm["prefill_s"] * 1e3,
        decode_ms_per_step=dec * 1e3, decode_ms_steps=[d * 1e3 for d in decode_s],
        decode_tok_s=len(prompts) / dec, end_to_end_tok_s=len(prompts) * new_tokens / total,
        peak_gib=torch.cuda.max_memory_allocated(dev) / 2**30,
    )
    log(f"  served {len(prompts)} prompts x {new_tokens} tokens: prefill "
        f"{serving['prefill_ms']:.1f} ms, decode {serving['decode_ms_per_step']:.2f} ms/step "
        f"(median), {serving['decode_tok_s']:.1f} decode tok/s, "
        f"{serving['end_to_end_tok_s']:.1f} tok/s end to end, {launches} kernel launches")

    # where a decode step's device time goes (outside the counted run)
    with torch.inference_mode():
        toks = torch.from_numpy(rng.integers(1, config.vocab_size, (8, 64))).to(dev)
        offs = torch.zeros(8, dtype=torch.int64, device=dev)
        _, cache = eng.prefill(toks, offs)
        nxt = toks[:, -1:]
        eng.decode(nxt, cache, 64, offs)
        torch.cuda.synchronize()
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            for i in range(3):
                eng.decode(nxt, cache, 65 + i, offs)
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
    serving["profile"] = dict(
        wall_ms_per_step=wall / 3 * 1e3,
        device_ms_per_step=dev_ms if by_kernel else None,
        idle_share=(1 - dev_ms / (wall / 3 * 1e3)) if by_kernel else None,
        top_kernels_ms_per_step=top,
    )
    if by_kernel:
        log(f"  decode step profile: wall {wall / 3 * 1e3:.2f} ms, device busy {dev_ms:.2f} ms "
            f"(idle share {serving['profile']['idle_share']:.2f})")
        for k_name, ms in top:
            log(f"    {ms:8.3f} ms  {k_name[:100]}")
    else:
        log("  decode step profile: the profiler recorded no device time (not measured)")
    results["serving"] = serving
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    from flute_tpu_torch.ops import _build, lut_gemm

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    results = {"torch": torch.__version__, "cuda": torch.version.cuda}

    log("== 1. card and build")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    log(smi)
    results["nvidia_smi"] = smi
    t0 = time.perf_counter()
    lut_gemm.build_kernel()
    build_s = time.perf_counter() - t0
    lib = _build.library_path("lut_gemm_w4sym.cu")
    log(f"  built {os.path.relpath(lib, HERE)} in {build_s:.1f} s")
    ptxas = lib.with_suffix(".log")
    if ptxas.exists():
        for line in ptxas.read_text().splitlines():
            if "registers" in line or "spill" in line:
                log("  ptxas: " + line.strip())
    results["build_s"] = build_s

    log("== 2. kernel against plain on the card")
    cases = phase_kernel(dev, results)
    log("== 3. model logits against the CPU plain path")
    phase_logits(dev, results)
    log("== 4. serving Llama-3.1-8B widths, 32 layers")
    launches = phase_serving(dev, results)

    stack = [c for c in cases if c["m"] == 8 and c["dtype"] == "bfloat16"]
    kernel = dict(
        name="lut_qgemm_w4sym",
        route="cuda",
        source="flute_tpu_torch/csrc/lut_gemm_w4sym.cu",
        replaces="flute_tpu/ops/lut_gemm.py:454 (_lut_qgemm_kernel[w4sym], pallas_call :828)",
        launches=launches,
        max_abs_err=max(c["max_abs_err"] for c in cases),
        # one decoder layer's four projections at decode (M=8, bf16)
        ms=sum(c["us"] for c in stack) / 1e3,
        plain_ms=sum(c["plain_us"] for c in stack) / 1e3,
        bound_ms=sum(c["bound_us"] for c in stack) / 1e3,
        bound_by="bytes" if all(c["bound_by"] == "bytes" for c in stack) else "operations",
        library_ms=sum(c["library_us"] for c in stack) / 1e3,
        checked=True,
    )
    results["kernels"] = [kernel]
    os.makedirs(os.path.join(HERE, "chiprun_out"), exist_ok=True)
    with open(os.path.join(HERE, "chiprun_out", "chip_smoke.json"), "w") as f:
        json.dump(results, f, indent=1)
    log(smi)
    print(json.dumps({"kernels": [kernel]}))
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
