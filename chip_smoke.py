#!/usr/bin/env python3
"""End-to-end check of the PyTorch / CUDA port (flute_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero):
  1. print the card's name and power limit; build the three LUT-GEMM
     kernels from flute_tpu_torch/csrc into build/flute_tpu_torch/, one nvcc
     process each, all at once: K1 (w4sym), K2 (plane, 2/3/4 bits), K3
     (w3wide);
  2. hold each kernel against its plain PyTorch version on the card at the
     Llama-3.1-8B decoder-layer shapes, M in {1, 8, 128, 512}, bf16 and f16
     (relative Frobenius error under 1.1e-2 / 2e-3): K1, K2 at 4, 3 and 2
     bits with a general table, K3; identity input bit-exact against
     dequantize_codes in bf16/f16/f32 (K1 and K2 at chunk 128 and 256, K3 at
     256 and 512) and unpack_via_kernel round-tripping the codes; time each
     kernel, its plain version and a bf16/f16 torch.matmul on the
     pre-dequantized weight (a yardstick only), L2-cold, in CUDA graphs;
  3. logits of a 2-layer model at Llama-3.1-8B widths (fused) quantized at
     w4sym, W3 (w3wide) and general-table W4 (plane): one prefill and one
     decode step on the card against the same params on the CPU plain path
     (max error relative to the largest logit < 1.1e-2); the W3 model saved
     with save_quantized and loaded back gives the same logits bit for bit;
  4. serve 8 ragged prompts for 16 new tokens through Engine.generate on
     the full 32-layer Llama-3.1-8B-width model (random weights from a seed,
     quantized on the card) at w4sym, W3 and general W4, each run through
     exactly its kernel: steps x 32 layers x 4 launches, none of the others.

Prints a {"kernels": [...]} line, then as its last line
{"ok": true, "device": {...}}. Writes the full results to
chiprun_out/chip_smoke.json. Needs a CUDA device; exits non-zero without one.
"""

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
# kernel id -> (wrapper name, source, layout, what it replaces)
KERNELS = {
    "K1": ("lut_qgemm_w4sym", "lut_gemm_w4sym.cu", "w4sym", REPLACES.format("w4sym")),
    "K2": ("lut_qgemm_plane", "lut_gemm_plane.cu", "plane",
           REPLACES.format("plane, gather8/select")),
    "K3": ("lut_qgemm_w3wide", "lut_gemm_w3wide.cu", "w3wide", REPLACES.format("w3wide")),
}
# phase-2 cases: (kernel id, bits, M values that are timed; every M is checked)
KERNEL_CASES = [
    ("K1", 4, M_CASES),
    ("K2", 4, M_CASES),
    ("K2", 3, (1, 8, 512)),
    ("K2", 2, (1, 8, 512)),
    ("K3", 3, M_CASES),
]
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
    for kid, bits, timed in KERNEL_CASES:
        layout = KERNELS[kid][2]
        log(f"  {kid} ({layout}, {bits}-bit)")
        for name, n, k in LAYER_SHAPES:
            for dtype in (torch.bfloat16, torch.float16):
                codes, planes, scales, table = make_weight(rng, gen, layout, bits, n, k,
                                                           dtype, dev)
                deq = lut_gemm.dequantize_codes(codes, scales, table, dtype)
                del codes
                wbytes = sum(p.numel() * 4 for p in planes) + scales.numel() * scales.element_size()
                copies = cold_copies(wbytes)
                args = [([p.clone() for p in planes], scales.clone()) for _ in range(copies)]
                deq_c = [deq.clone() for _ in range(cold_copies(deq.numel() * deq.element_size()))]
                kw = dict(num_bits=bits, layout=layout, config=KernelConfig(chunk=256))
                for m in M_CASES:
                    x = torch.randn((m, k), generator=gen, device=dev).to(dtype)
                    y = lut_gemm.lut_qgemm(x, planes, scales, table, **kw)
                    y_plain = lut_gemm.lut_qgemm_plain(x, planes, scales, table, num_bits=bits,
                                                       chunk=256, layout=layout)
                    torch.cuda.synchronize()
                    err = rel_err(y, y_plain)
                    max_abs = float((y.float() - y_plain.float()).abs().max())
                    if not err < THRESHOLDS[dtype]:
                        raise AssertionError(f"{kid} {bits}-bit {name} M={m} {dtype}: rel err {err}")
                    case = dict(kernel=kid, bits=bits, name=name, n=n, k=k, m=m,
                                dtype=str(dtype).split(".")[-1], rel_err=err,
                                max_abs_err=max_abs)
                    cases.append(case)
                    if m not in timed:
                        continue

                    def kern(p, s, x=x, table=table):
                        return lut_gemm.lut_qgemm(x, p, s, table, **kw)

                    def plain(p, s, x=x, table=table):
                        return lut_gemm.lut_qgemm_plain(x, p, s, table, num_bits=bits,
                                                        chunk=256, layout=layout)

                    def library(w, x=x):
                        return torch.matmul(x, w)

                    t_k = bench_op(kern, args)
                    t_p = bench_op(plain, args[:2], min_launches=2)
                    t_l = bench_op(library, [(w,) for w in deq_c])
                    esz = torch.tensor([], dtype=dtype).element_size()
                    nbytes = wbytes + table.numel() * 4 + m * k * esz + m * n * esz
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

    # identity input: bit-exact against the oracle at two pack chunks per
    # layout; unpack_via_kernel returns the codes
    n, k = 256, 512
    identity = [("K1", 4, (128, 256)), ("K2", 4, (128, 256)), ("K2", 3, (128, 256)),
                ("K2", 2, (128, 256)), ("K3", 3, (256, 512))]
    for kid, bits, chunks in identity:
        layout = KERNELS[kid][2]
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
    log("  identity bit-exact (bf16/f16/f32; K1 and K2 at chunk 128/256, K1 with a "
        "mixed-sign table, K3 at 256/512); unpack_via_kernel round-trips")
    results["identity_bit_exact"] = True
    return cases


def model_logits(params, config, dev, tokens, offsets, nxt):
    from flute_tpu_torch.models import llama

    b, t = tokens.shape
    with torch.inference_mode():
        cache = llama.init_cache(config, b, 32, device=dev)
        pre, cache = llama.forward(params, config, tokens.to(dev), cache, 0, offsets.to(dev))
        dec, _ = llama.forward(params, config, nxt.to(dev), cache, t, offsets.to(dev))
    return pre.cpu(), dec.cpu()


def phase_logits(dev, results):
    from flute_tpu_torch.integrations import checkpoint
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
    for name, (kw, _) in SERVED.items():
        qparams = llama.quantize_model(params, group_size=GROUP, fuse=True, device=dev, **kw)
        out = model_logits(qparams, config, dev, tokens, offsets, nxt)
        ref = model_logits(move_params(qparams, cpu), config, cpu, tokens, offsets, nxt)
        errs = {}
        for step, a, want in zip(("prefill", "decode"), out, ref):
            if not torch.isfinite(a).all():
                raise AssertionError(f"{name}: non-finite {step} logits")
            errs[step] = float((a - want).abs().max() / want.abs().max())
            if not errs[step] < THRESHOLDS[torch.bfloat16]:
                raise AssertionError(
                    f"{name} {step} logits differ from the CPU plain path: {errs[step]}")
        log(f"  2-layer 8B-width {name} logits vs CPU plain path: prefill "
            f"{errs['prefill']:.2e}, decode {errs['decode']:.2e}")
        results["logits_rel_err"][name] = errs
        if name == "w3wide":
            # a save/load round trip through the checkpoint format changes nothing
            os.makedirs(os.path.join(HERE, "build"), exist_ok=True)
            tmp = tempfile.mkdtemp(prefix="chip_smoke_ckpt_", dir=os.path.join(HERE, "build"))
            try:
                t0 = time.perf_counter()
                checkpoint.save_quantized(tmp, qparams, num_bits=3, group_size=GROUP)
                size = sum(os.path.getsize(os.path.join(tmp, f)) for f in os.listdir(tmp))
                t1 = time.perf_counter()
                loaded, _ = checkpoint.load_quantized(tmp, device=dev)
                t2 = time.perf_counter()
            finally:
                shutil.rmtree(tmp)
            again = model_logits(loaded, config, dev, tokens, offsets, nxt)
            if not all(torch.equal(a, c) for a, c in zip(out, again)):
                raise AssertionError("W3 logits changed across save_quantized/load_quantized")
            log(f"  W3 checkpoint ({size / 1e9:.2f} GB): saved in {t1 - t0:.1f} s, loaded in "
                f"{t2 - t1:.1f} s; logits bit-exact after the round trip")
            results["checkpoint_round_trip"] = dict(bytes=size, save_s=t1 - t0, load_s=t2 - t1,
                                                    bit_exact=True)
            del loaded
        del qparams
    del params
    torch.cuda.empty_cache()


def serve(dev, name, quant_kw, kernel_layout):
    """Quantize the 32-layer model on the card and serve the prompts once;
    returns the run's numbers and the engine, which keeps the model."""
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
    return serving, eng


def profile_decode(dev, name, eng):
    """Where a decode step's device time goes: three steps under
    torch.profiler, outside the counted runs (the profiler runs only after
    every timed run, so it cannot slow one down)."""
    config = eng.config
    rng = np.random.default_rng(3)
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


def kernel_line(kid, cases, launches):
    """The {"kernels": [...]} entry of one kernel: its decode stack, one
    layer's four projections at M=8 in bf16 (K2 at general W4)."""
    wrapper, source, layout, replaces = KERNELS[kid]
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
    t_start = time.perf_counter()

    log("== 1. card and build")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    log(smi)
    results["nvidia_smi"] = smi
    t0 = time.perf_counter()
    lut_gemm.build_kernels()
    build_s = time.perf_counter() - t0
    log(f"  built the three kernel libraries in {build_s:.1f} s (in parallel)")
    for _, source, _, _ in KERNELS.values():
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
    log("== 3. model logits against the CPU plain path; checkpoint round trip")
    phase_logits(dev, results)
    log("== 4. serving Llama-3.1-8B widths, 32 layers")
    results["serving"] = {}
    launches = {}
    engines = {}
    for name, (kw, kid) in SERVED.items():
        layout = KERNELS[kid][2]
        results["serving"][name], engines[name] = serve(dev, name, kw, layout)
        launches[kid] = results["serving"][name]["launches"][layout]
    for name, eng in engines.items():
        results["serving"][name]["profile"] = profile_decode(dev, name, eng)
    del engines
    torch.cuda.empty_cache()

    kernels = [kernel_line(kid, cases, launches[kid]) for kid in KERNELS]
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
