"""Per-shape tuning of the Hopper LUT-GEMM launch, counterpart of
``flute_tpu/tune.py``.

For a GEMM shape the tuner times every candidate launch
(:func:`flute_tpu_torch.ops.kernel_config.get_candidate_configs`: the
tensor-core loop's m16 tiles per warp, or the SIMT kernel's rows per
block) on the card, keeps the fastest that passes verification, and
memoizes it by shape, dtype, layout and card (``torch.cuda.get_device_name``).
Timing is :func:`flute_tpu_torch.utils.benchmark.bench_cycled`: CUDA events
around a CUDA graph of many launches, the weights cycled through copies past
the L2 cache. Verification keeps the JAX package's two oracles (an identity
x reproduces the dequantized weight bit for bit; a random x is within
``2 * RTOL`` of the plain product) and adds a third: the tuned launch gives
the bits of the planner's launch, so tuning never changes a served token.

No candidate changes the packed layout or the split of K, so a tuned
config is only a launch choice: ``tune_linear`` keeps the layer's
persisted key and carries the choice on the module. The registry
(:func:`save_registry` / :func:`load_registry`) is JSON; no tuned registry
ships with the port (the JAX package's is TPU-calibrated).
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Optional, Sequence

import numpy as np
import torch

from flute_tpu_torch import packing
from flute_tpu_torch.device import resolve_device
from flute_tpu_torch.ops import lut_gemm
from flute_tpu_torch.ops.kernel_config import (
    DEFAULT_CHUNK,
    KernelConfig,
    dtype_name,
    get_candidate_configs,
    get_kernel_config,
    kernel_layout,
)

# The dtypes' thresholds (relative to the largest output).
RTOL = {"float16": 2.0e-3, "bfloat16": 1.1e-2, "float32": 1.0e-5}
_TORCH_DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16, "float32": torch.float32}

_VERSION = "v1"


@dataclasses.dataclass(frozen=True)
class TuneMetaData:
    """Persisted tuning identity: enough to know whether a stored config
    still applies to the deployment, and the launch it chose."""

    version: str
    m: int
    n: int
    k: int
    num_bits: int
    group_size: int
    dtype: str
    device_kind: str
    config_key: str
    layout: str = "auto"
    # the tuned Hopper launch (0: the planner's)
    m_tiles: int = 0
    simt_block_m: int = 0

    def to_json(self) -> dict:
        return dataclasses.asdict(self)

    @staticmethod
    def from_json(d: dict) -> "TuneMetaData":
        return TuneMetaData(**d)


def _bits_key(num_bits: int, layout: str = "auto"):
    """Registry encoding of (num_bits, kernel layout): the bit width for
    the quantizers' layouts (pair planes at 2 and 4 bits, wide at 3), a
    marker for the others ("4s" w4sym, "3c" 2+1-plane 3-bit, "<b>p" the
    joint pair lookup)."""
    layout = kernel_layout(num_bits, layout)
    if layout == "w4sym":
        if num_bits != 4:
            raise ValueError("layout='w4sym' requires num_bits=4")
        return "4s"
    if layout == "pair":
        return f"{num_bits}p"
    if layout == "plane" and num_bits == 3:
        return "3c"
    return num_bits


def _memo_key(m, n, k, num_bits, group_size, dtype, device_kind, layout="auto"):
    # decode shapes below one m16 tile share a key
    return (
        _VERSION, max(m, 16), n, k, _bits_key(num_bits, layout), group_size,
        dtype_name(dtype), device_kind,
    )


_MEMO: dict[tuple, KernelConfig] = {}


def _device_kind(device=None) -> str:
    """The card's name (``torch.cuda.get_device_name``), or ``"cpu"``."""
    if device is None:
        dev = torch.device("cuda" if torch.cuda.is_available() else "cpu")
    else:
        dev = torch.device(device)
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"


def _round(a, dtype) -> np.ndarray:
    """``a`` rounded to the torch dtype ``dtype``, back in float32."""
    t = torch.from_numpy(np.ascontiguousarray(a, np.float32))
    return t.to(_TORCH_DTYPES[dtype_name(dtype)]).float().numpy()


def _host_oracle(
    x: np.ndarray, codes: np.ndarray, scales: np.ndarray, table: np.ndarray, dtype,
) -> np.ndarray:
    """Host-side f32 ground truth with the operands rounded to ``dtype``
    first (table, scales, each dequantized weight and x), as the kernels
    round them."""
    t = _round(table, dtype)
    g = codes.shape[0] // scales.shape[0]
    s = np.repeat(_round(scales, dtype), g, axis=0)
    deq = _round(t[codes] * s, dtype)
    return _round(x, dtype) @ deq


def pick_verified(timed: Sequence[tuple[float, KernelConfig]], verify_fn):
    """Walk the candidates fastest-first and return the first that passes
    ``verify_fn`` with its time; ``(None, inf)`` if none does. A candidate
    whose verification raises is skipped (with one line saying why)."""
    for t, cfg in sorted(timed, key=lambda p: p[0]):
        try:
            if verify_fn(cfg):
                return cfg, t
        except Exception as e:
            print(f"    verify {launch_name(cfg)} raised: "
                  f"{(str(e).splitlines() or [type(e).__name__])[0][:120]}", flush=True)
    return None, float("inf")


def launch_name(cfg: KernelConfig) -> str:
    """The launch a config names, e.g. ``m_tiles=2`` or ``planner``."""
    if cfg.m_tiles:
        return f"m_tiles={cfg.m_tiles}"
    if cfg.simt_block_m:
        return f"simt_block_m={cfg.simt_block_m}"
    return "planner"


def _random_weight(gen, num_bits, layout, n, k, group_size, dtype, dev, chunk):
    """Random codes, packed for ``layout``, with scales, a table (a joint
    pair table for ``"pair"``) and the call's ``layout`` argument."""
    codes = torch.randint(0, 2**num_bits, (k, n), generator=gen, device=dev, dtype=torch.int32)
    e = 2**num_bits
    pair_values = None
    if layout == "w4sym":
        mags = torch.sort(torch.randn(e // 2, generator=gen, device=dev).abs()).values
        table = torch.cat([mags, -mags])
        planes = [packing.pack_w4_sym(codes, chunk=chunk)]
    elif layout == "w3wide":
        table = torch.sort(torch.randn(e, generator=gen, device=dev)).values
        planes = [packing.pack_w3_wide(codes, chunk=chunk)]
    else:
        table = torch.sort(torch.randn(e, generator=gen, device=dev)).values
        planes = packing.pack_plane(codes, num_bits, chunk=chunk)
        if layout == "pair":
            pair_values = torch.randn((e, e, 2), generator=gen, device=dev)
    scales = (torch.rand((k // group_size, n), generator=gen, device=dev) + 0.5).to(dtype)
    call_layout = "w4sym" if layout == "w4sym" else "auto"
    return codes, planes, scales, table.float(), pair_values, call_layout


def _reference(x, codes, scales, table, pair_values):
    if pair_values is None:
        return lut_gemm.lut_qgemm_reference(x, codes, scales, table)
    deq = lut_gemm.dequantize_codes_pair(codes, scales, pair_values, x.dtype)
    return torch.matmul(x.float(), deq.float()).to(x.dtype)


def _rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    denom = max(float(want.float().abs().max()), 1e-6)
    return float((got.float() - want.float()).abs().max()) / denom


def tune_config(
    m: int,
    n: int,
    k: int,
    num_bits: int,
    group_size: int,
    dtype=torch.bfloat16,
    *,
    max_candidates: int = 24,
    iters: int = 30,
    use_memo: bool = True,
    verify: bool = True,
    verbose: bool = False,
    layout: str = "auto",
    chunk: int = DEFAULT_CHUNK,
    device=None,
    report: Optional[list] = None,
) -> KernelConfig:
    """Time the candidate launches for (M, N, K, b, g, dtype, layout) on the
    card, verify them, and return the fastest verified one.

    On a CPU ``device`` (``cuda`` unless named) it returns the static
    default, as there is nothing to time. ``iters`` is the least number of
    launches in each timed CUDA graph. ``report``, where given, gets one
    dict per candidate: its launch, microseconds per call, whether it
    passed, and whether it is the planner's; a candidate that failed to
    launch has ``us`` None and its ``error``."""
    dev = resolve_device(device)
    kind = _device_kind(dev)
    key = _memo_key(m, n, k, num_bits, group_size, dtype, kind, layout)
    if use_memo and key in _MEMO:
        return _MEMO[key]
    if dev.type != "cuda":
        cfg = get_kernel_config(m, n, k, num_bits, group_size, dtype=dtype, layout=layout)
        _MEMO[key] = cfg
        return cfg

    from flute_tpu_torch.utils.benchmark import bench_cycled, cold_copies

    klayout = kernel_layout(num_bits, layout)
    tdtype = _TORCH_DTYPES[dtype_name(dtype)]
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    sets = []
    weight = _random_weight(gen, num_bits, klayout, n, k, group_size, tdtype, dev, chunk)
    codes, planes, scales, table, pair_values, call_layout = weight
    set_bytes = sum(p.numel() * 4 for p in planes) + scales.numel() * scales.element_size()
    for _ in range(cold_copies(set_bytes, dev)):
        sets.append(([p.clone() for p in planes], scales.clone()))
    x = torch.randn((m, k), generator=gen, device=dev).to(tdtype)

    def call(cfg, planes_=planes, scales_=scales):
        return lut_gemm.lut_qgemm(x, planes_, scales_, table, num_bits=num_bits, config=cfg,
                                  pair_values=pair_values, layout=call_layout)

    candidates = list(get_candidate_configs(m, n, k, num_bits, group_size, dtype, klayout,
                                            chunk))[:max_candidates]
    planner = KernelConfig(chunk=chunk)
    timed = []
    rows = {}
    for ci, cfg in enumerate(candidates):
        if verbose:
            print(f"    cand {ci + 1}/{len(candidates)} {launch_name(cfg)} ...", flush=True)
        rows[cfg] = {"launch": launch_name(cfg), "m_tiles": cfg.m_tiles,
                     "simt_block_m": cfg.simt_block_m, "planner": ci == 0}
        try:
            t = bench_cycled(lambda p, s, c=cfg: call(c, p, s), sets, min_launches=iters)
        except Exception as e:
            error = (str(e).splitlines() or [type(e).__name__])[0][:120]
            rows[cfg].update(us=None, error=error, passed=False)
            if verbose:
                print(f"      failed: {error}", flush=True)
            continue
        timed.append((t, cfg))
        rows[cfg]["us"] = t * 1e6
        if verbose:
            print(f"      {t * 1e6:9.1f} us", flush=True)
    del sets
    if not timed:
        if report is not None:
            report.extend(dict(row, chosen=False) for row in rows.values())
        _MEMO[key] = planner
        return planner

    if verify:
        thr = 2.0 * RTOL[dtype_name(dtype)]
        want = _reference(x, codes, scales, table, pair_values)
        base = call(planner)
        checked = {}
        for _, cfg in timed:
            got = call(cfg)
            err = _rel_err(got, want)
            same = torch.equal(got, base)
            checked[cfg] = err <= thr and same
            rows[cfg].update(rel_err=err, same_bits_as_planner=same, passed=checked[cfg])
            if verbose:
                print(f"    verify {launch_name(cfg)}: rel {err:.2e}, "
                      f"{'same bits' if same else 'OTHER BITS'}: "
                      f"{'pass' if checked[cfg] else 'FAIL'}", flush=True)
        best, _ = pick_verified(timed, checked.__getitem__)
        if best is None:
            raise AssertionError(
                f"no candidate launch passed verification for "
                f"M={m} N={n} K={k} b={num_bits} g={group_size}"
            )
    else:
        best = min(timed, key=lambda p: p[0])[1]
    if report is not None:
        report.extend(dict(row, chosen=cfg == best) for cfg, row in rows.items())
    _MEMO[key] = best
    return best


def verify_config(
    config: KernelConfig,
    n: int = 1024,
    k: int = 1024,
    num_bits: int = 4,
    group_size: int = 64,
    dtype=torch.bfloat16,
    seeds: Sequence[int] = (0, 1),
    device=None,
) -> None:
    """Post-tune correctness check of ``config`` on the pair-plane layout:
    an identity x must reconstruct the dequantized weight bit for bit, a
    random x must match the plain product within the dtype's threshold,
    and the result must have the bits of the planner's launch. Raises on
    failure."""
    dev = resolve_device(device)
    tdtype = _TORCH_DTYPES[dtype_name(dtype)]
    planner = dataclasses.replace(config, m_tiles=0, simt_block_m=0)
    for seed in seeds:
        rng = np.random.default_rng(seed)
        codes_np = rng.integers(0, 2**num_bits, size=(k, n), dtype=np.int32)
        codes = torch.from_numpy(codes_np).to(dev)
        planes = packing.pack_plane(codes, num_bits, chunk=config.chunk)
        scales = torch.from_numpy(rng.uniform(0.5, 1.5, (k // group_size, n))).to(dev, tdtype)
        table = torch.from_numpy(np.sort(rng.standard_normal(2**num_bits))).to(dev, torch.float32)

        def run(x, cfg):
            return lut_gemm.lut_qgemm(x, planes, scales, table, num_bits=num_bits, config=cfg)

        eye = torch.eye(k, dtype=tdtype, device=dev)
        got = run(eye, config)
        want = lut_gemm.dequantize_codes(codes, scales, table, tdtype)
        if not torch.equal(got.float(), want.float()):
            raise AssertionError(f"identity oracle failed for {launch_name(config)}")

        x = torch.from_numpy(rng.standard_normal((33, k))).to(dev, tdtype)
        got = run(x, config)
        want = lut_gemm.lut_qgemm_reference(x, codes, scales, table)
        err = _rel_err(got, want)
        thr = RTOL[dtype_name(dtype)]
        if err > thr:
            raise AssertionError(
                f"random oracle failed for {launch_name(config)}: rel={err:.2e} > {thr}"
            )
        if not torch.equal(got, run(x, planner)):
            raise AssertionError(f"{launch_name(config)} changes the bits of the planner's launch")


def tune_linear(layer, m: int, dtype=None, **kw):
    """``layer`` with its launch tuned for batch size ``m`` (compute dtype
    ``dtype``, default the layer's scales'). The layer's key (chunk,
    lut_mode) is kept and nothing is repacked: only the launch changes."""
    dtype = dtype or layer.scales.dtype
    kw.setdefault("layout", layer.kernel_layout)
    kw.setdefault("device", layer.scales.device)
    base = layer.config or KernelConfig()
    kw.setdefault("chunk", base.chunk)
    cfg = tune_config(m, layer.out_features, layer.in_features, layer.num_bits,
                      layer.group_size, dtype, **kw)
    return layer.with_config(
        dataclasses.replace(base, m_tiles=cfg.m_tiles, simt_block_m=cfg.simt_block_m))


def metadata_for(layer, m: int, dtype=None) -> TuneMetaData:
    cfg = layer.config or KernelConfig()
    return TuneMetaData(
        version=_VERSION,
        m=m,
        n=layer.out_features,
        k=layer.in_features,
        num_bits=layer.num_bits,
        group_size=layer.group_size,
        dtype=dtype_name(dtype or layer.scales.dtype),
        device_kind=_device_kind(layer.scales.device),
        config_key=layer.config_key or "",
        layout=layer.layout,
        m_tiles=cfg.m_tiles,
        simt_block_m=cfg.simt_block_m,
    )


def maybe_retune(layer, meta: TuneMetaData, m: int, dtype=None):
    """Restore the persisted tuning where it still matches the deployment
    (batch size bucket, card, dtype, layout), else retune."""
    same = (
        meta.version == _VERSION
        and max(meta.m, 16) == max(m, 16)
        and meta.device_kind == _device_kind(layer.scales.device)
        and meta.dtype == dtype_name(dtype or layer.scales.dtype)
        and meta.layout == layer.layout
    )
    if same and meta.config_key:
        cfg = dataclasses.replace(KernelConfig.from_key(meta.config_key), m_tiles=meta.m_tiles,
                                  simt_block_m=meta.simt_block_m)
        return layer.with_config(cfg)
    return tune_linear(layer, m, dtype)


# ---------------------------------------------------------------------------
# Registry persistence (JSON)
# ---------------------------------------------------------------------------


def lookup_packaged(
    m: int, n: int, k: int, num_bits: int, group_size: int,
    dtype=torch.bfloat16, layout: str = "auto",
) -> Optional[KernelConfig]:
    """The config tuned (or loaded into the registry) in this process for
    the shape on this card, without timing anything; None if there is none.
    Keys hold the card's name, so an entry never leaks onto another card."""
    try:
        kind = _device_kind()
        key = _memo_key(m, n, k, num_bits, group_size, dtype, kind, layout)
    except Exception:
        return None
    return _MEMO.get(key)


def save_registry(path: str) -> None:
    data = {
        "|".join(map(str, k)): {"config_key": v.key(), "m_tiles": v.m_tiles,
                                "simt_block_m": v.simt_block_m}
        for k, v in _MEMO.items()
    }
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        json.dump(data, f, indent=1, sort_keys=True)


def load_registry(path: str) -> int:
    """Load a registry file into the memo; returns the entries loaded. A
    value is a config key (a registry of the JAX package's form, no tuned
    launch) or ``{"config_key", "m_tiles", "simt_block_m"}``."""
    if not os.path.exists(path):
        return 0
    with open(path) as f:
        data = json.load(f)
    for k, v in data.items():
        parts = k.split("|")
        bits = int(parts[4]) if parts[4].isdigit() else parts[4]
        key = (parts[0], int(parts[1]), int(parts[2]), int(parts[3]), bits, int(parts[5]),
               parts[6], parts[7])
        if isinstance(v, str):
            v = {"config_key": v}
        _MEMO[key] = dataclasses.replace(
            KernelConfig.from_key(v["config_key"]), m_tiles=int(v.get("m_tiles", 0)),
            simt_block_m=int(v.get("simt_block_m", 0)))
    return len(data)
