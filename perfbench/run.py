#!/usr/bin/env python3
"""The benchmark of ``flute_tpu_torch`` (the PyTorch and CUDA port) on an
NVIDIA H100: one run of one cell.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout. The cell, its configuration, its traffic
mix and its metrics are found by name from ``BENCHMARK.json``
(``harness/manifest.py``). The last line of standard output is one JSON
object: ``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics, or with ``--trace 1`` its per-layer ones), ``device``,
with ``--trace 1`` ``breakdown``, ``build_s`` (the part of ``setup_s``
that built the kernels: a checkout's first run only), and last ``checks``:
each number the correctness check compared, beside its limit. The same
numbers are the last lines of standard error.

Two more modes, for setting the cell up (the sweep prints no result line):

    --sweep --workload <cell> --rates 2,3,4 --seconds <s>   the knee sweep
    --control 1          the float8 control in the program's place: ``correct``
                         judges the control's first choices by the same limits

Exits non-zero, printing no result, when there is no CUDA device or fewer
than the cell asks for, and when the process has loaded JAX or the JAX
package.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HOME = Path(__file__).resolve().parent
ROOT = HOME.parent
CACHE = HOME / ".cache"
# top-level module names that may not be loaded in the process
FORBIDDEN = ("jax", "jaxlib", "flax", "flute_tpu")


def set_environment() -> None:
    """Every compile cache at a fixed path inside the checkout; no library
    loads JAX on its own."""
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("TORCHINDUCTOR_CACHE_DIR", "inductor"),
                     ("CUDA_CACHE_PATH", "nv")):
        os.environ[var] = str(CACHE / sub)
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    for p in (str(HOME), str(ROOT)):
        if p not in sys.path:
            sys.path.insert(0, p)


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is one of :data:`FORBIDDEN`,
    compared whole."""
    return sorted({name.split(".")[0] for name in sys.modules} & set(FORBIDDEN))


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--seconds", type=float, default=None)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--control", type=int, choices=(0, 1), default=0)
    p.add_argument("--sweep", action="store_true")
    p.add_argument("--rates", default="")
    p.add_argument("--out", default=None, help="with --sweep: write its table here as JSON")
    return p.parse_args(argv)


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def main(argv=None) -> int:
    args = parse(argv)
    set_environment()
    import torch

    from harness.manifest import Manifest

    manifest = Manifest()
    chips = manifest.workload(args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        log(f"no result: the cell needs {chips} CUDA device(s); "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available")
        return 3
    seconds = args.seconds if args.seconds is not None else manifest.data["run_seconds"]
    if args.sweep:
        from harness.sweep import sweep

        rates = [float(r) for r in args.rates.split(",") if r]
        sweep(manifest, args.workload, args.seed, seconds, rates, device="cuda", log=log,
              out_path=args.out)
        return 0
    from harness.runner import run_cell

    result, checks = run_cell(manifest, args.workload, args.seed, seconds, bool(args.trace),
                              device="cuda", t_start=T_START, log=log,
                              control=bool(args.control))
    return report(result, checks)


def report(result: dict, checks: dict) -> int:
    """Refuse a process that loaded JAX; else print the checks (standard
    error) and the result line (standard output)."""
    found = forbidden_modules()
    if found:
        log(f"no result: the process loaded {', '.join(found)}")
        return 4
    result["checks"] = {name: {"value": v, "limit": lim} for name, (v, lim) in checks.items()}
    for name, (v, lim) in checks.items():
        log(f"check {name}: {v} (limit {lim})")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
