"""Build and load the package's CUDA kernels.

Each ``csrc/*.cu`` file has a plain C interface (shared device code is in
``csrc/*.cuh`` headers). It is compiled with ``nvcc`` into a shared library
at first use, under ``build/flute_tpu_torch/`` at the repository root, keyed
by a hash of the source, the headers and the command, and loaded with
``ctypes``. A missing ``nvcc`` or a failed build raises: nothing falls back.
Nothing is built or loaded inside a CUDA graph capture.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Sequence

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent.parent / "build" / "flute_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    # registers, shared memory and spills per kernel, kept in the build log
    "-Xptxas=-v",
)


def find_nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None:
        cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
        if cand.exists():
            nvcc = str(cand)
    if nvcc is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")
    return nvcc


def library_path(source: str) -> Path:
    """Where the library of ``csrc/<source>`` is built: keyed by the source,
    the shared headers it may include and the command."""
    src = CSRC / source
    h = hashlib.sha256(src.read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{src.stem}-{h.hexdigest()[:16]}.so"


def build_all(sources: Sequence[str]) -> list[Path]:
    """Compile every ``csrc/<source>`` whose library is not built yet, one
    ``nvcc`` process per source, all started together; return the libraries'
    paths. Each nvcc's output goes to ``<library>.log``. Waits for every
    process, then raises with the output of those that failed."""
    outs = [library_path(s) for s in sources]
    todo = [(s, out) for s, out in zip(sources, outs) if not out.exists()]
    if todo:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        nvcc = find_nvcc()
    running = []
    for source, out in todo:
        tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / source)]
        proc = subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        )
        running.append((source, out, tmp, cmd, proc))
    failed = []
    for source, out, tmp, cmd, proc in running:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({proc.returncode}) for {source}:\n{' '.join(cmd)}\n{log}")
            continue
        out.with_suffix(".log").write_text(log)
        os.replace(tmp, out)  # atomic: a concurrent build never loads a partial file
    if failed:
        raise RuntimeError("\n".join(failed))
    return outs


def build(source: str) -> Path:
    """Compile ``csrc/<source>`` unless its library is already built; return
    the library's path. Raises with nvcc's output on failure."""
    return build_all([source])[0]


def load(source: str) -> ctypes.CDLL:
    """The library of ``csrc/<source>``, built if it is not yet. Raises
    inside a CUDA graph capture: a kernel is built and loaded by an eager
    call before any capture of it."""
    import torch

    if torch.cuda.is_available() and torch.cuda.is_current_stream_capturing():
        raise RuntimeError(f"csrc/{source} is not loaded yet and cannot be built inside a "
                           "CUDA graph capture: call the op once before capturing it")
    return ctypes.CDLL(str(build(source)))
