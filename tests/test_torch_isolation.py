"""The PyTorch port stands alone: it imports neither JAX nor the JAX package,
and its entry points never drift to the CPU when no GPU is there.

The module names are matched exactly or by a dotted prefix: the port's own
name, ``flute_tpu_torch``, starts with ``flute_tpu``.
"""

import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "optax", "flute_tpu")


def forbidden(module: str) -> bool:
    return any(module == f or module.startswith(f + ".") for f in FORBIDDEN)


def imported_modules(path: Path) -> list[str]:
    tree = ast.parse(path.read_text(), filename=str(path))
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.extend(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.append(node.module)
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", None) == "import_module"
              and node.args and isinstance(node.args[0], ast.Constant)):
            names.append(node.args[0].value)
    return names


def test_forbidden_matches_by_exact_name_or_dotted_prefix():
    assert forbidden("jax.numpy") and forbidden("flute_tpu") and forbidden("flute_tpu.nn")
    assert not forbidden("flute_tpu_torch") and not forbidden("flute_tpu_torch.nn")
    assert not forbidden("jaxtyping")


@pytest.mark.parametrize(
    "path",
    sorted(str(p.relative_to(ROOT)) for p in (ROOT / "flute_tpu_torch").rglob("*.py"))
    + ["chip_smoke.py"],
)
def test_no_jax_import(path):
    bad = [m for m in imported_modules(ROOT / path) if forbidden(m)]
    assert not bad, f"{path} imports {bad}"


def test_importing_the_port_loads_no_jax():
    """In a fresh interpreter, importing every module of the port adds no
    JAX module and nothing of the JAX package to ``sys.modules``."""
    mods = sorted(
        ".".join(p.relative_to(ROOT).with_suffix("").parts).removesuffix(".__init__")
        for p in (ROOT / "flute_tpu_torch").rglob("*.py")
    )
    code = (
        "import sys\n"
        "before = set(sys.modules)\n"
        f"for m in {mods!r}:\n"
        "    __import__(m)\n"
        "print('\\n'.join(sorted(set(sys.modules) - before)))\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
        env={**os.environ, "PYTHONPATH": str(ROOT)}, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    loaded = proc.stdout.split()
    assert "flute_tpu_torch.serving.engine" in loaded
    assert not [m for m in loaded if forbidden(m)]


@pytest.fixture
def no_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_raise_without_a_gpu(no_gpu):
    from flute_tpu_torch import interop, packing
    from flute_tpu_torch.lab import kernel_lab, kernel_lab2
    from flute_tpu_torch.models import llama
    from flute_tpu_torch.nn import from_codes, quantize_linear
    from flute_tpu_torch.serving import Engine

    config = llama.LlamaConfig.tiny()
    codes = np.zeros((256, 128), np.int32)
    calls = {
        "init_params": lambda: llama.init_params(config),
        "init_cache": lambda: llama.init_cache(config, 1, 16),
        "quantize_model": lambda: llama.quantize_model({"layers": []}),
        "quantize_linear": lambda: quantize_linear(np.ones((128, 256), np.float32)),
        "Engine": lambda: Engine(params={}, config=config),
        "pack": lambda: packing.pack(codes, 4),
        "from_codes": lambda: from_codes(codes, np.ones((4, 128), np.float32), None, 4, 64),
        "params_from_numpy": lambda: interop.params_from_numpy({"embed": codes}),
        "lab main": lambda: kernel_lab.main(["--n", "256", "--k", "512", "--bn", "128",
                                             "--bk", "256", "--variants", "floor"]),
        "lab make_inputs": lambda: kernel_lab.make_inputs(16, 256, 512, 4, 64),
        "lab2 main": lambda: kernel_lab2.main(["--n", "256", "--k", "512", "--bn", "128",
                                               "--bk", "256", "--variants", "pfdirect"]),
        "lab2 make_inputs": lambda: kernel_lab2.make_inputs(16, 256, 512),
    }
    for name, call in calls.items():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    # an explicit request for the CPU is honoured
    assert llama.init_cache(config, 1, 16, device="cpu")["k"][0].device.type == "cpu"


def test_qgemm_runs_where_its_tensors_are():
    """The GEMM takes its device from its tensors: the plain version only
    for CPU tensors, an error for any device it has no path for."""
    from flute_tpu_torch.ops import lut_gemm

    x = torch.ones((2, 256), device="meta")
    plane = torch.zeros((32, 128), dtype=torch.int32, device="meta")
    scales = torch.ones((4, 128), device="meta")
    table = torch.zeros(16, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        lut_gemm.qgemm(x, plane, scales, table, 4, 64, layout="w4sym")


@pytest.mark.parametrize("variant", ["floor", "unpack", "gather16", "g8_wrap", "g8_groupacc",
                                     "g8_hoist"])
def test_lab_runs_where_its_tensors_are(variant):
    """The lab's functions take their device from x: an error for a device
    they have no path for, never the plain version."""
    from flute_tpu_torch.lab import kernel_lab

    x = torch.ones((16, 256), dtype=torch.bfloat16, device="meta")
    plane = torch.zeros((32, 128), dtype=torch.int32, device="meta")
    scales = torch.ones((4, 128), dtype=torch.bfloat16, device="meta")
    table = torch.zeros(16, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        kernel_lab.run_variant(variant, x, [plane], scales, table, 16, 128, 256, 64)


@pytest.mark.parametrize("variant", ["pfdirect", "sep", "sep1", "int4", "slabstream", "w3wide",
                                     "vmembw"])
def test_lab2_runs_where_its_tensors_are(variant):
    """The second lab's functions take their device from their first
    tensor: an error for a device they have no path for, never the plain
    version."""
    from types import SimpleNamespace

    from flute_tpu_torch.lab import kernel_lab2, ops2

    if variant == "vmembw":
        with pytest.raises(ValueError, match="unsupported device"):
            ops2.vmembw(torch.zeros((8, 128), dtype=torch.int32, device="meta"), 2)
        return
    plane = torch.zeros((32, 128), dtype=torch.int32, device="meta")
    inp = SimpleNamespace(
        x=torch.ones((16, 256), dtype=torch.bfloat16, device="meta"),
        planes=[plane], planes_a=[plane[:16]], planes_b=[plane[:16]],
        planes3=[torch.zeros((24, 128), dtype=torch.int32, device="meta")],
        scales=torch.ones((4, 128), dtype=torch.bfloat16, device="meta"),
        table=torch.zeros(16, device="meta"), table3=torch.zeros(8, device="meta"),
        sep_a=torch.zeros(4, device="meta"), sep_b=torch.zeros(4, device="meta"))
    weights = kernel_lab2.operands(variant, inp)
    with pytest.raises(ValueError, match="unsupported device"):
        kernel_lab2.run_variant(variant, inp, weights, 16, 128, 256, 64)
