"""The port's packages export the JAX package's public names: each
``__all__`` name of ``flute_tpu``, ``.ops``, ``.serving``, ``.utils``,
``.models``, ``.quantize``, ``.integrations`` and ``.parallel`` is in the port's
counterpart's ``__all__`` and resolves there, but for the gaps listed
below by their ROADMAP item (queue 1), the modules the port does not have
yet (none now)."""

import importlib
import inspect
from pathlib import Path

import pytest

# JAX names the port does not export yet -> the ROADMAP queue 1 item that
# brings them
GAPS: dict = {}
PACKAGES = ["", ".ops", ".serving", ".utils", ".models", ".quantize", ".integrations",
            ".parallel"]
# every module of the JAX package, by its file (nothing imported to list them)
JAX_ROOT = Path(__file__).resolve().parent.parent / "flute_tpu"
MODULES = sorted(".".join(("flute_tpu", *p.relative_to(JAX_ROOT).with_suffix("").parts))
                 .removesuffix(".__init__") for p in JAX_ROOT.rglob("*.py"))
# public top-level functions and classes of JAX modules that are JAX- or
# TPU-only, which the port leaves out on purpose: the TPU device profile,
# shard_map's import shim, the packers that run as jnp on the TPU (the port
# packs with its torch and numpy packers)
JAX_ONLY = {
    "flute_tpu.ops.kernel_config": {"DeviceProfile", "device_profile"},
    "flute_tpu.parallel.tp": {"get_shard_map"},
    "flute_tpu.packing": {"pack_jnp", "pack_w3_wide_jnp", "pack_w4_sym_jnp"},
}


@pytest.mark.parametrize("sub", PACKAGES, ids=lambda s: s or "top")
def test_port_exports_the_jax_names(sub):
    jax_mod = importlib.import_module("flute_tpu" + sub)
    port = importlib.import_module("flute_tpu_torch" + sub)
    missing = sorted(n for n in jax_mod.__all__ if not hasattr(port, n) or n not in port.__all__)
    assert [n for n in missing if n not in GAPS] == []
    assert all(hasattr(port, n) for n in port.__all__)


def test_gaps_are_still_gaps():
    """Each listed gap is a JAX name the port lacks: once an item lands,
    its names leave GAPS."""
    names = {}
    for sub in PACKAGES:
        jax_mod = importlib.import_module("flute_tpu" + sub)
        port = importlib.import_module("flute_tpu_torch" + sub)
        names.update({n: hasattr(port, n) for n in jax_mod.__all__ if n in GAPS})
    assert names == {n: False for n in GAPS}


def test_top_level_names_resolve():
    import flute_tpu_torch
    from flute_tpu_torch import ops, packing
    from flute_tpu_torch.ops import hadamard, lut_gemm

    assert flute_tpu_torch.lut_qgemm is lut_gemm.lut_qgemm
    assert flute_tpu_torch.unpack is packing.unpack
    assert flute_tpu_torch.PackFormat(4).num_bits == 4
    assert flute_tpu_torch.__version__ == importlib.import_module("flute_tpu").__version__
    assert ops.qgemm_hadamard is hadamard.qgemm_hadamard
    assert ops.grouped_hadamard_transform is hadamard.grouped_hadamard_transform


def test_modules_are_listed():
    assert len(MODULES) >= 40 and "flute_tpu.bitutils" in MODULES
    assert set(JAX_ONLY) <= set(MODULES)


@pytest.mark.parametrize("name", MODULES)
def test_port_module_has_each_jax_function_and_class(name):
    """Each public top-level function and class that a JAX module defines
    (``__all__`` or not) is in the port's counterpart module, but for the
    JAX- or TPU-only names of :data:`JAX_ONLY`, each of which the port
    indeed lacks."""
    jax_mod = importlib.import_module(name)
    port = importlib.import_module("flute_tpu_torch" + name.removeprefix("flute_tpu"))
    public = {n for n, v in vars(jax_mod).items()
              if not n.startswith("_") and (inspect.isfunction(v) or inspect.isclass(v))
              and v.__module__ == name}
    excluded = JAX_ONLY.get(name, set())
    assert excluded <= public
    assert sorted(n for n in public - excluded if not hasattr(port, n)) == []
    assert not any(hasattr(port, n) for n in excluded)
