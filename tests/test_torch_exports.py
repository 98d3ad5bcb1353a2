"""The port's packages export the JAX package's public names: each
``__all__`` name of ``flute_tpu``, ``.ops``, ``.serving``, ``.utils``,
``.models``, ``.quantize``, ``.integrations`` and ``.parallel`` is in the port's
counterpart's ``__all__`` and resolves there, but for the gaps listed
below by their ROADMAP item (queue 1), the modules the port does not have
yet (none now)."""

import importlib

import pytest

# JAX names the port does not export yet -> the ROADMAP queue 1 item that
# brings them
GAPS: dict = {}
PACKAGES = ["", ".ops", ".serving", ".utils", ".models", ".quantize", ".integrations",
            ".parallel"]


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
