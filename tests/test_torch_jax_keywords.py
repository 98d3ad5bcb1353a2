"""The port's quantizers take the JAX package's keywords (queue 3 item 44).

``example_batch_size`` (all five functions) and ``config`` (``quantize_linear``)
are keywords of the JAX signatures. Each port call with them, on the CPU,
gives the layer (planes, scales, table, ``config_key``) of the same call
without them; the JAX call with the same keywords runs on the same numpy
weights and packs the same planes.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flute_tpu import nn as jnn
from flute_tpu.models import gemma2 as jgemma2
from flute_tpu.models import llama as jllama
from flute_tpu.ops.kernel_config import KernelConfig as JKernelConfig
from flute_tpu_torch import nn
from flute_tpu_torch.models import gemma2, llama
from flute_tpu_torch.ops.kernel_config import KernelConfig

G = 64
HIDDEN, INTER, VOCAB = 256, 512, 300
PROJ_SHAPES = {"q": (HIDDEN, HIDDEN), "k": (HIDDEN, HIDDEN), "v": (HIDDEN, HIDDEN),
               "o": (HIDDEN, HIDDEN), "gate": (HIDDEN, INTER), "up": (HIDDEN, INTER),
               "down": (INTER, HIDDEN)}


def weights(seed=0) -> dict:
    """A one-block model's numpy weights ([in, out] projections, the models'
    layout) and a dense [out, in] weight for the layer functions."""
    rng = np.random.default_rng(seed)

    def randn(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    return dict(
        linear=randn(128, 256),
        params={"embed": randn(VOCAB, HIDDEN),
                "layers": [{k: randn(*s) for k, s in PROJ_SHAPES.items()}],
                "final_norm": np.ones(HIDDEN, np.float32)},
    )


def torch_tree(node):
    if isinstance(node, dict):
        return {k: torch_tree(v) for k, v in node.items()}
    if isinstance(node, list):
        return [torch_tree(v) for v in node]
    return torch.from_numpy(node)


def layers(tree, path=()):
    """(path, layer) of every quantized linear of a port or JAX tree."""
    if isinstance(tree, (nn.QuantizedLinear, jnn.QuantizedLinear)):
        yield path, tree
    elif isinstance(tree, dict):
        for k in sorted(tree):
            yield from layers(tree[k], path + (k,))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from layers(v, path + (i,))


def assert_same_layers(got, want, jax_tree):
    """``got`` and ``want`` (port trees) hold the same layers bit for bit,
    with the same keys; the JAX tree packs the same planes."""
    got, want, jax_layers = list(layers(got)), list(layers(want)), dict(layers(jax_tree))
    assert got and [p for p, _ in got] == [p for p, _ in want] == list(jax_layers)
    for (path, a), (_, b) in zip(got, want):
        assert a.config_key == b.config_key and a.layout == b.layout
        assert len(a.planes) == len(b.planes)
        for p, q in zip(a.planes, b.planes):
            assert torch.equal(p, q)
        assert torch.equal(a.scales.view(torch.int16), b.scales.view(torch.int16))
        assert torch.equal(a.table, b.table)
        j = jax_layers[path]
        for p, q in zip(a.planes, j.planes):
            np.testing.assert_array_equal(p.numpy(), np.asarray(q))


def call_quantize_linear(w, with_keywords):
    kw = dict(example_batch_size=8) if with_keywords else {}
    port = nn.quantize_linear(torch.from_numpy(w["linear"]), 4, G, device="cpu", **kw)
    jax = jnn.quantize_linear(jnp.asarray(w["linear"]), 4, G, example_batch_size=8)
    return port, jax


def call_quantize_linear_config(w, with_keywords):
    kw = dict(example_batch_size=8, config=KernelConfig(chunk=128)) if with_keywords else {}
    port = nn.quantize_linear(torch.from_numpy(w["linear"]), 4, G, chunk=128, device="cpu", **kw)
    jax = jnn.quantize_linear(jnp.asarray(w["linear"]), 4, G, example_batch_size=8,
                              config=JKernelConfig(chunk=128), chunk=128)
    return port, jax


def call_from_codes(w, with_keywords):
    rng = np.random.default_rng(3)
    codes = rng.integers(0, 16, size=(256, 128), dtype=np.int32)
    scales = rng.uniform(0.5, 1.5, (256 // G, 128)).astype(np.float32)
    table = np.sort(rng.standard_normal(16)).astype(np.float32)
    kw = dict(example_batch_size=8) if with_keywords else {}
    port = nn.from_codes(torch.from_numpy(codes), torch.from_numpy(scales).bfloat16(), table, 4,
                         G, device="cpu", **kw)
    jax = jnn.from_codes(jnp.asarray(codes), jnp.asarray(scales, jnp.bfloat16),
                         jnp.asarray(table), 4, G, example_batch_size=8)
    return port, jax


def call_quantize_params(w, with_keywords):
    kw = dict(example_batch_size=8) if with_keywords else {}
    tree = {"a": w["linear"], "b": [w["params"]["layers"][0]["down"].T.copy()]}
    port = nn.quantize_params(torch_tree(tree), 4, G, **kw)
    jax = jnn.quantize_params(tree, 4, G, example_batch_size=8)
    return port, jax


def call_llama_quantize_model(w, with_keywords):
    kw = dict(example_batch_size=8) if with_keywords else {}
    port = llama.quantize_model(torch_tree(w["params"]), group_size=G, fuse=True, device="cpu",
                                **kw)
    jax = jllama.quantize_model(w["params"], group_size=G, fuse=True, example_batch_size=8)
    return port, jax


def call_gemma2_quantize_model(w, with_keywords):
    kw = dict(example_batch_size=8) if with_keywords else {}
    port = gemma2.quantize_model(torch_tree(w["params"]), group_size=G, quantize_lm_head=True,
                                 device="cpu", **kw)
    jax = jgemma2.quantize_model(w["params"], group_size=G, quantize_lm_head=True,
                                 example_batch_size=8)
    return port, jax


CALLS = {
    "quantize_linear": call_quantize_linear,
    "quantize_linear_config": call_quantize_linear_config,
    "from_codes": call_from_codes,
    "quantize_params": call_quantize_params,
    "llama_quantize_model": call_llama_quantize_model,
    "gemma2_quantize_model": call_gemma2_quantize_model,
}


@pytest.mark.parametrize("name", list(CALLS))
def test_port_takes_the_jax_keywords(name):
    w = weights()
    got, jax_tree = CALLS[name](w, True)
    want, _ = CALLS[name](w, False)
    assert_same_layers(got, want, jax_tree)
    if name == "quantize_linear_config":
        assert got.chunk == jax_tree.config.chunk == 128
        assert got.config_key == KernelConfig(chunk=128).key()
    if name == "gemma2_quantize_model":
        assert isinstance(got["lm_head"], nn.QuantizedLinear)


def test_quantize_linear_keys_with_the_registry_for_its_batch():
    """Without ``config`` the layer takes the key of the config that
    ``get_kernel_config`` gives for ``example_batch_size`` rows: the
    planner's launch here (no registry entry on the CPU), its chunk the
    layer's; a tuned launch never enters the key."""
    w = torch.from_numpy(weights()["linear"])
    for m in (1, 8, 40):
        layer = nn.quantize_linear(w, 4, G, example_batch_size=m, chunk=128, device="cpu")
        assert layer.config_key == KernelConfig(chunk=128).key()
    tuned = KernelConfig(block_m=8, chunk=256, m_tiles=2, simt_block_m=4)
    layer = nn.quantize_linear(w, 4, G, config=tuned, chunk=128, device="cpu")
    assert layer.config_key == KernelConfig(block_m=8, chunk=128).key()
