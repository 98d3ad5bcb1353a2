"""The port's quantized module layer against the JAX package's.

The same weight goes to ``flute_tpu.nn.quantize_linear`` and to the port's,
for every branch that picks the table and layout (the w4sym default, a
supplied sign-magnitude or ascending symmetric table, a general table, 3-bit
wide and classic); the leaves must be equal bit for bit and the layer's
output within the bf16 threshold of the JAX layer's.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flute_tpu import nn as jnn
from flute_tpu.quantize import nf as jnf
from flute_tpu_torch import nn
from flute_tpu_torch.quantize import nf

OUT, IN, G = 128, 512, 64


def weight(seed=0):
    return np.random.default_rng(seed).standard_normal((OUT, IN)).astype(np.float32)


def asc_symmetric():
    return np.asarray(jnf.nf_values_symmetric_exact(4))


def sign_magnitude():
    mags = np.sort(np.abs(np.random.default_rng(1).standard_normal(8))).astype(np.float32)
    return np.concatenate([mags, -mags])


CASES = {
    "w4sym_default": dict(num_bits=4),
    "sign_magnitude_table": dict(num_bits=4, table=sign_magnitude),
    "ascending_symmetric_table": dict(num_bits=4, table=asc_symmetric),
    "general_table": dict(num_bits=4, table=lambda: nf.QLORA_NF4),
    "nf4_not_symmetric": dict(num_bits=4, symmetric=False),
    "w3_wide": dict(num_bits=3),
    "w3_classic": dict(num_bits=3, wide=False),
    "w2": dict(num_bits=2),
    "w4sym_chunk128": dict(num_bits=4, chunk=128),
}


@pytest.mark.parametrize("case", list(CASES))
def test_quantize_linear_matches_jax(case):
    kw = dict(CASES[case])
    bits = kw.pop("num_bits")
    table = kw.pop("table", None)
    w = weight()
    jl = jnn.quantize_linear(
        jnp.asarray(w), bits, G, table=None if table is None else jnp.asarray(table()), **kw
    )
    tl = nn.quantize_linear(
        torch.from_numpy(w), bits, G, table=None if table is None else table(), **kw
    )
    assert tl.layout == jl.layout and tl.num_bits == jl.num_bits
    assert tl.chunk == jl.config.chunk
    assert len(tl.planes) == len(jl.planes)
    for p, q in zip(tl.planes, jl.planes):
        np.testing.assert_array_equal(p.numpy(), np.asarray(q))
    np.testing.assert_array_equal(tl.scales.float().numpy(), np.asarray(jl.scales, np.float32))
    np.testing.assert_array_equal(tl.table.numpy(), np.asarray(jl.table))

    x = np.random.default_rng(2).standard_normal((3, IN)).astype(np.float32)
    got = tl(torch.from_numpy(x).bfloat16()).float().numpy()
    want = np.asarray(jl(jnp.asarray(x, jnp.bfloat16)), np.float32)
    assert np.linalg.norm(got - want) / np.linalg.norm(want) < 1.1e-2
    # the port's dequantize agrees with its own identity GEMM at every chunk
    eye = torch.eye(IN, dtype=torch.float32)
    np.testing.assert_array_equal(
        tl.dequantize(torch.float32).numpy(), tl(eye).numpy()
    )


def test_quantize_params_and_bias():
    rng = np.random.default_rng(4)
    tree = {
        "a": torch.from_numpy(weight(5)),
        "b": [torch.from_numpy(rng.standard_normal((64, 200)).astype(np.float32))],
        "norm": torch.ones(IN),
    }
    out = nn.quantize_params(tree, 4, G)
    assert isinstance(out["a"], nn.QuantizedLinear) and out["a"].layout == "w4sym"
    assert isinstance(out["b"][0], torch.Tensor)  # in-dim 200 does not divide
    assert out["norm"] is tree["norm"]
    only_a = nn.quantize_params(tree, 4, G, predicate=lambda path, leaf: path == ("a",))
    assert isinstance(only_a["a"], nn.QuantizedLinear) and only_a["b"][0] is tree["b"][0]
    bias = torch.from_numpy(rng.standard_normal(OUT).astype(np.float32))
    layer = nn.quantize_linear(torch.from_numpy(weight()), 4, G, bias=bias)
    x = torch.ones((2, IN), dtype=torch.bfloat16)
    want = (x.float() @ layer.dequantize().float()).bfloat16() + bias.bfloat16()
    torch.testing.assert_close(layer(x), want, rtol=1.1e-2, atol=1e-2)
    with pytest.raises(ValueError):
        nn.quantize_linear(torch.from_numpy(weight()), 3, G, symmetric=True)
