"""The port's quantized module layer against the JAX package's.

The same weight goes to ``flute_tpu.nn.quantize_linear`` and to the port's,
for every branch that picks the table and layout (the w4sym default, a
supplied sign-magnitude or ascending symmetric table, a general table, 3-bit
wide and classic); the leaves must be equal bit for bit and the layer's
output within the bf16 threshold of the JAX layer's. ``from_codes`` is held
against ``flute_tpu.nn.from_codes`` the same way, with and without a joint
pair table, and ``interop.params_from_numpy`` must carry every field of a
JAX layer, the Hadamard rotation included.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_llama import to_numpy_tree

from flute_tpu import nn as jnn
from flute_tpu.ops import lut_gemm as jlut
from flute_tpu.quantize import nf as jnf
from flute_tpu_torch import interop, nn
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


def codes_scales(bits, k=IN, n=OUT, seed=6):
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 2**bits, size=(k, n), dtype=np.int32)
    scales = rng.uniform(0.5, 1.5, (k // G, n)).astype(np.float32)
    return rng, codes, scales


@pytest.mark.parametrize("pair", [False, True], ids=["table", "pair_values"])
@pytest.mark.parametrize("chunk", [128, 256])
@pytest.mark.parametrize("bits", [2, 3, 4])
def test_from_codes_matches_jax(bits, chunk, pair):
    rng, codes, scales = codes_scales(bits)
    table = np.sort(rng.standard_normal(2**bits)).astype(np.float32)
    pv = rng.standard_normal((2**bits, 2**bits, 2)).astype(np.float32) if pair else None
    bias = rng.standard_normal(OUT).astype(np.float32)
    jl = jnn.from_codes(
        jnp.asarray(codes), jnp.asarray(scales, jnp.bfloat16), None if pair else jnp.asarray(table),
        bits, G, pair_values=None if pv is None else jnp.asarray(pv),
        bias=jnp.asarray(bias), chunk=chunk,
    )
    tl = nn.from_codes(
        torch.from_numpy(codes), torch.from_numpy(scales).bfloat16(),
        None if pair else table, bits, G,
        pair_values=None if pv is None else torch.from_numpy(pv),
        bias=torch.from_numpy(bias), chunk=chunk,
    )
    assert tl.layout == jl.layout == "auto" and tl.chunk == jl.config.chunk == chunk
    assert len(tl.planes) == len(jl.planes) == (2 if bits == 3 else 1)
    for p, q in zip(tl.planes, jl.planes):
        np.testing.assert_array_equal(p.numpy(), np.asarray(q))
    np.testing.assert_array_equal(tl.table.numpy(), np.asarray(jl.table))
    x = np.random.default_rng(7).standard_normal((3, IN)).astype(np.float32)
    got = tl(torch.from_numpy(x).bfloat16()).float().numpy()
    want = np.asarray(jl(jnp.asarray(x, jnp.bfloat16)), np.float32)
    assert np.linalg.norm(got - want) / np.linalg.norm(want) < 1.1e-2
    # against the JAX oracle on the codes (JAX's own dequantize ignores chunk)
    sj = jnp.asarray(scales, jnp.bfloat16)
    want_deq = (
        jlut.dequantize_codes_pair(jnp.asarray(codes), sj, jnp.asarray(pv), jnp.float32)
        if pair else jlut.dequantize_codes(jnp.asarray(codes), sj, jnp.asarray(table), jnp.float32)
    )
    np.testing.assert_array_equal(tl.dequantize(torch.float32).numpy(), np.asarray(want_deq))


def test_from_codes_numpy_codes_need_a_device():
    _, codes, scales = codes_scales(2)
    layer = nn.from_codes(codes, torch.from_numpy(scales), np.arange(4.0), 2, G, device="cpu")
    np.testing.assert_array_equal(
        layer.planes[0].numpy(), np.asarray(jnn.from_codes(codes, scales, None, 2, G).planes[0])
    )
    assert layer.pair_values is None and layer.bias is None


def test_interop_keeps_pair_values():
    rng, codes, scales = codes_scales(2, seed=8)
    pv = rng.standard_normal((4, 4, 2)).astype(np.float32)
    jl = jnn.from_codes(jnp.asarray(codes), jnp.asarray(scales, jnp.bfloat16), None, 2, G,
                        pair_values=jnp.asarray(pv))
    tl = interop.params_from_numpy({"w": to_numpy_tree(jl)}, device="cpu")["w"]
    np.testing.assert_array_equal(tl.pair_values.numpy(), pv)
    x = rng.standard_normal((5, IN)).astype(np.float32)
    got = tl(torch.from_numpy(x).bfloat16()).float().numpy()
    want = np.asarray(jl(jnp.asarray(x, jnp.bfloat16)), np.float32)
    assert np.linalg.norm(got - want) / np.linalg.norm(want) < 1.1e-2
    np.testing.assert_array_equal(
        tl.dequantize(torch.float32).numpy(), np.asarray(jl.dequantize(jnp.float32))
    )
    moved = interop.move_params([tl], torch.device("cpu"))[0]
    assert torch.equal(moved.pair_values, tl.pair_values)


def test_interop_refuses_a_hadamard_layer():
    """A layer with ``hadamard_size`` is no longer refused: interop and the
    module keep the rotation, and the output is the JAX layer's."""
    _, codes, scales = codes_scales(4, seed=9)
    jl = jnn.from_codes(jnp.asarray(codes), jnp.asarray(scales, jnp.bfloat16),
                        jnp.asarray(np.sort(np.random.default_rng(1).standard_normal(16)),
                                    jnp.float32), 4, G)
    d = to_numpy_tree(jl)
    d["hadamard_size"] = 128
    tl = interop.params_from_numpy({"layers": [{"o": d}]}, device="cpu")["layers"][0]["o"]
    assert tl.hadamard_size == 128 and "hadamard=128" in repr(tl)
    x = np.random.default_rng(10).standard_normal((3, IN)).astype(np.float32)
    import dataclasses

    want = np.asarray(dataclasses.replace(jl, hadamard_size=128)(jnp.asarray(x, jnp.bfloat16)),
                      np.float32)
    got = tl(torch.from_numpy(x).bfloat16()).float().numpy()
    assert np.linalg.norm(got - want) / np.linalg.norm(want) < 1.1e-2
    plain = nn.QuantizedLinear(tl.planes, tl.scales, tl.table, config_key=tl.config_key)
    assert not torch.equal(plain(torch.from_numpy(x).bfloat16()).float(), torch.from_numpy(got))
    assert tl.with_config(tl.config).hadamard_size == 128
