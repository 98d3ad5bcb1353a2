"""The port's HIGGS layers (Hadamard rotation, then the joint pair lookup)
against the JAX package's.

* ``from_higgs`` at 2, 3 and 4 bits with ``hadamard_size`` 128 on the same
  seeded codes, grid and scales: planes and pair table equal, dequantize
  bit-equal, the layer's output on random x within 1.1e-2 (bf16) / 2e-3
  (f16) of the JAX layer's (JAX's pair_lut kernel in interpret mode).
  ``from_higgs_scalar`` too.
* A HIGGS layer carries its ``hadamard_size`` through checkpoints both ways:
  saved by JAX and loaded by the port, and saved by the port and loaded by
  JAX, with equal leaves and outputs.
* ``PagedEngine`` serving the tiny Llama with every projection a HIGGS W4
  layer against JAX's ``PagedEngine`` (pool prefill), the port at both
  ``pool_prefill`` settings, gated as ``tests/test_torch_paged.py`` gates.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_checkpoint import assert_same_leaves
from test_torch_llama import to_numpy_tree
from test_torch_paged import PROMPTS, check_paged_against_jax, jax_reference

from flute_tpu.integrations import checkpoint as jcheckpoint
from flute_tpu.models import llama as jllama
from flute_tpu.ops import lut_gemm as jlut
from flute_tpu.quantize import higgs as jhiggs
from flute_tpu_torch import interop
from flute_tpu_torch.integrations import checkpoint
from flute_tpu_torch.models import llama
from flute_tpu_torch.ops import hadamard
from flute_tpu_torch.ops.kernel_config import KernelConfig
from flute_tpu_torch.quantize import higgs

@pytest.fixture(autouse=True, scope="module")
def few_torch_threads():
    """The port's engines run many small CPU ops; beside the other test
    workers, a full team of threads per op mostly waits on the others."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


K, N, G, HAD = 512, 256, 64, 128
TOL = {"bfloat16": 1.1e-2, "float16": 2e-3}


def higgs_inputs(bits, k=K, n=N, seed=0, scale=(0.5, 1.5)):
    rng = np.random.default_rng(seed + bits)
    e = 2**bits
    codes = rng.integers(0, e * e, (k // 2, n), dtype=np.int64)
    grid = rng.standard_normal((e * e, 2)).astype(np.float32)
    scales = rng.uniform(*scale, (k // G, n)).astype(np.float32)
    return codes, grid, scales


def jax_layer(codes, grid, scales, bits, hadamard_size=HAD):
    return jhiggs.from_higgs(codes, grid, jnp.asarray(scales, jnp.bfloat16), num_bits=bits,
                             group_size=G, hadamard_size=hadamard_size)


def port_layer(codes, grid, scales, bits, hadamard_size=HAD):
    return higgs.from_higgs(torch.from_numpy(codes), grid, torch.from_numpy(scales).bfloat16(),
                            num_bits=bits, group_size=G, hadamard_size=hadamard_size)


@pytest.mark.parametrize("bits", [2, 3, 4])
def test_from_higgs_matches_jax(bits):
    codes, grid, scales = higgs_inputs(bits)
    jl = jax_layer(codes, grid, scales, bits)
    tl = port_layer(codes, grid, scales, bits)
    assert tl.hadamard_size == jl.hadamard_size == HAD
    assert len(tl.planes) == len(jl.planes) == (2 if bits == 3 else 1)
    for p, q in zip(tl.planes, jl.planes):
        np.testing.assert_array_equal(p.numpy(), np.asarray(q))
    np.testing.assert_array_equal(tl.pair_values.numpy(), np.asarray(jl.pair_values))
    np.testing.assert_array_equal(higgs.grid_to_pair_values(grid, bits).numpy(),
                                  np.asarray(jhiggs.grid_to_pair_values(grid, bits)))
    # the key names the pair lookup and the pack chunk (its TPU block
    # fields are the port's defaults: ROADMAP.md queue 3 item 4)
    cfg = KernelConfig.from_key(tl.config_key)
    assert cfg.lut_mode == jl.config.lut_mode == "pair_lut"
    assert cfg.chunk == jl.config.chunk == 256
    for dt in ("bfloat16", "float32"):
        np.testing.assert_array_equal(
            tl.dequantize(getattr(torch, dt)).float().numpy(),
            np.asarray(jl.dequantize(getattr(jnp, dt)), np.float32))
    # vector dequantization is grid[c] * scale, the codes split ce | co << b
    e = 2**bits
    deq = tl.dequantize(torch.float32).numpy()
    sc = np.repeat(scales.astype(np.float32), G, axis=0)
    want = np.empty((K, N), np.float32)
    want[0::2] = grid[codes][..., 0]
    want[1::2] = grid[codes][..., 1]
    bfs = torch.from_numpy(scales).bfloat16().float().numpy()
    np.testing.assert_array_equal(deq, want * np.repeat(bfs, G, axis=0))
    assert codes.max() < e * e and sc.shape == deq.shape


@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
@pytest.mark.parametrize("bits", [2, 3, 4])
def test_higgs_layer_output_matches_jax(bits, dtype):
    codes, grid, scales = higgs_inputs(bits, seed=10)
    jl = jax_layer(codes, grid, scales, bits)
    tl = port_layer(codes, grid, scales, bits)
    x = np.random.default_rng(20 + bits).standard_normal((3, K)).astype(np.float32)
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    if dtype == "float16":  # the layer's scales follow x's dtype
        jl = jhiggs.from_higgs(codes, grid, jnp.asarray(scales, jnp.float16), num_bits=bits,
                               group_size=G, hadamard_size=HAD)
        tl = higgs.from_higgs(torch.from_numpy(codes), grid, torch.from_numpy(scales).half(),
                              num_bits=bits, group_size=G, hadamard_size=HAD)
    got = tl(torch.from_numpy(x).to(tdt))
    want = np.asarray(jl(jnp.asarray(x, jdt)), np.float32)
    assert got.dtype == tdt
    g = got.float().numpy()
    assert np.linalg.norm(g - want) / np.linalg.norm(want) < TOL[dtype]
    # the layer is the rotation, then the pair-lookup GEMM
    xr = hadamard.grouped_hadamard_transform(torch.from_numpy(x).to(tdt), HAD)
    plain = torch.matmul(xr.float(), tl.dequantize(tdt).float()).to(tdt)
    assert torch.equal(got, plain)


def test_from_higgs_scalar_matches_jax():
    rng = np.random.default_rng(5)
    bits = 4
    codes = rng.integers(0, 2**bits, (256, 128), dtype=np.int32)
    grid = np.sort(rng.standard_normal(2**bits)).astype(np.float32)
    scales = rng.uniform(0.5, 1.5, (256 // G, 128)).astype(np.float32)
    jl = jhiggs.from_higgs_scalar(codes, grid, jnp.asarray(scales, jnp.bfloat16),
                                  num_bits=bits, group_size=G)
    tl = higgs.from_higgs_scalar(torch.from_numpy(codes), grid[:, None],
                                 torch.from_numpy(scales).bfloat16(), num_bits=bits,
                                 group_size=G)
    assert tl.pair_values is None and tl.hadamard_size is None
    np.testing.assert_array_equal(tl.planes[0].numpy(), np.asarray(jl.planes[0]))
    np.testing.assert_array_equal(tl.dequantize().float().numpy(),
                                  np.asarray(jl.dequantize(), np.float32))
    want = jlut.dequantize_codes(jnp.asarray(codes), jnp.asarray(scales, jnp.bfloat16),
                                 jnp.asarray(grid), jnp.bfloat16)
    np.testing.assert_array_equal(tl.dequantize().float().numpy(), np.asarray(want, np.float32))
    with pytest.raises(ValueError, match="grid"):
        higgs.from_higgs_scalar(codes, grid[:8], scales, num_bits=bits, group_size=G,
                                device="cpu")
    with pytest.raises(ValueError, match="range"):
        higgs.from_higgs(np.full((128, 8), 16), grid.reshape(8, 2), torch.ones(4, 8),
                         num_bits=2, group_size=G, device="cpu")


def test_higgs_checkpoint_keeps_the_rotation_both_ways(tmp_path):
    codes, grid, scales = higgs_inputs(4, seed=30)
    jl = jax_layer(codes, grid, scales, 4)
    jtree = {"higgs": jl, "embed": jnp.asarray(scales, jnp.bfloat16)}
    x = np.random.default_rng(31).standard_normal((4, K)).astype(np.float32)
    want = np.asarray(jl(jnp.asarray(x, jnp.bfloat16)), np.float32)

    jcheckpoint.save_quantized(str(tmp_path / "jax"), jtree, num_bits=4, group_size=G)
    tq, _ = checkpoint.load_quantized(str(tmp_path / "jax"), device="cpu")
    assert tq["higgs"].hadamard_size == HAD
    assert_same_leaves({**tq, "pair": tq["higgs"]}, {**jtree, "pair": jl})
    got = tq["higgs"](torch.from_numpy(x).bfloat16()).float().numpy()
    assert np.linalg.norm(got - want) / np.linalg.norm(want) < TOL["bfloat16"]

    checkpoint.save_quantized(str(tmp_path / "port"), tq, num_bits=4, group_size=G)
    jtree2, _ = jcheckpoint.load_quantized(str(tmp_path / "port"))
    assert jtree2["higgs"].hadamard_size == HAD
    np.testing.assert_array_equal(
        np.asarray(jtree2["higgs"](jnp.asarray(x, jnp.bfloat16)), np.float32), want)
    tq2, _ = checkpoint.load_quantized(str(tmp_path / "port"), device="cpu")
    assert torch.equal(tq2["higgs"](torch.from_numpy(x).bfloat16()).float(),
                       torch.from_numpy(got))
    moved = interop.move_params(tq2, torch.device("cpu"))
    assert moved["higgs"].hadamard_size == HAD


def higgs_model(bits=4):
    """The tiny Llama (fused) with every projection a HIGGS layer, built by
    the JAX package from seeded codes, grid and scales, and the same params
    in the port."""
    jconfig = jllama.LlamaConfig.tiny()
    jq = jllama.quantize_model(jllama.init_params(jconfig, rng=0), 4, G, fuse=True)
    for li, layer in enumerate(jq["layers"]):
        for j, name in enumerate(("qkv", "o", "gate_up", "down")):
            k, n = layer[name].in_features, layer[name].out_features
            codes, grid, scales = higgs_inputs(bits, k, n, seed=100 * li + 10 * j,
                                               scale=(0.015, 0.025))
            layer[name] = jax_layer(codes, grid, scales, bits)
    tq = interop.params_from_numpy(to_numpy_tree(jq), device="cpu")
    return jconfig, jq, llama.LlamaConfig.tiny(), tq


def test_higgs_paged_engine_matches_jax():
    jconfig, jq, config, tq = higgs_model()
    assert {layer["down"].hadamard_size for layer in tq["layers"]} == {HAD}
    ref = jax_reference(jconfig, jq, PROMPTS)
    for pool_prefill in (True, False):
        check_paged_against_jax(ref, config, tq, PROMPTS, pool_prefill)
