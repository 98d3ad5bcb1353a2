"""The port's Llama against the JAX package's on ``LlamaConfig.tiny()``.

The JAX package makes and quantizes the params; they reach the port as a
numpy tree through ``interop.params_from_numpy``. The port runs its plain
versions on the CPU, the JAX package its Pallas kernels in interpret mode.
Quantized leaves must carry over bit for bit, the port's own quantizer must
give the same leaves, and logits must agree within the bf16 threshold
(1.1e-2 of the largest logit) for prefill and decode, fused and unfused,
with ragged left-pad offsets: at w4sym, and at W3 (wide and 2+1 planes), W2
and general-table W4.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flute_tpu.models import llama as jllama
from flute_tpu.nn import QuantizedLinear as JQuantizedLinear
from flute_tpu.ops.kernel_config import KernelConfig as JKernelConfig
from flute_tpu_torch import interop
from flute_tpu_torch.models import llama
from flute_tpu_torch.nn import QuantizedLinear

BF16_RTOL = 1.1e-2
CPU = torch.device("cpu")


def to_numpy_tree(node):
    """A JAX params pytree with every leaf turned into numpy, quantized
    linears as dicts (the form ``interop.params_from_numpy`` takes)."""
    if isinstance(node, JQuantizedLinear):
        return dict(
            planes=[np.asarray(p) for p in node.planes],
            scales=np.asarray(node.scales),
            table=np.asarray(node.table),
            pair_values=None if node.pair_values is None else np.asarray(node.pair_values),
            bias=None if node.bias is None else np.asarray(node.bias),
            num_bits=node.num_bits,
            group_size=node.group_size,
            layout=node.layout,
            config_key=node.config_key,
            hadamard_size=node.hadamard_size,
        )
    if isinstance(node, dict):
        return {k: to_numpy_tree(v) for k, v in node.items()}
    if isinstance(node, (list, tuple)):
        return type(node)(to_numpy_tree(v) for v in node)
    return None if node is None else np.asarray(node)


def f32(a):
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(a, np.float32)


def max_rel(got, want):
    got, want = f32(got), f32(want)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-6))


@pytest.fixture(scope="module")
def tiny():
    jconfig = jllama.LlamaConfig.tiny()
    jparams = jllama.init_params(jconfig, rng=0)
    return jconfig, llama.LlamaConfig.tiny(), jparams


@pytest.fixture(scope="module", params=[False, True], ids=["unfused", "fused"])
def quantized(request, tiny):
    jconfig, config, jparams = tiny
    jq = jllama.quantize_model(jparams, num_bits=4, group_size=64, fuse=request.param)
    tq = interop.params_from_numpy(to_numpy_tree(jq), device="cpu")
    return jconfig, config, jq, tq


def assert_same_quantized(got: QuantizedLinear, want: JQuantizedLinear):
    assert got.layout == want.layout
    assert got.num_bits == want.num_bits and got.group_size == want.group_size
    assert got.chunk == JKernelConfig.from_key(want.config_key).chunk
    assert len(got.planes) == len(want.planes)
    for p, q in zip(got.planes, want.planes):
        assert p.dtype == torch.int32
        np.testing.assert_array_equal(p.numpy(), np.asarray(q))
    assert got.scales.dtype == torch.bfloat16
    np.testing.assert_array_equal(f32(got.scales), f32(want.scales))
    np.testing.assert_array_equal(got.table.numpy(), np.asarray(want.table))


def test_config_matches_jax():
    for name in ("llama31_8b", "tiny"):
        j = getattr(jllama.LlamaConfig, name)()
        t = getattr(llama.LlamaConfig, name)()
        for field in ("vocab_size", "hidden_size", "intermediate_size", "num_layers",
                      "num_heads", "num_kv_heads", "head_dim", "rms_norm_eps",
                      "rope_theta", "rope_scaling_factor", "rope_original_max_position"):
            assert getattr(t, field) == getattr(j, field), field
    config = llama.LlamaConfig.llama31_8b()
    np.testing.assert_array_equal(
        llama._rope_inv_freq(config), jllama._rope_inv_freq(jllama.LlamaConfig.llama31_8b())
    )


def test_params_carry_over_bit_for_bit(quantized):
    _, _, jq, tq = quantized
    for jl, tl in zip(jq["layers"], tq["layers"]):
        assert set(jl) == set(tl)
        for key, leaf in jl.items():
            if isinstance(leaf, JQuantizedLinear):
                assert_same_quantized(tl[key], leaf)
            else:
                assert tl[key].dtype == torch.bfloat16
                np.testing.assert_array_equal(f32(tl[key]), f32(leaf))
    assert tq["embed"].dtype == torch.bfloat16
    np.testing.assert_array_equal(f32(tq["embed"]), f32(jq["embed"]))
    np.testing.assert_array_equal(f32(tq["lm_head"]), f32(jq["lm_head"]))


@pytest.mark.parametrize("fuse,chunk", [(True, None), (False, 128)])
def test_quantize_model_matches_jax(tiny, fuse, chunk):
    """The port quantizes the same dense weights into the same leaves."""
    _, _, jparams = tiny
    jq = jllama.quantize_model(jparams, num_bits=4, group_size=64, fuse=fuse, chunk=chunk)
    dense = interop.params_from_numpy(to_numpy_tree(jparams), device="cpu")
    tq = llama.quantize_model(dense, num_bits=4, group_size=64, fuse=fuse, chunk=chunk,
                              device="cpu")
    for jl, tl in zip(jq["layers"], tq["layers"]):
        assert set(jl) == set(tl)
        for key, leaf in jl.items():
            if isinstance(leaf, JQuantizedLinear):
                assert_same_quantized(tl[key], leaf)


def _jax_logits(jq, jconfig, tokens, offsets, nxt, pos_vec):
    b, t = tokens.shape
    cache = jllama.init_cache(jconfig, b, 32)
    offs = jnp.asarray(offsets, jnp.int32)
    pre, cache = jllama.forward(jq, jconfig, jnp.asarray(tokens, jnp.int32), cache,
                                jnp.int32(0), offs)
    pos = jnp.asarray(pos_vec, jnp.int32) if pos_vec is not None else jnp.int32(t)
    dec, _ = jllama.forward(jq, jconfig, jnp.asarray(nxt, jnp.int32), cache, pos, offs)
    return np.asarray(pre), np.asarray(dec)


def _port_logits(tq, config, tokens, offsets, nxt, pos_vec):
    b, t = tokens.shape
    cache = llama.init_cache(config, b, 32, device="cpu")
    offs = torch.from_numpy(offsets)
    with torch.inference_mode():
        pre, cache = llama.forward(tq, config, torch.from_numpy(tokens), cache, 0, offs)
        pos = torch.from_numpy(pos_vec) if pos_vec is not None else t
        dec, _ = llama.forward(tq, config, torch.from_numpy(nxt), cache, pos, offs)
    return pre, dec


@pytest.mark.parametrize("per_sequence_pos", [False, True])
def test_logits_match_jax(quantized, per_sequence_pos):
    jconfig, config, jq, tq = quantized
    rng = np.random.default_rng(1)
    b, t = 2, 16
    tokens = rng.integers(0, config.vocab_size, (b, t)).astype(np.int64)
    offsets = np.array([0, 5], np.int64)  # sequence 1 is left-padded by 5
    nxt = rng.integers(0, config.vocab_size, (b, 1)).astype(np.int64)
    pos_vec = np.array([t, t], np.int64) if per_sequence_pos else None
    jpre, jdec = _jax_logits(jq, jconfig, tokens, offsets, nxt, pos_vec)
    tpre, tdec = _port_logits(tq, config, tokens, offsets, nxt, pos_vec)
    assert tpre.dtype == torch.float32 and tuple(tpre.shape) == jpre.shape
    assert tuple(tdec.shape) == jdec.shape == (b, 1, config.vocab_size)
    assert np.isfinite(f32(tpre)).all() and np.isfinite(f32(tdec)).all()
    # left-pad slots of sequence 1 are masked: its real-token logits only
    assert max_rel(tpre[:, offsets[1]:], jpre[:, offsets[1]:]) < BF16_RTOL
    assert max_rel(tdec, jdec) < BF16_RTOL


# quantize_model arguments of the layouts other than w4sym, and the planes
# each must give: W3 wide at chunk 256, W3 as 2+1 planes at chunk 128
SCHEMES = {
    "w3_wide": (dict(num_bits=3), 1),
    "w3_planes": (dict(num_bits=3, chunk=128), 2),
    "w2": (dict(num_bits=2), 1),
    "w4_general": (dict(num_bits=4, symmetric=False), 1),
}


@pytest.mark.parametrize("fuse", [False, True], ids=["unfused", "fused"])
@pytest.mark.parametrize("scheme", list(SCHEMES))
def test_other_layouts_quantize_and_run_as_jax(tiny, scheme, fuse):
    """The port quantizes the dense weights into the JAX package's layouts
    and planes, and its logits follow JAX's."""
    jconfig, config, jparams = tiny
    kw, num_planes = SCHEMES[scheme]
    jq = jllama.quantize_model(jparams, group_size=64, fuse=fuse, **kw)
    dense = interop.params_from_numpy(to_numpy_tree(jparams), device="cpu")
    tq = llama.quantize_model(dense, group_size=64, fuse=fuse, device="cpu", **kw)
    for jl, tl in zip(jq["layers"], tq["layers"]):
        assert set(jl) == set(tl)
        for key, leaf in jl.items():
            if isinstance(leaf, JQuantizedLinear):
                assert_same_quantized(tl[key], leaf)
                assert tl[key].layout == "auto" and len(tl[key].planes) == num_planes
    rng = np.random.default_rng(2)
    tokens = rng.integers(0, config.vocab_size, (2, 16)).astype(np.int64)
    offsets = np.array([0, 5], np.int64)
    nxt = rng.integers(0, config.vocab_size, (2, 1)).astype(np.int64)
    jpre, jdec = _jax_logits(jq, jconfig, tokens, offsets, nxt, None)
    tpre, tdec = _port_logits(tq, config, tokens, offsets, nxt, None)
    assert max_rel(tpre[:, offsets[1]:], jpre[:, offsets[1]:]) < BF16_RTOL
    assert max_rel(tdec, jdec) < BF16_RTOL


def test_building_blocks_match_jax():
    rng = np.random.default_rng(4)
    config = llama.LlamaConfig.tiny()
    jconfig = jllama.LlamaConfig.tiny()
    x = rng.standard_normal((2, 3, 256)).astype(np.float32)
    w = rng.uniform(0.5, 1.5, 256).astype(np.float32)
    xt, xj = torch.from_numpy(x).bfloat16(), jnp.asarray(x, jnp.bfloat16)
    got = llama.rms_norm(xt, torch.from_numpy(w).bfloat16(), 1e-5)
    want = jllama.rms_norm(xj, jnp.asarray(w, jnp.bfloat16), 1e-5)
    assert max_rel(got, want) < BF16_RTOL
    positions = rng.integers(0, 4000, (2, 3))
    cos, sin = llama.rope_tables(config, torch.from_numpy(positions))
    jcos, jsin = jllama.rope_tables(jconfig, jnp.asarray(positions, jnp.int32))
    np.testing.assert_allclose(cos.numpy(), np.asarray(jcos), rtol=0, atol=2e-6)
    np.testing.assert_allclose(sin.numpy(), np.asarray(jsin), rtol=0, atol=2e-6)
    q = rng.standard_normal((2, 3, 4, 128)).astype(np.float32)
    got = llama.apply_rope(torch.from_numpy(q).bfloat16(), cos, sin)
    want = jllama.apply_rope(jnp.asarray(q, jnp.bfloat16), jcos, jsin)
    assert max_rel(got, want) < BF16_RTOL
    qkv = rng.standard_normal((2, 3, (4 + 2 * 2) * 128)).astype(np.float32)
    for a, b in zip(llama.split_fused_qkv(torch.from_numpy(qkv), 4, 2, 128),
                    jllama.split_fused_qkv(jnp.asarray(qkv), 4, 2, 128)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    with pytest.raises(ValueError):
        llama.split_fused_qkv(torch.from_numpy(qkv[..., :-128]), 4, 2, 128)


def test_cache_update_in_place():
    config = llama.LlamaConfig.tiny()
    cache = llama.init_cache(config, 2, 8, device="cpu")
    layer = cache["k"][0]
    new = torch.arange(2 * 3 * 2 * 128, dtype=torch.float32).reshape(2, 3, 2, 128)
    llama._cache_update(layer, new, 2)
    assert layer.data_ptr() == cache["k"][0].data_ptr()
    torch.testing.assert_close(layer[:, :, 2:5].float(), new.transpose(1, 2).bfloat16().float())
    llama._cache_update(layer, new[:, :1], torch.tensor([0, 6]))
    torch.testing.assert_close(layer[0, :, 0].float(), new[0, 0].bfloat16().float())
    torch.testing.assert_close(layer[1, :, 6].float(), new[1, 0].bfloat16().float())


def test_init_params_from_generator():
    config = llama.LlamaConfig.tiny()
    a = llama.init_params(config, seed=3, device="cpu")
    b = llama.init_params(config, seed=3, device="cpu")
    c = llama.init_params(config, seed=4, device="cpu")
    jshapes = jllama.init_params(jllama.LlamaConfig.tiny(), rng=0)
    assert torch.equal(a["layers"][1]["down"], b["layers"][1]["down"])
    assert not torch.equal(a["layers"][1]["down"], c["layers"][1]["down"])
    for key, leaf in jshapes["layers"][0].items():
        assert tuple(a["layers"][0][key].shape) == leaf.shape
        assert a["layers"][0][key].dtype == torch.bfloat16
    assert tuple(a["lm_head"].shape) == jshapes["lm_head"].shape


@pytest.mark.parametrize("fuse", [False, True], ids=["unfused", "fused"])
def test_device_pos_gives_the_bits_of_an_int_pos(tiny, fuse):
    """``forward`` with ``pos`` a 0-dim tensor (what a CUDA graph of the
    decode step replays) writes the same cache and gives the same logits,
    bit for bit, as with an int ``pos``, at prefill and at decode."""
    _, config, jparams = tiny
    dense = interop.params_from_numpy(to_numpy_tree(jparams), device="cpu")
    tq = llama.quantize_model(dense, num_bits=4, group_size=64, fuse=fuse, device="cpu")
    rng = np.random.default_rng(6)
    tokens = torch.from_numpy(rng.integers(0, config.vocab_size, (2, 16)))
    offsets = torch.tensor([0, 5])
    nxt = torch.from_numpy(rng.integers(0, config.vocab_size, (2, 1)))
    runs = []
    for wrap in (int, torch.tensor):
        cache = llama.init_cache(config, 2, 32, device="cpu")
        with torch.inference_mode():
            pre, cache = llama.forward(tq, config, tokens, cache, wrap(0), offsets)
            dec, cache = llama.forward(tq, config, nxt, cache, wrap(16), offsets)
        runs.append((pre, dec, cache))
    (pre_a, dec_a, cache_a), (pre_b, dec_b, cache_b) = runs
    assert torch.equal(pre_a, pre_b) and torch.equal(dec_a, dec_b)
    for name in ("k", "v"):
        assert all(torch.equal(a, b) for a, b in zip(cache_a[name], cache_b[name]))
    assert cache_b["k"][0][:, :, 16].any() and not cache_b["k"][0][:, :, 17:].any()


def test_rope_tables_come_from_one_table_per_config_and_device():
    config = llama.LlamaConfig.tiny()
    positions = torch.arange(6).reshape(2, 3)
    first = llama._inv_freq(config, positions.device)
    cos, sin = llama.rope_tables(config, positions)
    assert llama._inv_freq(config, positions.device) is first
    np.testing.assert_array_equal(first.numpy(), llama._rope_inv_freq(config))
    ang = positions.float()[..., None] * torch.from_numpy(llama._rope_inv_freq(config))
    assert torch.equal(cos, torch.cos(ang)) and torch.equal(sin, torch.sin(ang))
    other = llama.LlamaConfig(rope_theta=10000.0, rope_scaling_factor=None)
    assert llama._inv_freq(other, positions.device) is not first
