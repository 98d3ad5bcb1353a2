"""The reference-FLUTE importer in the port against the JAX package's:
the reference bit layout packed and unpacked the same for (bits, tileP) in
(4, 64), (4, 32), (2, 32), (3, 32); a reference-format tiny Llama directory
converted by both packages into byte-identical checkpoint files (W4, W3,
W2); ``tables2`` decoded the same (f16 and bf16 halves); and a FLUTE-HIGGS
layer's vector grid kept as ``pair_values`` by the port, which the JAX
converter leaves out, so that the imported layer serves its grid."""

import dataclasses
import filecmp
import json
import os

import numpy as np
import pytest
import torch

from flute_tpu.integrations import flute_format as jff
from flute_tpu_torch.integrations import flute_format as ff
from flute_tpu_torch.integrations import safetensors_io
from flute_tpu_torch.integrations.huggingface import load_quantized_model
from flute_tpu_torch.models import llama
from flute_tpu_torch.ops import lut_gemm

LAYOUTS = [(4, 64), (4, 32), (2, 32), (3, 32)]
HF_LINEAR = {"q": "self_attn.q_proj", "k": "self_attn.k_proj", "v": "self_attn.v_proj",
             "o": "self_attn.o_proj", "gate": "mlp.gate_proj", "up": "mlp.up_proj",
             "down": "mlp.down_proj"}


@pytest.mark.parametrize("num_bits,tile_p", LAYOUTS)
def test_pack_unpack_match(num_bits, tile_p):
    rng = np.random.default_rng(num_bits * tile_p)
    k, n = 128, 1024
    codes = rng.integers(0, 2**num_bits, (k, n), dtype=np.int32)
    packed = ff.pack_reference_weight(codes, num_bits, tile_p=tile_p)
    want = jff.pack_reference_weight(codes, num_bits, tile_p=tile_p)
    assert packed.dtype == np.int16 and packed.shape == (n * num_bits // 16, k)
    np.testing.assert_array_equal(packed, want)
    back = ff.unpack_reference_weight(packed, num_bits, tile_p=tile_p)
    np.testing.assert_array_equal(back, jff.unpack_reference_weight(want, num_bits, tile_p=tile_p))
    np.testing.assert_array_equal(back, codes)


def test_tile_p_rule_matches():
    for bits in (2, 3, 4):
        for tid in range(100):
            assert ff.tile_p_for_template(bits, tid) == jff.tile_p_for_template(bits, tid)


def pair_grid(rng, e, dtype16="float16"):
    """A vector grid [E, E, 2] and its tables2 buffer (halves bit-viewed as f32)."""
    half = {"float16": torch.float16, "bfloat16": torch.bfloat16}[dtype16]
    pv = torch.from_numpy(rng.standard_normal((e, e, 2)).astype(np.float32)).to(half)
    bits = pv.view(torch.int16).numpy().view(np.uint16).astype(np.uint32)
    t2 = (bits[..., 0] | (bits[..., 1] << 16)).view(np.float32).reshape(e, e, 1)
    return pv.float().numpy(), np.ascontiguousarray(t2)


@pytest.mark.parametrize("dtype16", ["float16", "bfloat16"])
def test_tables2_decode_matches(dtype16):
    rng = np.random.default_rng(4)
    pv, t2 = pair_grid(rng, 16, dtype16)
    got = ff.pair_values_from_tables2(t2, 4, dtype16=dtype16)
    np.testing.assert_array_equal(got, jff.pair_values_from_tables2(t2, 4, dtype16=dtype16))
    np.testing.assert_array_equal(got, pv)
    table = np.sort(rng.standard_normal(16)).astype(np.float32)
    assert ff.is_vector_tables2(t2, table, 4, dtype16=dtype16)
    outer = np.stack(np.broadcast_arrays(table[:, None], table[None, :]), -1).astype(np.float16)
    t2s = outer.view(np.uint16).astype(np.uint32)
    t2s = (t2s[..., 0] | (t2s[..., 1] << 16)).view(np.float32).reshape(16, 16, 1)
    assert not ff.is_vector_tables2(t2s, table, 4)
    assert not jff.is_vector_tables2(t2s, table, 4)


def write_reference_llama(path, config, num_bits, seed=0, tile_p=32, higgs=False, group=64):
    """A reference-format Llama directory: HF module names, int16 [P, K]
    weights with f16 scales [N, K/g] and tables (and a vector tables2 with
    ``higgs``), dense f32 embeddings, norms and head, a flute_config.json
    and a config.json. Returns {layer key: codes [K, N]} of layer 0."""
    rng = np.random.default_rng(seed)
    os.makedirs(path, exist_ok=True)
    c = config
    qdim, kvdim = c.num_heads * c.head_dim, c.num_kv_heads * c.head_dim
    shapes = {"q": (c.hidden_size, qdim), "k": (c.hidden_size, kvdim),
              "v": (c.hidden_size, kvdim), "o": (qdim, c.hidden_size),
              "gate": (c.hidden_size, c.intermediate_size),
              "up": (c.hidden_size, c.intermediate_size),
              "down": (c.intermediate_size, c.hidden_size)}
    e = 2**num_bits
    tensors = {
        "model.embed_tokens.weight": rng.standard_normal((c.vocab_size, c.hidden_size)
                                                         ).astype(np.float32),
        "model.norm.weight": rng.uniform(0.5, 1.5, c.hidden_size).astype(np.float32),
        "lm_head.weight": (0.02 * rng.standard_normal((c.vocab_size, c.hidden_size))
                           ).astype(np.float32),
    }
    codes0 = {}
    for li in range(c.num_layers):
        pre = f"model.layers.{li}."
        tensors[pre + "input_layernorm.weight"] = rng.uniform(0.5, 1.5, c.hidden_size
                                                              ).astype(np.float32)
        tensors[pre + "post_attention_layernorm.weight"] = rng.uniform(
            0.5, 1.5, c.hidden_size).astype(np.float32)
        for key, (k, n) in shapes.items():
            codes = rng.integers(0, e, (k, n), dtype=np.int32)
            if li == 0:
                codes0[key] = codes
            name = pre + HF_LINEAR[key]
            tensors[name + ".weight"] = ff.pack_reference_weight(codes, num_bits, tile_p=tile_p)
            tensors[name + ".scales"] = (0.02 * rng.uniform(0.5, 1.5, (n, k // group))
                                         ).astype(np.float16)
            table = np.sort(rng.standard_normal(e)).astype(np.float16)
            tensors[name + ".tables"] = table
            if higgs:
                tensors[name + ".tables2"] = pair_grid(rng, e)[1]
    safetensors_io.save_file(tensors, os.path.join(path, "model.safetensors"))
    with open(os.path.join(path, "flute_config.json"), "w") as f:
        json.dump({"version": "0.4.2", "num_bits": num_bits, "group_size": group,
                   "template_id": 20 if tile_p == 32 else 0}, f)
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump({"model_type": "llama", "vocab_size": c.vocab_size,
                   "hidden_size": c.hidden_size, "intermediate_size": c.intermediate_size,
                   "num_hidden_layers": c.num_layers, "num_attention_heads": c.num_heads,
                   "num_key_value_heads": c.num_kv_heads, "head_dim": c.head_dim,
                   "rms_norm_eps": c.rms_norm_eps, "rope_theta": c.rope_theta,
                   "rope_scaling": None, "tie_word_embeddings": False}, f)
    return codes0


def same_files(a, b, allow=()):
    cmp = filecmp.dircmp(a, b)
    assert cmp.left_only == [] and cmp.right_only == [], (cmp.left_only, cmp.right_only)
    _, mismatch, errors = filecmp.cmpfiles(a, b, cmp.common_files, shallow=False)
    assert [f for f in mismatch if f not in allow] == [] and errors == []


def tiny_config():
    """Tiny Llama with every projection's N a multiple of 512 (the
    reference 3-bit layout packs N in 512-column chunks)."""
    return dataclasses.replace(llama.LlamaConfig.tiny(), hidden_size=512, intermediate_size=1024,
                               num_kv_heads=4, rope_scaling_factor=None)


@pytest.mark.parametrize("num_bits", [4, 3, 2])
def test_reference_to_model_checkpoint_writes_jax_files(tmp_path, num_bits):
    src = str(tmp_path / "ref")
    codes0 = write_reference_llama(src, tiny_config(), num_bits, seed=num_bits)
    n_port = ff.reference_to_model_checkpoint(src, str(tmp_path / "port"), template_id=20)
    n_jax = jff.reference_to_model_checkpoint(src, str(tmp_path / "jax"), template_id=20)
    assert n_port == n_jax == 7 * tiny_config().num_layers
    same_files(str(tmp_path / "port"), str(tmp_path / "jax"))
    # the converted layer dequantizes to the reference's codes and values
    params, config, sidecar = load_quantized_model(str(tmp_path / "port"), device="cpu")
    assert sidecar["num_bits"] == num_bits and config.hidden_size == 512
    layer = params["layers"][0]["gate"]
    assert layer.kernel_layout == "plane" and layer.pair_values is None
    want = lut_gemm.dequantize_codes(torch.from_numpy(codes0["gate"]), layer.scales,
                                     layer.table, torch.bfloat16)
    assert torch.equal(layer.dequantize(torch.bfloat16), want)


def test_higgs_import_keeps_the_vector_grid(tmp_path):
    """With vector tables2 the port writes JAX's files plus each layer's
    pair_values (and their manifest entries), and serves the grid."""
    src = str(tmp_path / "ref")
    codes0 = write_reference_llama(src, tiny_config(), 4, seed=9, higgs=True)
    ff.reference_to_model_checkpoint(src, str(tmp_path / "port"), template_id=20)
    jff.reference_to_model_checkpoint(src, str(tmp_path / "jax"), template_id=20)
    port_files = set(os.listdir(tmp_path / "port"))
    extra = sorted(port_files - set(os.listdir(tmp_path / "jax")))
    assert len(extra) == 7 * tiny_config().num_layers
    assert all(f.endswith(".pair_values.npy") for f in extra)
    for f in extra:
        os.remove(tmp_path / "port" / f)
    same_files(str(tmp_path / "port"), str(tmp_path / "jax"), allow=("manifest.json",))
    with open(tmp_path / "port" / "manifest.json") as f:
        port_manifest = json.load(f)
    with open(tmp_path / "jax" / "manifest.json") as f:
        jax_manifest = json.load(f)
    for e in port_manifest["entries"]:
        e.get("tensors", {}).pop("pair_values", None)
    assert port_manifest == jax_manifest
    # reload with the pair files in place: the layer is a K4 (pair) layer
    ff.reference_to_model_checkpoint(src, str(tmp_path / "port2"), template_id=20)
    params, _, _ = load_quantized_model(str(tmp_path / "port2"), device="cpu")
    layer = params["layers"][0]["up"]
    assert layer.kernel_layout == "pair"
    converted = ff.load_reference_checkpoint(src, template_id=20)["model.layers.0.mlp.up_proj"]
    np.testing.assert_array_equal(layer.pair_values.numpy(), converted["pair_values"])
    want = lut_gemm.dequantize_codes_pair(torch.from_numpy(codes0["up"]), layer.scales,
                                          layer.pair_values, torch.bfloat16)
    assert torch.equal(layer.dequantize(torch.bfloat16), want)


def test_load_reference_checkpoint_matches(tmp_path):
    src = str(tmp_path / "ref")
    write_reference_llama(src, tiny_config(), 4, seed=5, tile_p=64, higgs=True)
    got = ff.load_reference_checkpoint(src)
    want = jff.load_reference_checkpoint(src)
    assert sorted(got) == sorted(want)
    for name, w in want.items():
        g = got[name]
        if isinstance(w, dict):
            assert sorted(g) == sorted(w)
            for p, q in zip(g["planes"], w["planes"]):
                np.testing.assert_array_equal(p, q)
            for key in ("scales", "table", "pair_values"):
                np.testing.assert_array_equal(g[key], w[key])
        else:
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    with open(os.path.join(src, "flute_config.json"), "w") as f:
        json.dump({"num_bits": 4, "group_size": 64}, f)
    with pytest.raises(ValueError, match="tileP"):
        ff.load_reference_checkpoint(src)
