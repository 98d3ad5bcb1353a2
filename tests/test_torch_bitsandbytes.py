"""bitsandbytes NF4/FP4 import in the port against the JAX package's
``convert_bnb_linear4bit`` on the same seeded layers, plain and with
nested (double-quantized) absmax: decoded codes and absmax, and the
converted layer's planes, scales and table, bit for bit; the layer's
dequantized weight is bnb's own decode; ``load_bnb_checkpoint`` on an HF
directory written by the port's safetensors writer."""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flute_tpu.quantize import bitsandbytes as jbnb
from flute_tpu_torch.integrations import safetensors_io
from flute_tpu_torch.quantize import bitsandbytes as bnb
from flute_tpu_torch.quantize import nf

FP4 = np.asarray([0.0, 0.0052, 0.6667, 1.0, 0.3333, 0.5, 0.1667, 0.25,
                  -0.0, -0.0052, -0.6667, -1.0, -0.3333, -0.5, -0.1667, -0.25], np.float32)
N, K, BS = 128, 256, 64


def fake_layer(seed, quant_type="nf4", nested=True, n=N, k=K, blocksize=BS):
    """Packed nibbles and the quant state of a random bnb layer (absmax
    double-quantized per 256 blocks the way bnb does, where nested)."""
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 16, n * k, dtype=np.int32)
    packed = ((codes[0::2] << 4) | codes[1::2]).astype(np.uint8)
    table = np.asarray(nf.QLORA_NF4) if quant_type == "nf4" else FP4
    absmax_f = rng.uniform(0.1, 2.0, n * k // blocksize).astype(np.float32)
    if not nested:
        return packed, dict(code=table, absmax=absmax_f, blocksize=blocksize, shape=(n, k))
    offset = float(absmax_f.mean())
    centered = absmax_f - offset
    nested_code = np.linspace(-1, 1, 256).astype(np.float32)
    pad = (-len(centered)) % 256
    cpad = np.pad(centered, (0, pad)).reshape(-1, 256)
    nested_absmax = np.abs(cpad).max(axis=1)
    nested_absmax[nested_absmax == 0] = 1.0
    normalized = cpad / nested_absmax[:, None]
    aq = np.argmin(np.abs(normalized.reshape(-1, 1) - nested_code[None, :]),
                   axis=1).astype(np.uint8)[: len(centered)]
    return packed, dict(code=table, absmax=aq, blocksize=blocksize, shape=(n, k),
                        nested_code=nested_code, nested_absmax=nested_absmax, offset=offset)


CASES = [("nf4", False), ("nf4", True), ("fp4", False), ("fp4", True)]


@pytest.mark.parametrize("quant_type,nested", CASES)
def test_convert_matches_jax(quant_type, nested):
    packed, state = fake_layer(10 + len(quant_type) + nested, quant_type, nested)
    js, ts = jbnb.BNBQuantState(**state), bnb.BNBQuantState(**state)
    np.testing.assert_array_equal(bnb.decode_absmax(ts), jbnb.decode_absmax(js))
    np.testing.assert_array_equal(bnb.unpack_nibbles(packed, N * K),
                                  jbnb.unpack_nibbles(packed, N * K))
    np.testing.assert_array_equal(bnb.dequantize_bnb(ts, packed), jbnb.dequantize_bnb(js, packed))
    for dtype in ("bfloat16", "float32"):
        a = jbnb.convert_bnb_linear4bit(packed, js, dtype=getattr(jnp, dtype))
        b = bnb.convert_bnb_linear4bit(packed, ts, dtype=getattr(torch, dtype), device="cpu")
        assert len(b.planes) == len(a.planes) and b.layout == a.layout
        for pa, pb in zip(a.planes, b.planes):
            np.testing.assert_array_equal(pb.numpy(), np.asarray(pa))
        np.testing.assert_array_equal(b.scales.float().numpy(), np.asarray(a.scales, np.float32))
        np.testing.assert_array_equal(b.table.numpy(), np.asarray(a.table))
        assert b.config.chunk == a.config.chunk  # the TPU block fields are not the port's
    # value-identical to bnb's own decode (in f32)
    got = bnb.convert_bnb_linear4bit(packed, ts, dtype=torch.float32, device="cpu")
    np.testing.assert_array_equal(got.dequantize(torch.float32).numpy().T,
                                  bnb.dequantize_bnb(ts, packed))
    assert np.all(np.diff(got.table.numpy()) >= 0)


def write_bnb_dir(path, layers: dict, extra: dict):
    """An HF-serialized bnb checkpoint: per layer the packed nibbles, absmax,
    quant_map, nested tensors and the JSON quant_state tensor."""
    tensors = dict(extra)
    for prefix, (packed, state, quant_type) in layers.items():
        meta = {"quant_type": quant_type, "blocksize": state["blocksize"],
                "shape": list(state["shape"]), "dtype": "bfloat16"}
        tensors[prefix + ".weight"] = packed.reshape(-1, 1)
        tensors[prefix + ".weight.absmax"] = state["absmax"]
        tensors[prefix + ".weight.quant_map"] = state["code"]
        if "nested_code" in state:
            meta.update(nested_blocksize=256, nested_offset=state["offset"])
            tensors[prefix + ".weight.nested_absmax"] = state["nested_absmax"]
            tensors[prefix + ".weight.nested_quant_map"] = state["nested_code"]
        tensors[prefix + f".weight.quant_state.bitsandbytes__{quant_type}"] = np.frombuffer(
            json.dumps(meta).encode(), np.uint8).copy()
    safetensors_io.save_file(tensors, str(path / "model.safetensors"))


def test_load_bnb_checkpoint(tmp_path):
    """A directory with an NF4 (nested) and an FP4 (plain) layer and a dense
    tensor loads in both packages to the same layers."""
    layers = {"model.layers.0.self_attn.q_proj": (*fake_layer(21, "nf4", True), "nf4"),
              "model.layers.0.mlp.up_proj": (*fake_layer(22, "fp4", False), "fp4")}
    norm = np.random.default_rng(3).standard_normal(8).astype(np.float32)
    write_bnb_dir(tmp_path, layers, {"model.norm.weight": norm})
    got = bnb.load_bnb_checkpoint(str(tmp_path), device="cpu")
    want = jbnb.load_bnb_checkpoint(str(tmp_path))
    assert sorted(got) == sorted(want)
    np.testing.assert_array_equal(got["model.norm.weight"].numpy(), norm)
    for prefix, (packed, state, _) in layers.items():
        a, b = want[prefix], got[prefix]
        for pa, pb in zip(a.planes, b.planes):
            np.testing.assert_array_equal(pb.numpy(), np.asarray(pa))
        np.testing.assert_array_equal(b.scales.float().numpy(), np.asarray(a.scales, np.float32))
        np.testing.assert_array_equal(b.table.numpy(), np.asarray(a.table))
        assert b.scales.dtype == torch.bfloat16
        x = torch.from_numpy(np.random.default_rng(4).standard_normal((3, K))).to(torch.bfloat16)
        ref = x.float() @ torch.from_numpy(
            bnb.dequantize_bnb(bnb.BNBQuantState(**state), packed)).T
        y = b(x).float()
        assert (y - ref).abs().max() <= 1.1e-2 * ref.abs().max() * 2
