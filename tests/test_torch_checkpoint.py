"""Quantized checkpoints cross between the JAX package and the port.

A tiny quantized Llama (fused, ``LlamaConfig.tiny()``) with one extra HIGGS-
style layer that looks its values up in a joint pair table is saved by
``flute_tpu.integrations.checkpoint.save_quantized`` and loaded by the port,
and the other way round; planes, scales, tables and pair tables must come
back bit for bit and the logits (and the pair layer's output) within the
bf16 threshold of JAX's (1.1e-2 of the largest value). Saved from the same
params, both packages write the same manifest and sidecar and byte-identical
``.npy`` files. Covered layouts: w4sym, w3wide, plane W2 and plane W4.
"""

import filecmp
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_llama import _jax_logits, _port_logits, max_rel, to_numpy_tree

from flute_tpu import nn as jnn
from flute_tpu.integrations import checkpoint as jcheckpoint
from flute_tpu.models import llama as jllama
from flute_tpu_torch import interop
from flute_tpu_torch.integrations import checkpoint
from flute_tpu_torch.models import llama
from flute_tpu_torch.nn import QuantizedLinear

BF16_RTOL = 1.1e-2
SCHEMES = {
    "w4sym": dict(num_bits=4),
    "w3wide": dict(num_bits=3),
    "w2": dict(num_bits=2),
    "w4_general": dict(num_bits=4, symmetric=False),
}
K, N, G = 256, 128, 64


def pair_layer():
    rng = np.random.default_rng(11)
    codes = rng.integers(0, 4, size=(K, N), dtype=np.int32)
    scales = rng.uniform(0.5, 1.5, (K // G, N)).astype(np.float32)
    pv = rng.standard_normal((4, 4, 2)).astype(np.float32)
    bias = rng.standard_normal(N).astype(np.float32)
    return jnn.from_codes(jnp.asarray(codes), jnp.asarray(scales, jnp.bfloat16), None, 2, G,
                          pair_values=jnp.asarray(pv), bias=jnp.asarray(bias))


@pytest.fixture(scope="module", params=list(SCHEMES))
def saved(request, tmp_path_factory):
    """JAX params, the same params in the port, both saved, and JAX's logits."""
    jconfig = jllama.LlamaConfig.tiny()
    kw = SCHEMES[request.param]
    jq = jllama.quantize_model(jllama.init_params(jconfig, rng=0), group_size=G, fuse=True, **kw)
    jq["pair"] = pair_layer()
    tq = interop.params_from_numpy(to_numpy_tree(jq), device="cpu")
    root = tmp_path_factory.mktemp(request.param)
    meta = dict(model_config={"name": "tiny"}, num_bits=kw["num_bits"], group_size=G)
    jcheckpoint.save_quantized(str(root / "jax"), jq, **meta)
    checkpoint.save_quantized(str(root / "port"), tq, **meta)
    rng = np.random.default_rng(3)
    inputs = dict(
        tokens=rng.integers(0, jconfig.vocab_size, (2, 16)).astype(np.int64),
        offsets=np.array([0, 5], np.int64),
        nxt=rng.integers(0, jconfig.vocab_size, (2, 1)).astype(np.int64),
        pos_vec=None,
    )
    x = rng.standard_normal((3, K)).astype(np.float32)
    want = _jax_logits(jq, jconfig, **inputs) + (
        np.asarray(jq["pair"](jnp.asarray(x, jnp.bfloat16)), np.float32),)
    return jq, root, inputs, x, want


def port_outputs(tq, inputs, x):
    pre, dec = _port_logits(tq, llama.LlamaConfig.tiny(), **inputs)
    return pre, dec, tq["pair"](torch.from_numpy(x).bfloat16()).float()


def assert_outputs_close(got, want, offsets):
    pre, dec, pair = got
    jpre, jdec, jpair = want
    assert max_rel(pre[:, offsets[1]:], jpre[:, offsets[1]:]) < BF16_RTOL
    assert max_rel(dec, jdec) < BF16_RTOL
    assert max_rel(pair, jpair) < BF16_RTOL


def quantized_leaves(tree, path=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from quantized_leaves(v, f"{path}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from quantized_leaves(v, f"{path}/{i}")
    elif isinstance(tree, (QuantizedLinear, jnn.QuantizedLinear)):
        yield path, tree


def f32(a):
    return a.float().numpy() if isinstance(a, torch.Tensor) else np.asarray(a, np.float32)


def assert_same_leaves(port_tree, jax_tree):
    port = dict(quantized_leaves(port_tree))
    jax = dict(quantized_leaves(jax_tree))
    assert set(port) == set(jax) and len(port) > 1
    for path, tl in port.items():
        jl = jax[path]
        assert (tl.layout, tl.num_bits, tl.group_size, tl.config_key) == (
            jl.layout, jl.num_bits, jl.group_size, jl.config_key)
        assert len(tl.planes) == len(jl.planes)
        for p, q in zip(tl.planes, jl.planes):
            np.testing.assert_array_equal(p.numpy(), np.asarray(q))
        for name in ("scales", "table", "pair_values", "bias"):
            a, b = getattr(tl, name), getattr(jl, name)
            assert (a is None) == (b is None), name
            if a is not None:
                np.testing.assert_array_equal(f32(a), f32(b))
    assert port["/pair"].pair_values is not None


def test_jax_checkpoint_loads_in_port(saved):
    jq, root, inputs, x, want = saved
    tq, sidecar = checkpoint.load_quantized(str(root / "jax"), device="cpu")
    assert sidecar["model_config"] == {"name": "tiny"} and sidecar["group_size"] == G
    assert isinstance(tq["layers"], list) and len(tq["layers"]) == 2
    assert tq["embed"].dtype == torch.bfloat16
    np.testing.assert_array_equal(f32(tq["embed"]), f32(jq["embed"]))
    assert_same_leaves(tq, jq)
    assert_outputs_close(port_outputs(tq, inputs, x), want, inputs["offsets"])


def test_port_checkpoint_loads_in_jax(saved):
    jq, root, inputs, x, want = saved
    jq2, sidecar = jcheckpoint.load_quantized(str(root / "port"))
    assert sidecar["num_bits"] == jq["layers"][0]["o"].num_bits
    assert_same_leaves(interop.params_from_numpy(to_numpy_tree(jq2), device="cpu"), jq)
    jconfig = jllama.LlamaConfig.tiny()
    got = _jax_logits(jq2, jconfig, **inputs) + (
        np.asarray(jq2["pair"](jnp.asarray(x, jnp.bfloat16)), np.float32),)
    for a, b in zip(got, want):  # the same params: JAX gives the same numbers
        np.testing.assert_array_equal(a, b)
    # and the port's own round trip reads back what it wrote
    tq, _ = checkpoint.load_quantized(str(root / "port"), device="cpu")
    assert_outputs_close(port_outputs(tq, inputs, x), want, inputs["offsets"])


def test_both_packages_write_the_same_files(saved):
    _, root, _, _, _ = saved
    jdir, tdir = root / "jax", root / "port"
    assert sorted(os.listdir(jdir)) == sorted(os.listdir(tdir))
    for name in ("manifest.json", "flute_config.json"):
        assert json.loads((jdir / name).read_text()) == json.loads((tdir / name).read_text())
    manifest = json.loads((tdir / "manifest.json").read_text())
    types = {e["type"] for e in manifest["entries"]}
    assert types == {"array", "quantized_linear"}
    refs = [r for e in manifest["entries"] for r in e["tensors"].values()]
    assert any(r.endswith("#bf16") for r in refs)
    npys = [f for f in os.listdir(tdir) if f.endswith(".npy")]
    assert len(npys) == len(refs)
    _, mismatch, errors = filecmp.cmpfiles(jdir, tdir, npys, shallow=False)
    assert not mismatch and not errors


def test_streaming_writer_and_device_default(tmp_path, monkeypatch):
    """StreamingWriter writes what save_quantized writes; load_quantized
    runs on ``cuda`` unless told, so without a GPU it raises."""
    layer = interop.params_from_numpy({"p": to_numpy_tree(pair_layer())}, device="cpu")["p"]
    dense = torch.arange(6, dtype=torch.float32).reshape(2, 3).bfloat16()
    w = checkpoint.StreamingWriter(str(tmp_path / "stream"))
    w.add_array("embed", dense)
    w.add_quantized("layers/0/o", layer.planes, layer.scales, layer.table, num_bits=2,
                    group_size=G, config_key=layer.config_key, bias=layer.bias)
    w.finish(num_bits=2, group_size=G)
    jw = jcheckpoint.StreamingWriter(str(tmp_path / "jax_stream"))
    jw.add_array("embed", jnp.asarray(dense.float().numpy(), jnp.bfloat16))
    jw.add_quantized("layers/0/o", [np.asarray(p) for p in layer.planes],
                     jnp.asarray(layer.scales.float().numpy(), jnp.bfloat16),
                     layer.table.numpy(), num_bits=2, group_size=G,
                     config_key=layer.config_key, bias=layer.bias.numpy())
    jw.finish(num_bits=2, group_size=G)
    for name in os.listdir(tmp_path / "jax_stream"):
        assert filecmp.cmp(tmp_path / "jax_stream" / name, tmp_path / "stream" / name,
                           shallow=False), name
    tree, _ = checkpoint.load_quantized(str(tmp_path / "stream"), device="cpu")
    assert torch.equal(tree["embed"], dense)
    got = tree["layers"][0]["o"]
    assert got.pair_values is None and torch.equal(got.planes[0], layer.planes[0])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        checkpoint.load_quantized(str(tmp_path / "stream"))
