"""HF checkpoint interop in the port against the JAX package's, on HF
directories written from seeded tiny Llama and Gemma-2 weights by the
port's safetensors writer: ``config_from_hf`` and ``load_hf_params`` give
JAX's configs and bf16 tensors bit for bit; ``quantize_hf_model`` (plain,
4 and 3 bits, and ``fake``) and ``quantize_hf_model_streaming`` (plain,
fused, Gemma-2) write JAX's checkpoint files byte for byte, but for the
manifest's ``config_key`` strings, whose block fields are TPU tiles that
the port does not derive (their chunk agrees); the port's streaming and
in-memory products agree file for file; a local directory resolves as it
is and a hub repo id through ``huggingface_hub.snapshot_download``
(stubbed, as in JAX's test)."""

import dataclasses
import filecmp
import json
import os

import numpy as np
import pytest
import torch
from test_torch_llama import to_numpy_tree

from flute_tpu.integrations import huggingface as jhf
from flute_tpu.models import gemma2 as jgemma2
from flute_tpu.models import llama as jllama
from flute_tpu_torch.integrations import huggingface as hf
from flute_tpu_torch.integrations import safetensors_io
from flute_tpu_torch.models import gemma2, llama
from flute_tpu_torch.nn import QuantizedLinear

HF_NAMES = {"q": "self_attn.q_proj", "k": "self_attn.k_proj", "v": "self_attn.v_proj",
            "o": "self_attn.o_proj", "gate": "mlp.gate_proj", "up": "mlp.up_proj",
            "down": "mlp.down_proj"}
GEMMA2_NORMS = {"attn_norm": "input_layernorm", "post_attn_norm": "post_attention_layernorm",
                "mlp_norm": "pre_feedforward_layernorm",
                "post_mlp_norm": "post_feedforward_layernorm"}


def hf_config(config, model_type="llama") -> dict:
    c = config
    out = {"model_type": model_type, "vocab_size": c.vocab_size, "hidden_size": c.hidden_size,
           "intermediate_size": c.intermediate_size, "num_hidden_layers": c.num_layers,
           "num_attention_heads": c.num_heads, "num_key_value_heads": c.num_kv_heads,
           "head_dim": c.head_dim, "rms_norm_eps": c.rms_norm_eps, "rope_theta": c.rope_theta}
    if model_type == "gemma2":
        out.update(query_pre_attn_scalar=c.query_pre_attn_scalar,
                   attn_logit_softcapping=c.attn_logit_softcap,
                   final_logit_softcapping=c.final_logit_softcap,
                   sliding_window=c.sliding_window)
    else:
        out["tie_word_embeddings"] = c.tie_word_embeddings
        out["rope_scaling"] = None if c.rope_scaling_factor is None else {
            "rope_type": "llama3", "factor": c.rope_scaling_factor,
            "low_freq_factor": c.rope_low_freq_factor,
            "high_freq_factor": c.rope_high_freq_factor,
            "original_max_position_embeddings": c.rope_original_max_position}
    return out


def write_hf_dir(path, config, params, model_type="llama", dtype=torch.float32):
    """An HF checkpoint directory (``config.json`` and ``model.safetensors``,
    ``[out, in]`` linear weights in ``dtype``) of a params tree of numpy or
    torch tensors in the port's layout (linear leaves ``[in, out]``)."""
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(hf_config(config, model_type), f)

    def t(a, transpose=False):
        a = torch.as_tensor(np.asarray(a, np.float32)) if not isinstance(a, torch.Tensor) else a
        a = a.to(dtype)
        return a.T.contiguous() if transpose else a

    tensors = {"model.embed_tokens.weight": t(params["embed"]),
               "model.norm.weight": t(params["final_norm"])}
    if params.get("lm_head") is not None:
        tensors["lm_head.weight"] = t(params["lm_head"], transpose=True)
    norms = GEMMA2_NORMS if model_type == "gemma2" else {
        "attn_norm": "input_layernorm", "mlp_norm": "post_attention_layernorm"}
    for li, layer in enumerate(params["layers"]):
        pre = f"model.layers.{li}."
        for key, name in norms.items():
            tensors[pre + name + ".weight"] = t(layer[key])
        for key, name in HF_NAMES.items():
            tensors[pre + name + ".weight"] = t(layer[key], transpose=True)
    safetensors_io.save_file(tensors, os.path.join(path, "model.safetensors"))


def jax_tiny(family="llama"):
    if family == "gemma2":
        c = jgemma2.Gemma2Config.tiny()
        return c, jgemma2.init_params(c, rng=3)
    c = dataclasses.replace(jllama.LlamaConfig.tiny(), rope_scaling_factor=None)
    return c, jllama.init_params(c, rng=0)


@pytest.fixture(scope="module")
def llama_dir(tmp_path_factory):
    config, params = jax_tiny()
    d = str(tmp_path_factory.mktemp("hf_llama"))
    write_hf_dir(d, config, to_numpy_tree(params))
    return d


@pytest.fixture(scope="module")
def gemma2_dir(tmp_path_factory):
    config, params = jax_tiny("gemma2")
    d = str(tmp_path_factory.mktemp("hf_gemma2"))
    write_hf_dir(d, config, to_numpy_tree(params), model_type="gemma2")
    return d


def same_checkpoint(a, b):
    """Every file of two checkpoint directories byte-equal, but the
    manifests' config keys, whose chunks must agree."""
    cmp = filecmp.dircmp(a, b)
    assert cmp.left_only == [] and cmp.right_only == [], (cmp.left_only, cmp.right_only)
    _, mismatch, errors = filecmp.cmpfiles(a, b, cmp.common_files, shallow=False)
    assert [f for f in mismatch if f != "manifest.json"] == [] and errors == []
    with open(os.path.join(a, "manifest.json")) as f:
        ma = json.load(f)
    with open(os.path.join(b, "manifest.json")) as f:
        mb = json.load(f)
    for ea, eb in zip(ma["entries"], mb["entries"]):
        ka, kb = ea.pop("config_key", None), eb.pop("config_key", None)
        assert (ka is None) == (kb is None)
        if ka is not None:
            assert ka.split("_c")[1] == kb.split("_c")[1]  # the chunk
    assert ma == mb


def test_resolve_model_path(tmp_path, monkeypatch):
    d = str(tmp_path / "local")
    os.makedirs(d)
    assert hf.resolve_model_path(d) == d
    for bad in ("/no/such/directory", "not-a-repo-id"):
        with pytest.raises(FileNotFoundError):
            hf.resolve_model_path(bad)
    calls = {}

    def fake_snapshot_download(repo_id, revision=None, cache_dir=None, allow_patterns=None):
        calls["repo_id"], calls["revision"] = repo_id, revision
        return d

    import huggingface_hub

    monkeypatch.setattr(huggingface_hub, "snapshot_download", fake_snapshot_download)
    assert hf.resolve_model_path("acme/tiny-w4", revision="main") == d
    assert calls == {"repo_id": "acme/tiny-w4", "revision": "main"}


@pytest.mark.parametrize("family", ["llama", "gemma2"])
def test_config_and_params_match(family, llama_dir, gemma2_dir):
    d = llama_dir if family == "llama" else gemma2_dir
    got, want = hf.config_from_hf(d), jhf.config_from_hf(d)
    fields = {f.name for f in dataclasses.fields(got)} - {"dtype"}
    assert {n: getattr(got, n) for n in fields} == {n: getattr(want, n) for n in fields}
    assert got.dtype == torch.bfloat16
    tp, jp = hf.load_hf_params(d, got, device="cpu"), jhf.load_hf_params(d, want)
    jnp_tree = to_numpy_tree(jp)
    assert sorted(tp) == sorted(jnp_tree) and ("lm_head" in tp) == (family == "llama")
    for key in ("embed", "final_norm"):
        assert torch.equal(tp[key].float(), torch.from_numpy(np.asarray(jnp_tree[key], np.float32)))
    for tl, jl in zip(tp["layers"], jnp_tree["layers"]):
        assert sorted(tl) == sorted(jl)
        for key in tl:
            assert tl[key].dtype == torch.bfloat16 and tl[key].is_contiguous()
            np.testing.assert_array_equal(tl[key].float().numpy(), np.asarray(jl[key], np.float32))


def test_quantized_from_hf_serves(llama_dir, tmp_path):
    """quantize_hf_model then load_quantized_model: the layers are
    quantize_model's on the loaded params, and the model runs."""
    out = str(tmp_path / "q")
    hf.quantize_hf_model(llama_dir, out, 4, 64, device="cpu")
    qparams, config, sidecar = hf.load_quantized_model(out, device="cpu")
    assert sidecar["num_bits"] == 4 and config.rope_scaling_factor is None
    direct = llama.quantize_model(hf.load_hf_params(llama_dir, device="cpu"), 4, 64,
                                  device="cpu")
    for a, b in zip(direct["layers"], qparams["layers"]):
        for key in HF_NAMES:
            assert isinstance(b[key], QuantizedLinear) and b[key].layout == "w4sym"
            for pa, pb in zip(a[key].planes, b[key].planes):
                assert torch.equal(pa, pb)
    cache = llama.init_cache(config, 1, 8, device="cpu")
    logits, _ = llama.forward(qparams, config, torch.tensor([[1, 2, 3]]), cache, 0)
    assert torch.isfinite(logits).all()


@pytest.mark.parametrize("num_bits,fake", [(4, False), (3, False), (4, True)])
def test_quantize_hf_model_writes_jax_files(llama_dir, tmp_path, num_bits, fake):
    hf.quantize_hf_model(llama_dir, str(tmp_path / "port"), num_bits, 64, fake=fake,
                         device="cpu")
    jhf.quantize_hf_model(llama_dir, str(tmp_path / "jax"), num_bits, 64, fake=fake)
    same_checkpoint(str(tmp_path / "port"), str(tmp_path / "jax"))


@pytest.mark.parametrize("family,num_bits,fuse", [("llama", 4, False), ("llama", 3, False),
                                                  ("llama", 4, True), ("gemma2", 4, False)])
def test_streaming_writes_jax_files(llama_dir, gemma2_dir, tmp_path, family, num_bits, fuse):
    d = llama_dir if family == "llama" else gemma2_dir
    stats = hf.quantize_hf_model_streaming(d, str(tmp_path / "port"), num_bits, 64, fuse=fuse,
                                           device="cpu")
    jstats = jhf.quantize_hf_model_streaming(d, str(tmp_path / "jax"), num_bits, 64, fuse=fuse)
    assert stats == jstats and stats["buffered_high_water"] <= (5 if fuse else 1)
    same_checkpoint(str(tmp_path / "port"), str(tmp_path / "jax"))
    if not fuse:
        # the port's in-memory product: the same .npy files
        hf.quantize_hf_model(d, str(tmp_path / "mem"), num_bits, 64, device="cpu")
        files = [f for f in os.listdir(tmp_path / "mem") if f.endswith(".npy")]
        assert sorted(files) == sorted(f for f in os.listdir(tmp_path / "port")
                                       if f.endswith(".npy"))
        _, mismatch, errors = filecmp.cmpfiles(str(tmp_path / "mem"), str(tmp_path / "port"),
                                               files, shallow=False)
        assert mismatch == [] and errors == []
    params, config, _ = hf.load_quantized_model(str(tmp_path / "port"), device="cpu")
    fwd, init_cache = hf.model_fns(family)
    assert fwd is (gemma2.forward if family == "gemma2" else llama.forward)
    logits, _ = fwd(params, config, torch.tensor([[1, 2, 3]]), init_cache(config, 1, 8,
                                                                          device="cpu"), 0)
    assert torch.isfinite(logits).all()


def test_load_quantized_model_from_hub_repo_id(llama_dir, tmp_path, monkeypatch):
    out = str(tmp_path / "quant")
    hf.quantize_hf_model(llama_dir, out, 4, 64, device="cpu")
    calls = {}

    def fake_snapshot_download(repo_id, revision=None, cache_dir=None, allow_patterns=None):
        calls["repo_id"] = repo_id
        return out

    import huggingface_hub

    monkeypatch.setattr(huggingface_hub, "snapshot_download", fake_snapshot_download)
    params, config, sidecar = hf.load_quantized_model("acme/tiny-w4", device="cpu")
    assert calls["repo_id"] == "acme/tiny-w4"
    assert sidecar["num_bits"] == 4 and config.hidden_size == 256
    assert isinstance(params["layers"][0]["q"], QuantizedLinear)
