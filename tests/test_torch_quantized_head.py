"""The quantized lm_head (``quantize_model(quantize_lm_head=True)``) of the
port's Llama and Gemma-2 against the JAX package's, and the model presets.

* The head's planes, scales and table equal JAX's bit for bit (tiny Llama:
  its dense ``[hidden, 512]`` head padded to 2048 out-features; tiny
  Gemma-2: a padded copy of the tied embedding), at chunk 128 as
  ``tests/test_quantized_head.py`` quantizes it, and at the default chunk.
* The logits with the quantized head lie within the bf16 threshold of
  JAX's (the LUT-GEMM's plain version patched to sum as JAX's kernel does,
  as ``tests/test_torch_gemma2.py`` holds quantized logits), and within
  0.15 of the largest dense-head logit (the contract of
  ``tests/test_quantized_head.py``).
* ``forward``, ``PagedEngine`` and ``ContinuousBatchingEngine`` all slice
  the padded head's logits back to the vocabulary.
* The Llama presets (five) and the Gemma-2 presets (two) equal JAX's,
  field for field.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_gemma2 import group_order_plain
from test_torch_llama import assert_same_quantized, max_rel, to_numpy_tree

from flute_tpu.models import gemma2 as jgemma2
from flute_tpu.models import llama as jllama
from flute_tpu_torch import interop
from flute_tpu_torch.models import gemma2, llama
from flute_tpu_torch.nn import QuantizedLinear
from flute_tpu_torch.ops import lut_gemm
from flute_tpu_torch.serving import ContinuousBatchingEngine, PagedEngine

BF16_RTOL = 1.1e-2
HEAD_CONTRACT = 0.15  # tests/test_quantized_head.py:30
FAMILIES = {"llama": (jllama, llama, "LlamaConfig"), "gemma2": (jgemma2, gemma2, "Gemma2Config")}


@pytest.fixture(scope="module", params=list(FAMILIES))
def family(request):
    """JAX's tiny params of a family, the same dense params in the port, and
    both packages' models with the quantized head at chunk 128."""
    jmod, mod, cls = FAMILIES[request.param]
    jconfig, config = getattr(jmod, cls).tiny(), getattr(mod, cls).tiny()
    jparams = jmod.init_params(jconfig, rng=0)
    dense = interop.params_from_numpy(to_numpy_tree(jparams), device="cpu")
    jq = jmod.quantize_model(jparams, 4, 64, chunk=128, quantize_lm_head=True)
    tq = mod.quantize_model(dense, 4, 64, chunk=128, quantize_lm_head=True, device="cpu")
    return dict(name=request.param, jmod=jmod, mod=mod, jconfig=jconfig, config=config,
                jparams=jparams, dense=dense, jq=jq, tq=tq)


def test_head_planes_equal_jax(family):
    head = family["tq"]["lm_head"]
    assert isinstance(head, QuantizedLinear)
    assert head.scales.shape[1] == 2048  # vocab 512 padded to a multiple of 2048
    assert_same_quantized(head, family["jq"]["lm_head"])
    for jl, tl in zip(family["jq"]["layers"], family["tq"]["layers"]):
        for key in ("q", "o", "down"):
            assert_same_quantized(tl[key], jl[key])
    # the dense embedding stays, for the input lookups
    assert torch.equal(family["tq"]["embed"], family["dense"]["embed"])


def test_head_planes_equal_jax_at_the_default_chunk(family):
    jq = family["jmod"].quantize_model(family["jparams"], 4, 64, quantize_lm_head=True)
    tq = family["mod"].quantize_model(family["dense"], 4, 64, quantize_lm_head=True,
                                      device="cpu")
    assert_same_quantized(tq["lm_head"], jq["lm_head"])


def test_pad_rows():
    w = torch.ones((5, 3))
    assert torch.equal(llama.pad_rows(w, 4), torch.cat([w, w.new_zeros((3, 3))]))
    assert llama.pad_rows(w, 5) is w
    assert llama.pad_rows(torch.ones((128256, 2))).shape[0] == 129024


def test_no_head_to_quantize():
    """A tied Llama (no dense head) keeps its tied head."""
    config = dataclasses.replace(llama.LlamaConfig.tiny(), tie_word_embeddings=True)
    params = llama.init_params(config, seed=0, device="cpu")
    q = llama.quantize_model(params, 4, 64, quantize_lm_head=True, device="cpu")
    assert q["lm_head"] is None


def _logits(mod, params, config, tokens):
    cache = mod.init_cache(config, 1, 8, device="cpu")
    with torch.inference_mode():
        return mod.forward(params, config, torch.from_numpy(tokens), cache, 0)[0]


def _jax_logits(jmod, params, jconfig, tokens):
    cache = jmod.init_cache(jconfig, 1, 8)
    return np.asarray(jmod.forward(params, jconfig, jnp.asarray(tokens, jnp.int32), cache,
                                   jnp.int32(0))[0])


TOKENS = np.array([[1, 2, 3, 4]], np.int64)


def test_logits_match_jax(family, monkeypatch):
    config = family["config"]
    want = _jax_logits(family["jmod"], family["jq"], family["jconfig"], TOKENS)
    got = _logits(family["mod"], family["tq"], config, TOKENS)
    assert got.dtype == torch.float32 and tuple(got.shape) == (1, 4, config.vocab_size)
    assert max_rel(got, want) < 2 * BF16_RTOL
    monkeypatch.setattr(lut_gemm, "lut_qgemm_plain", group_order_plain)
    assert max_rel(_logits(family["mod"], family["tq"], config, TOKENS), want) < BF16_RTOL


def test_head_contract(family):
    """The quantized head moves the logits by under 0.15 of the largest
    dense-head logit, in the port as in JAX."""
    mod, config = family["mod"], family["config"]
    dense_head = mod.quantize_model(family["dense"], 4, 64, chunk=128, device="cpu")
    a1 = _logits(mod, dense_head, config, TOKENS).numpy()
    a2 = _logits(mod, family["tq"], config, TOKENS).numpy()
    assert np.abs(a1 - a2).max() / max(np.abs(a1).max(), 1e-6) < HEAD_CONTRACT


def test_engines_slice_the_padded_head(family):
    """PagedEngine (its own head through ``paged_fwd``) and the continuous
    engine (through ``forward``) give the tokens of the quantized-head
    model's greedy argmax, and never a padded id."""
    mod, config, tq = family["mod"], family["config"], family["tq"]
    prompt = [1, 5, 9]
    with torch.inference_mode():
        cache = mod.init_cache(config, 1, 32, device="cpu")
        toks, pos = list(prompt), 0
        for _ in range(4):
            logits = mod.forward(tq, config, torch.tensor([toks[pos:]]), cache, pos)[0]
            pos = len(toks)
            toks.append(int(logits[0, -1].argmax()))
    want = toks[len(prompt):]
    cont = ContinuousBatchingEngine(params=tq, config=config, num_slots=1, max_len=32,
                                    device="cpu")
    paged = PagedEngine(params=tq, config=config, num_slots=1, block_size=8, num_blocks=6,
                        max_len=32, device="cpu")
    for eng in (cont, paged):
        rid = eng.submit(prompt, max_new_tokens=4)
        assert eng.run()[rid] == want


PRESET_FIELDS = {
    "llama": [f.name for f in dataclasses.fields(llama.LlamaConfig) if f.name != "dtype"],
    "gemma2": [f.name for f in dataclasses.fields(jgemma2.Gemma2Config) if f.name != "dtype"],
}


@pytest.mark.parametrize("cls,preset", [
    ("LlamaConfig", "llama3_8b"), ("LlamaConfig", "llama31_8b"), ("LlamaConfig", "llama31_70b"),
    ("LlamaConfig", "llama31_405b"), ("LlamaConfig", "tiny"),
    ("Gemma2Config", "gemma2_9b"), ("Gemma2Config", "gemma2_27b"),
])
def test_presets_match_jax(cls, preset):
    name = "llama" if cls == "LlamaConfig" else "gemma2"
    jmod, mod, _ = FAMILIES[name]
    want = getattr(getattr(jmod, cls), preset)()
    got = getattr(getattr(mod, cls), preset)()
    for field in PRESET_FIELDS[name]:
        assert getattr(got, field) == getattr(want, field), field
    assert got.dtype == torch.bfloat16
