"""The port's perplexity (``flute_tpu_torch.eval``) against the JAX
package's (``flute_tpu/eval.py``) on tiny Llama and tiny Gemma-2 at
``seq_len`` 32, and the contracts of ``tests/test_eval.py`` in the port.

The same dense params (carried over by ``interop.params_from_numpy``) and
the same tokens, dense, quantized, and quantized with the head:

* in f32 (the tiny configs with ``dtype`` f32) the two perplexities agree
  within 1e-6 relative (measured: 2.4e-7 at most): the protocol itself
  (windows, targets, the f32 log-softmax, the mean) is the same;
* in bf16 they agree within 1e-3 relative (measured: 1.2e-4 to 3.4e-4).
  bf16 roundings in the residual stream move the logits by about 0.6% of
  the largest one between any two evaluation orders: JAX's own eager
  forward and the jitted forward that ``flute_tpu.eval`` runs differ by
  that much, and by 6e-5 in one window's mean NLL.

In the port alone: quantized within 5% of dense, batched equal to
unbatched within 1e-3, remainder windows at batch 1, trailing tokens
ignored; too few tokens raise; the entry point runs on ``cuda`` unless
asked for the CPU.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_gemma2 import group_order_plain
from test_torch_llama import to_numpy_tree

from flute_tpu import eval as jeval
from flute_tpu.models import gemma2 as jgemma2
from flute_tpu.models import llama as jllama
from flute_tpu_torch import eval as teval
from flute_tpu_torch import interop
from flute_tpu_torch.models import gemma2, llama
from flute_tpu_torch.ops import lut_gemm

SEQ = 32
FAMILIES = {"llama": (jllama, llama, "LlamaConfig"), "gemma2": (jgemma2, gemma2, "Gemma2Config")}
# the dtypes compared with JAX, and their tolerance on the perplexity
PPL_RTOL = {"float32": 1e-6, "bfloat16": 1e-3}


@pytest.fixture(autouse=True, scope="module")
def few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def tokens(config):
    return np.random.default_rng(0).integers(0, config.vocab_size, 3 * SEQ).astype(np.int32)


def configs(name, dtype="bfloat16"):
    jmod, mod, cls = FAMILIES[name]
    jconfig, config = getattr(jmod, cls).tiny(), getattr(mod, cls).tiny()
    if dtype == "float32":
        jconfig = dataclasses.replace(jconfig, dtype=jnp.float32)
        config = dataclasses.replace(config, dtype=torch.float32)
    return jmod, mod, jconfig, config


@pytest.fixture(scope="module", params=list(FAMILIES))
def family(request):
    jmod, mod, jconfig, config = configs(request.param)
    jparams = jmod.init_params(jconfig, rng=0)
    return dict(jmod=jmod, mod=mod, jconfig=jconfig, config=config, jparams=jparams,
                dense=interop.params_from_numpy(to_numpy_tree(jparams), device="cpu"),
                toks=tokens(config))


def port_ppl(params, config, toks, **kw):
    return teval.perplexity(params, config, toks, seq_len=SEQ, device="cpu", **kw)


@pytest.fixture(scope="module", params=[(f, d) for d in PPL_RTOL for f in FAMILIES],
                ids=lambda p: "-".join(p))
def jax_variants(request):
    """JAX's params of a family in a dtype, dense, quantized (W4G64) and
    quantized with the head (the same blocks: one quantization), and JAX's
    perplexity of each."""
    name, dtype = request.param
    jmod, mod, jconfig, config = configs(name, dtype)
    dense = jmod.init_params(jconfig, rng=0)
    qhead = jmod.quantize_model(dense, 4, 64, quantize_lm_head=True)
    quant = {k: v for k, v in qhead.items() if k != "lm_head"}
    if "lm_head" in dense:
        quant["lm_head"] = dense["lm_head"]
    toks = tokens(config)
    variants = {"dense": dense, "quantized": quant, "quantized head": qhead}
    want = {v: jeval.perplexity(p, jconfig, toks, seq_len=SEQ) for v, p in variants.items()}
    return dict(config=config, dtype=dtype, toks=toks, params=variants, want=want)


@pytest.mark.parametrize("variant", ["dense", "quantized", "quantized head"])
def test_perplexity_matches_jax(jax_variants, variant, monkeypatch):
    if jax_variants["dtype"] == "bfloat16":  # sum the LUT-GEMM as JAX's kernel does
        monkeypatch.setattr(lut_gemm, "lut_qgemm_plain", group_order_plain)
    params = interop.params_from_numpy(to_numpy_tree(jax_variants["params"][variant]),
                                       device="cpu")
    got = port_ppl(params, jax_variants["config"], jax_variants["toks"])
    want = jax_variants["want"][variant]
    assert np.isfinite(got) and got > 1
    assert abs(got - want) / want < PPL_RTOL[jax_variants["dtype"]], (got, want)


def test_quantization_is_close(family):
    """W4G64 (the head too) moves a random tiny model's perplexity by under
    5% (``tests/test_eval.py``), with the port's own plain version."""
    mod, config, toks = family["mod"], family["config"], family["toks"]
    dense = port_ppl(family["dense"], config, toks)
    for head in (False, True):
        q = mod.quantize_model(family["dense"], 4, 64, quantize_lm_head=head, device="cpu")
        assert abs(port_ppl(q, config, toks) - dense) / dense < 0.05


@pytest.mark.parametrize("batch_size", [2, 3])
def test_batched_matches_unbatched(family, batch_size):
    """Three windows at batch 2 (one remainder window at batch 1) and at
    batch 3 give the batch-1 perplexity."""
    config, toks = family["config"], family["toks"]
    p1 = port_ppl(family["dense"], config, toks)
    assert abs(port_ppl(family["dense"], config, toks, batch_size=batch_size) - p1) / p1 < 1e-3


def test_windows_and_remainder_tokens(family):
    """Only whole windows are scored: trailing tokens change nothing; and a
    window's perplexity is the exponent of its mean next-token NLL."""
    config, toks, params = family["config"], family["toks"], family["dense"]
    ppl = port_ppl(params, config, toks)
    assert port_ppl(params, config, np.concatenate([toks, toks[:SEQ - 1]])) == ppl
    nll = []
    for w in toks.reshape(3, SEQ):
        cache = family["mod"].init_cache(config, 1, SEQ, device="cpu")
        with torch.inference_mode():
            logits = family["mod"].forward(params, config, torch.tensor(w[None, :-1]), cache,
                                           0)[0]
        logp = torch.log_softmax(logits.double(), -1)[0]
        nll.append(-logp[torch.arange(SEQ - 1), torch.tensor(w[1:]).long()])
    assert abs(float(torch.cat(nll).mean().exp()) - ppl) / ppl < 1e-6


def test_too_few_tokens_raise():
    config = llama.LlamaConfig.tiny()
    with pytest.raises(ValueError, match="need at least 32 tokens, got 31"):
        teval.perplexity({}, config, np.zeros(31, np.int32), seq_len=32, device="cpu")


def test_cache_dispatch():
    g = teval.llama_init_cache_like(gemma2.Gemma2Config.tiny(), 2, 16, device="cpu")
    k = teval.llama_init_cache_like(llama.LlamaConfig.tiny(), 2, 16, device="cpu")["k"]
    assert len(g["k"]) == len(k) == 2 and tuple(k[0].shape) == (2, 2, 16, 128)


def test_runs_on_cuda_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        teval.perplexity({}, llama.LlamaConfig.tiny(), np.zeros(64, np.int32), seq_len=32)
