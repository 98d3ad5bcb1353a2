"""The port's Gemma-2 against the JAX package's on ``Gemma2Config.tiny()``.

The JAX package makes (and quantizes) the params; they reach the port as a
numpy tree through ``interop.params_from_numpy``. The port runs its plain
versions on the CPU, the JAX package its Pallas kernels in interpret mode.
Tolerance: 1.1e-2 of the largest logit (bf16). Held here:

* the config presets field for field; ``rms_norm_gemma``, and
  ``gqa_attention`` with Gemma-2's logit softcap and query scale;
* ``forward`` prefill and decode, left-padded, with an int, a 0-dim tensor
  and a per-sequence ``pos``, dense and w4sym-quantized, fused and unfused;
  the port's quantizer gives JAX's leaves. The quantized logits are held
  to the threshold with the LUT-GEMM's plain version summing as JAX's
  kernel does (``group_order_plain``); with the port's own plain version,
  which rounds each dequantized weight to bf16 before the product, to twice
  it: that rounding alone moves the tiny model's logits by 1.35e-2, against
  5.1e-3 in JAX's order (the dense logits agree to 2e-7);
* the sliding window: a token out of every sliding layer's window does not
  move the last position's logits (bit-equal), as ``tests/test_gemma2.py``
  holds for JAX;
* ``Engine`` teacher-forced on JAX's greedy tokens (logits within the
  threshold) and its own greedy tokens equal to JAX's before the first
  near-tie; ``PagedEngine`` with dense and pool prefill against JAX's
  ``PagedEngine``, decode crossing the tiny window of 8;
* a checkpoint round trip (bit-equal logits), and ``quantize_lm_head``
  refused.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_llama import f32, max_rel, to_numpy_tree

from flute_tpu.models import gemma2 as jgemma2
from flute_tpu.models import llama as jllama
from flute_tpu.nn import QuantizedLinear as JQuantizedLinear
from flute_tpu.serving import Engine as JEngine
from flute_tpu.serving.paged import PagedEngine as JPagedEngine
from flute_tpu_torch import interop
from flute_tpu_torch.integrations import checkpoint
from flute_tpu_torch.models import gemma2, llama
from flute_tpu_torch.nn import QuantizedLinear
from flute_tpu_torch.ops import lut_gemm
from flute_tpu_torch.serving import Engine, PagedEngine

BF16_RTOL = 1.1e-2
BATCH, MAX_LEN, NEW_TOKENS = 3, 64, 8
PROMPTS = [[3, 17, 42, 9], [11, 5, 8, 1, 13, 2], [7, 30, 2, 19, 44, 6, 21, 12, 8, 3, 9]]


@pytest.fixture(autouse=True, scope="module")
def few_torch_threads():
    """Many small CPU ops beside the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def group_order_plain(x2, planes, scales, table, *, num_bits, chunk, layout, pair_values=None):
    """The LUT-GEMM as JAX's kernel sums it at decode and prefill alike
    (``flute_tpu/ops/lut_gemm.py:590-602``, group-scaled accumulation): per
    scale group, ``x`` times the table values (rounded to x's dtype) summed
    in f32, then multiplied by the group's scale in f32; one rounding at the
    end."""
    assert pair_values is None
    codes = lut_gemm._packing.unpack(list(planes), num_bits, chunk=chunk, layout=layout)
    values = table.to(x2.dtype).float()[codes.long()]
    g = codes.shape[0] // scales.shape[0]
    acc = torch.zeros((x2.shape[0], values.shape[1]))
    for i in range(scales.shape[0]):
        rows = slice(i * g, (i + 1) * g)
        acc += (x2[:, rows].float() @ values[rows]) * scales[i].float()
    return acc.to(x2.dtype)


@pytest.fixture(scope="module")
def tiny():
    jconfig = jgemma2.Gemma2Config.tiny()
    return jconfig, gemma2.Gemma2Config.tiny(), jgemma2.init_params(jconfig, rng=0)


@pytest.fixture(scope="module", params=[False, True], ids=["unfused", "fused"])
def quantized(request, tiny):
    jconfig, config, jparams = tiny
    jq = jgemma2.quantize_model(jparams, num_bits=4, group_size=64, fuse=request.param)
    return jconfig, config, jq, interop.params_from_numpy(to_numpy_tree(jq), device="cpu")


def test_config_presets_match_jax():
    for name in ("gemma2_9b", "gemma2_27b", "tiny"):
        j = getattr(jgemma2.Gemma2Config, name)()
        t = getattr(gemma2.Gemma2Config, name)()
        fields = [f.name for f in dataclasses.fields(j)]
        assert fields == [f.name for f in dataclasses.fields(t)]
        for field in fields:
            if field == "dtype":
                assert str(t.dtype).split(".")[-1] == jnp.dtype(j.dtype).name
            else:
                assert getattr(t, field) == getattr(j, field), (name, field)
    assert gemma2.Gemma2Config.gemma2_9b().vocab_size == 256128
    config = gemma2.Gemma2Config.gemma2_9b()
    assert gemma2.embed_scale(config) == 59.75  # sqrt(3584) = 59.866 in bf16
    np.testing.assert_array_equal(llama._rope_inv_freq(config),
                                  jllama._rope_inv_freq(jgemma2.Gemma2Config()))


@pytest.mark.parametrize("softcap", [None, 50.0])
def test_norm_and_softcapped_attention_match_jax(softcap):
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 3, 256)).astype(np.float32)
    w = rng.uniform(-0.5, 0.5, 256).astype(np.float32)
    got = gemma2.rms_norm_gemma(torch.from_numpy(x).bfloat16(), torch.from_numpy(w).bfloat16(),
                                1e-6)
    want = jgemma2.rms_norm_gemma(jnp.asarray(x, jnp.bfloat16), jnp.asarray(w, jnp.bfloat16),
                                  1e-6)
    assert max_rel(got, want) < BF16_RTOL
    # scores large enough that the cap bites: the query scale 256 ** -0.5
    # of a head_dim of 128 (the tiny config), not 128 ** -0.5
    b, t, h, hkv, s, d = 2, 5, 4, 2, 12, 128
    q = rng.standard_normal((b, t, h, d)).astype(np.float32) * 6
    k = rng.standard_normal((b, hkv, s, d)).astype(np.float32) * 6
    v = rng.standard_normal((b, hkv, s, d)).astype(np.float32)
    mask = rng.random((b, t, s)) < 0.7
    mask[..., 0] = True
    kw = dict(scale=256.0**-0.5)
    got = llama.gqa_attention(*(torch.from_numpy(a).bfloat16() for a in (q, k, v)),
                              torch.from_numpy(mask), logit_softcap=softcap, **kw)
    want = jllama.gqa_attention(*(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)),
                                jnp.asarray(mask), logit_softcap=softcap, **kw)
    assert max_rel(got, want) < BF16_RTOL
    if softcap is not None:  # the cap changes the result at these scores
        plain = llama.gqa_attention(*(torch.from_numpy(a).bfloat16() for a in (q, k, v)),
                                    torch.from_numpy(mask), **kw)
        assert max_rel(plain, want) > 2 * BF16_RTOL


def test_params_carry_over_and_quantize_as_jax(tiny):
    _, _, jparams = tiny
    dense = interop.params_from_numpy(to_numpy_tree(jparams), device="cpu")
    assert "lm_head" not in dense
    for fuse in (False, True):
        jq = jgemma2.quantize_model(jparams, num_bits=4, group_size=64, fuse=fuse)
        carried = interop.params_from_numpy(to_numpy_tree(jq), device="cpu")
        mine = gemma2.quantize_model(dense, num_bits=4, group_size=64, fuse=fuse, device="cpu")
        for jl, cl, ml in zip(jq["layers"], carried["layers"], mine["layers"]):
            assert set(jl) == set(cl) == set(ml)
            for key, leaf in jl.items():
                if isinstance(leaf, JQuantizedLinear):
                    assert cl[key].layout == ml[key].layout == leaf.layout == "w4sym"
                    for got in (cl[key], ml[key]):
                        np.testing.assert_array_equal(got.planes[0].numpy(),
                                                      np.asarray(leaf.planes[0]))
                        np.testing.assert_array_equal(f32(got.scales), f32(leaf.scales))
                        np.testing.assert_array_equal(got.table.numpy(), np.asarray(leaf.table))
                else:
                    np.testing.assert_array_equal(f32(cl[key]), f32(leaf))


def test_init_params_from_generator(tiny):
    config = gemma2.Gemma2Config.tiny()
    a = gemma2.init_params(config, seed=3, device="cpu")
    b = gemma2.init_params(config, seed=3, device="cpu")
    _, _, jparams = tiny
    assert torch.equal(a["layers"][1]["down"], b["layers"][1]["down"])
    assert set(a) == set(jparams) == {"embed", "layers", "final_norm"}
    for key, leaf in jparams["layers"][0].items():
        assert tuple(a["layers"][0][key].shape) == leaf.shape, key
        assert a["layers"][0][key].dtype == torch.bfloat16
    assert not a["layers"][0]["post_mlp_norm"].any() and not a["final_norm"].any()
    assert tuple(a["embed"].shape) == jparams["embed"].shape


def test_quantize_lm_head_raises(tiny):
    """The quantized tied head no longer raises (ROADMAP queue 1 item 20):
    it is a padded quantized copy of the embedding, which stays dense; its
    parity with JAX is in ``tests/test_torch_quantized_head.py``."""
    config = gemma2.Gemma2Config.tiny()
    params = gemma2.init_params(config, seed=0, device="cpu")
    q = gemma2.quantize_model(params, quantize_lm_head=True, device="cpu")
    assert isinstance(q["lm_head"], QuantizedLinear)
    assert q["lm_head"].scales.shape[1] == 2048
    assert q["embed"] is params["embed"]


def _jax_logits(jparams, jconfig, tokens, offsets, nxt, pos_vec):
    b, t = tokens.shape
    cache = jgemma2.init_cache(jconfig, b, 32)
    offs = jnp.asarray(offsets, jnp.int32)
    pre, cache = jgemma2.forward(jparams, jconfig, jnp.asarray(tokens, jnp.int32), cache,
                                 jnp.int32(0), offs)
    pos = jnp.asarray(pos_vec, jnp.int32) if pos_vec is not None else jnp.int32(t)
    dec, _ = jgemma2.forward(jparams, jconfig, jnp.asarray(nxt, jnp.int32), cache, pos, offs)
    return np.asarray(pre), np.asarray(dec)


def _port_logits(params, config, tokens, offsets, nxt, pos):
    b, t = tokens.shape
    cache = gemma2.init_cache(config, b, 32, device="cpu")
    offs = torch.from_numpy(offsets)
    with torch.inference_mode():
        pre, cache = gemma2.forward(params, config, torch.from_numpy(tokens), cache, 0, offs)
        dec, _ = gemma2.forward(params, config, torch.from_numpy(nxt), cache, pos, offs)
    return pre, dec


def _inputs(config, seed=1):
    rng = np.random.default_rng(seed)
    b, t = 2, 16  # 16 slots: the sliding layers' window of 8 masks the first ones
    tokens = rng.integers(0, config.vocab_size, (b, t)).astype(np.int64)
    offsets = np.array([0, 5], np.int64)  # sequence 1 is left-padded by 5
    nxt = rng.integers(0, config.vocab_size, (b, 1)).astype(np.int64)
    return tokens, offsets, nxt


POS_KINDS = {
    "int": lambda t: t,
    "tensor": lambda t: torch.tensor(t),
    "per_sequence": lambda t: torch.tensor([t, t]),
}


def check_logits(jparams, jconfig, params, config, pos_kind, rtol=BF16_RTOL):
    tokens, offsets, nxt = _inputs(config)
    t = tokens.shape[1]
    pos_vec = np.array([t, t]) if pos_kind == "per_sequence" else None
    jpre, jdec = _jax_logits(jparams, jconfig, tokens, offsets, nxt, pos_vec)
    tpre, tdec = _port_logits(params, config, tokens, offsets, nxt, POS_KINDS[pos_kind](t))
    assert tpre.dtype == torch.float32 and tuple(tpre.shape) == jpre.shape
    assert tuple(tdec.shape) == jdec.shape == (2, 1, config.vocab_size)
    assert float(tpre.abs().max()) <= config.final_logit_softcap
    # left-pad slots of sequence 1 are masked: its real-token logits only
    assert max_rel(tpre[:, offsets[1]:], jpre[:, offsets[1]:]) < rtol
    assert max_rel(tdec, jdec) < rtol
    return tdec


@pytest.mark.parametrize("pos_kind", list(POS_KINDS))
def test_dense_logits_match_jax(tiny, pos_kind):
    jconfig, config, jparams = tiny
    params = interop.params_from_numpy(to_numpy_tree(jparams), device="cpu")
    check_logits(jparams, jconfig, params, config, pos_kind)


@pytest.mark.parametrize("pos_kind", list(POS_KINDS))
def test_quantized_logits_match_jax(quantized, pos_kind, monkeypatch):
    jconfig, config, jq, tq = quantized
    dec = check_logits(jq, jconfig, tq, config, pos_kind, rtol=2 * BF16_RTOL)
    with monkeypatch.context() as m:
        m.setattr(lut_gemm, "lut_qgemm_plain", group_order_plain)
        check_logits(jq, jconfig, tq, config, pos_kind)
    if pos_kind == "tensor":  # a device pos gives the bits of an int pos
        tokens, offsets, nxt = _inputs(config)
        _, want = _port_logits(tq, config, tokens, offsets, nxt, tokens.shape[1])
        assert torch.equal(dec, want)


def test_sliding_window_restricts_attention():
    """A 1-layer sliding-only model (window 4): the last position's logits
    are bit-equal whether or not a token out of its window differs, in the
    port as in JAX (``tests/test_gemma2.py``), and the port's follow JAX's."""
    jconfig = dataclasses.replace(jgemma2.Gemma2Config.tiny(), num_layers=1, sliding_window=4)
    config = dataclasses.replace(gemma2.Gemma2Config.tiny(), num_layers=1, sliding_window=4)
    jparams = jgemma2.init_params(jconfig, rng=2)
    params = interop.params_from_numpy(to_numpy_tree(jparams), device="cpu")
    rng = np.random.default_rng(3)
    base = rng.integers(1, 100, 12)
    t2 = base.copy()
    t2[0] = (t2[0] + 7) % 100 + 1  # differs only at position 0
    outs = []
    for t in (base, t2):
        cache = gemma2.init_cache(config, 1, 12, device="cpu")
        with torch.inference_mode():
            logits, _ = gemma2.forward(params, config, torch.from_numpy(t[None]), cache, 0)
        jcache = jgemma2.init_cache(jconfig, 1, 12)
        jlogits, _ = jgemma2.forward(jparams, jconfig, jnp.asarray(t[None], jnp.int32), jcache,
                                     jnp.int32(0))
        assert max_rel(logits, jlogits) < BF16_RTOL
        outs.append(logits[0, -1])
    assert torch.equal(outs[0], outs[1])
    # a global layer sees position 0
    config2 = dataclasses.replace(config, num_layers=2)
    params2 = gemma2.init_params(config2, seed=2, device="cpu")
    outs = []
    for t in (base, t2):
        cache = gemma2.init_cache(config2, 1, 12, device="cpu")
        with torch.inference_mode():
            outs.append(gemma2.forward(params2, config2, torch.from_numpy(t[None]), cache,
                                       0)[0][0, -1])
    assert not torch.equal(outs[0], outs[1])


def left_pad(prompts, plen=16):
    toks = np.zeros((BATCH, plen), np.int64)
    offsets = np.full((BATCH,), plen, np.int64)
    for i, p in enumerate(prompts):
        toks[i, plen - len(p):] = p
        offsets[i] = plen - len(p)
    return toks, offsets


@pytest.fixture(scope="module")
def served(tiny):
    """The fused w4sym model in both packages, JAX's greedy tokens from its
    Engine and the step logits that chose them, and which steps are
    decided (a top-1/top-2 margin over twice the threshold)."""
    jconfig, config, jparams = tiny
    jq = jgemma2.quantize_model(jparams, num_bits=4, group_size=64, fuse=True)
    tq = interop.params_from_numpy(to_numpy_tree(jq), device="cpu")
    eng = JEngine(params=jq, config=jconfig, forward=jgemma2.forward,
                  init_cache=jgemma2.init_cache, batch_size=BATCH, max_len=MAX_LEN)
    out = eng.generate(PROMPTS, max_new_tokens=NEW_TOKENS)
    toks, offsets = left_pad(PROMPTS)
    offs = jnp.asarray(offsets, jnp.int32)
    logits, cache = eng._prefill(jq, jnp.asarray(toks, jnp.int32), eng._new_cache(), offs)
    steps = [np.asarray(logits)]
    for s in range(NEW_TOKENS - 1):
        nxt = jnp.argmax(logits, axis=-1).astype(jnp.int32)[:, None]
        logits, cache = eng._decode(jq, nxt, cache, jnp.int32(16 + s), offs)
        steps.append(np.asarray(logits))
    jl = np.stack(steps)
    jtokens = jl.argmax(-1).T
    assert [o for o in out] == jtokens.tolist()
    scale = np.abs(jl).max(axis=-1)
    top2 = np.sort(jl, axis=-1)[..., -2:]
    decided = (top2[..., 1] - top2[..., 0]) > 2 * BF16_RTOL * scale  # [steps, B]
    assert decided.mean() > 0.5, "too many near-ties for the test to say anything"
    ties = [int(np.argmin(col)) if not col.all() else NEW_TOKENS for col in decided.T]
    return dict(jconfig=jconfig, config=config, jq=jq, tq=tq, jtokens=jtokens, jlogits=jl,
                decided=decided, ties=ties)


def test_engine_matches_jax_engine(served, monkeypatch):
    """Teacher-forced on JAX's tokens, the step logits follow JAX's (the
    LUT-GEMM summing in JAX's order); the greedy tokens equal JAX's before
    the first near-tie; a second run on the reused cache repeats them."""
    config, tq, jtokens = served["config"], served["tq"], served["jtokens"]
    eng = Engine(params=tq, config=config, forward=gemma2.forward,
                 init_cache=gemma2.init_cache, batch_size=BATCH, max_len=MAX_LEN, device="cpu")
    toks, offsets = left_pad(PROMPTS)
    offs = torch.from_numpy(offsets)
    with monkeypatch.context() as m:
        m.setattr(lut_gemm, "lut_qgemm_plain", group_order_plain)
        logits, cache = eng.prefill(torch.from_numpy(toks), offs)
        steps = [logits.numpy()]
        for s in range(NEW_TOKENS - 1):
            logits, cache = eng.decode(torch.from_numpy(jtokens[:, s:s + 1]), cache, 16 + s,
                                       offs)
            steps.append(logits.numpy())
    tl, jl = np.stack(steps), served["jlogits"]
    assert (np.abs(tl - jl).max(axis=-1) / np.abs(jl).max(axis=-1)).max() < BF16_RTOL
    decided = served["decided"]
    np.testing.assert_array_equal(np.where(decided, tl.argmax(-1), -1),
                                  np.where(decided, jtokens.T, -1))
    out = eng.generate(PROMPTS, max_new_tokens=NEW_TOKENS)
    for i, tie in enumerate(served["ties"]):
        assert out[i][:tie] == jtokens[i, :tie].tolist()
    assert eng.generate(PROMPTS, max_new_tokens=NEW_TOKENS) == out  # the cache is reused


PAGED_KW = dict(num_slots=2, block_size=8, num_blocks=10, max_len=32)


def drive(eng, prompts):
    rids = [eng.submit(p, max_new_tokens=NEW_TOKENS) for p in prompts]
    out = eng.run()
    return [out[r] for r in rids]


@pytest.fixture(scope="module")
def jax_paged(served):
    """JAX's PagedEngine (pool prefill, chunks of 4) on the three prompts:
    two slots, so the third waits for one."""
    jeng = JPagedEngine(params=served["jq"], config=served["jconfig"], pool_prefill=True,
                        prefill_chunk=4, **PAGED_KW)
    out = drive(jeng, PROMPTS)
    assert jeng.blocks_in_use == 0
    return out


@pytest.mark.parametrize("pool_prefill", [False, True], ids=["dense_prefill", "pool_prefill"])
def test_paged_engine_matches_jax(served, jax_paged, pool_prefill):
    config, tq = served["config"], served["tq"]
    eng = PagedEngine(params=tq, config=config, device="cpu", pool_prefill=pool_prefill,
                      prefill_chunk=4 if pool_prefill else None, **PAGED_KW)
    assert eng.forward is gemma2.forward and eng.init_cache is gemma2.init_cache
    out = drive(eng, PROMPTS)
    assert eng.blocks_in_use == 0
    # the longest request decodes past slot 8: every sliding layer's window
    # then leaves out its first positions
    assert len(PROMPTS[2]) + NEW_TOKENS > config.sliding_window
    for i, tie in enumerate(served["ties"]):
        assert out[i][:tie] == jax_paged[i][:tie] == served["jtokens"][i, :tie].tolist(), i


def test_checkpoint_round_trip(served, tmp_path):
    config, tq = served["config"], served["tq"]
    checkpoint.save_quantized(str(tmp_path), tq, num_bits=4, group_size=64)
    loaded, _ = checkpoint.load_quantized(str(tmp_path), device="cpu")
    tokens, offsets, nxt = _inputs(config, seed=5)
    for a, b in zip(_port_logits(tq, config, tokens, offsets, nxt, 16),
                    _port_logits(loaded, config, tokens, offsets, nxt, 16)):
        assert torch.equal(a, b)
