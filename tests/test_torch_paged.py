"""The port's paged attention and paged engine against the JAX package's.

* The plain versions of the two paged kernels (``paged_gqa_reference`` for
  K5, ``paged_verify_reference`` for K6), reached through the wrappers on CPU
  tensors, against JAX's Pallas kernels in interpret mode on the same numpy
  inputs: GQA and MHA, unaligned, block-aligned and full lengths, softcap,
  window and both, a zero-length slot, T in {1, 3, 16}. Tolerance: 1.1e-2
  of the largest output (bf16).
* The sampling helpers against JAX's to f32 rounding.
* ``PagedEngine`` on ``LlamaConfig.tiny()`` (w4sym, fused; JAX's weights
  carried over by ``params_from_numpy``) at both ``pool_prefill`` settings
  against JAX's ``PagedEngine`` (pool prefill; JAX's own tests hold its two
  prefill routes equal): three requests on a pool too small for
  all three, the third sharing a cached prefix block with the first. The
  blocks in use and the queue after each step and the prefix-cache hits
  must be the same; greedy tokens must be identical at every step before
  the first one where JAX's top-1/top-2 margin is within twice the bf16
  threshold (as ``tests/test_torch_engine.py`` gates them); and the same
  against the port's own ``Engine``, with the first-token logits within the
  bf16 threshold.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_engine import BF16_RTOL, build_models, jax_trajectory, left_pad

from flute_tpu.ops import paged_attention as jpa
from flute_tpu.serving import continuous as jcont
from flute_tpu.serving.paged import PagedEngine as JPagedEngine
from flute_tpu_torch.models import gemma2
from flute_tpu_torch.ops import paged_attention as pa
from flute_tpu_torch.serving import Engine, PagedEngine, SamplingParams
from flute_tpu_torch.serving import continuous, paged

@pytest.fixture(autouse=True, scope="module")
def few_torch_threads():
    """The port's engines run many small CPU ops; beside the other test
    workers, a full team of threads per op mostly waits on the others."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


OPTIONS = [(None, None), (50.0, None), (None, 10), (30.0, 24), (50.0, 3)]
B, D, BS = 3, 128, 16
COMMON = [5, 9, 2, 14, 3, 8, 1, 6]  # one block of 8
PROMPTS = [COMMON + [20, 21, 22], [11, 5, 3], COMMON + [30]]
NEW_TOKENS = 8


def pools(rng, nb, hkv):
    kp = rng.standard_normal((nb, hkv, BS, D)).astype(np.float32)
    vp = rng.standard_normal((nb, hkv, BS, D)).astype(np.float32)
    return kp, vp


def bf16(a):
    return torch.from_numpy(np.asarray(a, np.float32)).bfloat16()


def assert_close(got, want):
    w = np.asarray(want, np.float32)
    err = np.abs(got.float().numpy() - w).max()
    assert err / max(np.abs(w).max(), 1e-6) < 1.1e-2


@pytest.mark.parametrize("softcap,window", OPTIONS)
@pytest.mark.parametrize("hkv,h", [(2, 8), (4, 4)], ids=["gqa", "mha"])
def test_paged_decode_matches_jax_kernel(hkv, h, softcap, window):
    rng = np.random.default_rng(0)
    mb, nb = 4, 16
    q = rng.standard_normal((B, h, D)).astype(np.float32)
    kp, vp = pools(rng, nb, hkv)
    tables = rng.permutation(nb)[: B * mb].reshape(B, mb).astype(np.int32)
    lengths = np.array([37, 16, 64], np.int32)  # unaligned, block-aligned, full
    kw = dict(softcap=softcap, window=window)
    want = jpa.paged_decode_attention(
        jnp.asarray(q, jnp.bfloat16), jnp.asarray(kp, jnp.bfloat16),
        jnp.asarray(vp, jnp.bfloat16), jnp.asarray(tables), jnp.asarray(lengths),
        interpret=True, **kw)
    got = pa.paged_decode_attention(bf16(q), bf16(kp), bf16(vp), torch.from_numpy(tables),
                                    torch.from_numpy(lengths), **kw)
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == (B, h, D)
    assert_close(got, want)
    ref = pa.paged_gqa_reference(bf16(q), bf16(kp), bf16(vp), torch.from_numpy(tables),
                                 torch.from_numpy(lengths), **kw)
    assert torch.equal(got, ref)


def test_paged_decode_zero_length_slot_is_finite_zero():
    rng = np.random.default_rng(1)
    q = bf16(rng.standard_normal((2, 4, D)))
    kp, vp = (bf16(a) for a in pools(rng, 4, 2))
    tables = torch.zeros((2, 2), dtype=torch.int32)  # parked on the trash block
    lengths = torch.tensor([0, 5], dtype=torch.int32)
    got = pa.paged_decode_attention(q, kp, vp, tables, lengths)
    want = np.asarray(jpa.paged_decode_attention(
        jnp.asarray(q.float().numpy(), jnp.bfloat16), jnp.asarray(kp.float().numpy(), jnp.bfloat16),
        jnp.asarray(vp.float().numpy(), jnp.bfloat16), jnp.zeros((2, 2), jnp.int32),
        jnp.asarray([0, 5], jnp.int32), interpret=True), np.float32)
    assert torch.isfinite(got.float()).all()
    np.testing.assert_array_equal(want[0], 0.0)
    assert not got[0].float().any()
    assert_close(got[1:], want[1:])


@pytest.mark.parametrize("softcap,window", OPTIONS)
@pytest.mark.parametrize("t", [1, 3, 16])
def test_paged_verify_matches_jax_kernel(t, softcap, window):
    rng = np.random.default_rng(3)
    mb, nb = 7, 24
    kp, vp = pools(rng, nb, 2)
    tables = rng.permutation(nb)[: B * mb].reshape(B, mb).astype(np.int32)
    q = rng.standard_normal((B, t, 8, D)).astype(np.float32)
    # one below a block edge (a live block fully masked for early rows: the
    # finite-sentinel path), unaligned, and near the table's end
    lengths = np.array([15, 37, 111 - t], np.int32)
    kw = dict(softcap=softcap, window=window)
    want = jpa.paged_verify_attention(
        jnp.asarray(q, jnp.bfloat16), jnp.asarray(kp, jnp.bfloat16),
        jnp.asarray(vp, jnp.bfloat16), jnp.asarray(tables), jnp.asarray(lengths),
        interpret=True, **kw)
    got = pa.paged_verify_attention(bf16(q), bf16(kp), bf16(vp), torch.from_numpy(tables),
                                    torch.from_numpy(lengths), **kw)
    assert tuple(got.shape) == (B, t, 8, D)
    assert_close(got, want)
    # query t is the decode of length lengths + t + 1
    for j in (0, t - 1):
        dec = pa.paged_decode_attention(bf16(q[:, j]), bf16(kp), bf16(vp),
                                        torch.from_numpy(tables),
                                        torch.from_numpy(lengths + j + 1), **kw)
        assert_close(got[:, j], dec.float().numpy())


def test_wrappers_clamp_tables_and_check_shapes():
    rng = np.random.default_rng(4)
    kp, vp = (bf16(a) for a in pools(rng, 8, 2))
    q = bf16(rng.standard_normal((2, 4, D)))
    tables = torch.tensor([[3, 5, 1], [2, 7, 6]], dtype=torch.int32)
    lengths = torch.tensor([20, 9], dtype=torch.int32)
    want = pa.paged_decode_attention(q, kp, vp, tables, lengths)
    junk = tables.clone()
    junk[0, 2], junk[1, 1:] = 99, -4  # dead blocks may hold anything
    assert torch.equal(pa.paged_decode_attention(q, kp, vp, junk, lengths), want)
    with pytest.raises(ValueError, match="head_dim"):
        pa.paged_decode_attention(q[..., :64], kp, vp, tables, lengths)
    with pytest.raises(ValueError, match="multiple"):
        pa.paged_decode_attention(q[:, :3], kp, vp, tables, lengths)
    with pytest.raises(ValueError, match="T, H, D"):
        pa.paged_verify_attention(q, kp, vp, tables, lengths)
    with pytest.raises(ValueError, match="unsupported device"):
        pa.paged_decode_attention(q.to("meta"), kp.to("meta"), vp.to("meta"),
                                  tables.to("meta"), lengths.to("meta"))


# ---------------------------------------------------------------------------
# Sampling helpers
# ---------------------------------------------------------------------------

WARPS = [(0.0, 0, 1.0), (1.0, 0, 1.0), (0.7, 5, 1.0), (1.3, 0, 0.8), (0.9, 50, 0.9),
         (2.0, 1, 0.5)]


@pytest.mark.parametrize("temperature,top_k,top_p", WARPS)
def test_warp_logits_matches_jax(temperature, top_k, top_p):
    logits = np.random.default_rng(5).standard_normal(300).astype(np.float32) * 3
    want = np.asarray(jcont._warp_logits(jnp.asarray(logits), jnp.float32(temperature),
                                         jnp.int32(top_k), jnp.float32(top_p)))
    got = continuous._warp_logits(torch.from_numpy(logits), temperature, top_k, top_p).numpy()
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=1e-6, atol=0)


def test_apply_penalties_matches_jax():
    rng = np.random.default_rng(6)
    b, v = 4, 64
    logits = (rng.standard_normal((b, v)) * 2).astype(np.float32)
    pc = rng.integers(0, 2, (b, v)).astype(np.int32)
    oc = rng.integers(0, 3, (b, v)).astype(np.int32) * (rng.random((b, v)) < 0.3)
    oc = oc.astype(np.int32)
    pres = np.array([0.0, 0.5, 0.0, 1.2], np.float32)
    freq = np.array([0.0, 0.0, 0.3, 0.1], np.float32)
    rep = np.array([1.0, 1.8, 0.0, 1.3], np.float32)  # rep 0 means 1
    want = np.asarray(jcont._apply_penalties(*(jnp.asarray(a) for a in
                                                (logits, pc, oc, pres, freq, rep))))
    got = continuous._apply_penalties(*(torch.from_numpy(a) for a in
                                        (logits, pc, oc, pres, freq, rep)))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(got[0].numpy(), logits[0])  # the defaults are an identity
    row = continuous._apply_penalties_row(torch.from_numpy(logits[1]), torch.from_numpy(pc[1]),
                                          torch.from_numpy(oc[1]), 0.5, 0.0, 1.8)
    np.testing.assert_array_equal(row.numpy(), got[1].numpy())


def test_sample_row_greedy_limits_and_seeds():
    logits = torch.from_numpy(np.random.default_rng(7).standard_normal((5, 200)).astype(np.float32))
    best = torch.argmax(logits, dim=-1)
    gen = [torch.Generator().manual_seed(i) for i in range(5)]
    assert torch.equal(continuous._sample_slots(logits, [0.0] * 5, [0] * 5, [1.0] * 5, gen), best)
    assert torch.equal(continuous._sample_slots(logits, [1.5] * 5, [1] * 5, [1.0] * 5, gen), best)
    assert torch.equal(continuous._sample_slots(logits, [1.0] * 5, [0] * 5, [1e-6] * 5, gen), best)
    top5 = torch.topk(logits[0], 5).indices
    for s in range(20):
        tok = continuous._sample_row(logits[0], 1.0, 5, 1.0, torch.Generator().manual_seed(s))
        assert tok in top5
    draw = [int(continuous._sample_row(logits[1], 1.0, 0, 1.0,
                                       torch.Generator().manual_seed(continuous.fold_in(3, 1))))
            for _ in range(2)]
    assert draw[0] == draw[1]
    assert continuous.fold_in(0, 1) != continuous.fold_in(1, 0)
    assert 0 <= continuous.fold_in(2**40, 7) < 2**63


# ---------------------------------------------------------------------------
# Engine
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def models():
    return build_models(4)


def engine_kw(pool_prefill):
    # 3 blocks for request 0, 2 for request 1, 1 shared + 2 own for request 2
    # and 5 usable blocks: request 2 waits for request 0's blocks
    return dict(num_slots=3, block_size=8, num_blocks=6, max_len=32, prefix_cache_blocks=2,
                pool_prefill=pool_prefill)


def drive(eng, prompts, n=NEW_TOKENS):
    """Submit, step to the end; the tokens of each request and the blocks in
    use and the queue length after each step."""
    rids = [eng.submit(p, max_new_tokens=n) for p in prompts]
    trace = []
    while eng.step():
        trace.append((eng.blocks_in_use, len(eng._queue)))
    out = eng.run()
    return [out[r] for r in rids], trace


def first_ties(decided):
    """Per sequence, the first step whose top-1/top-2 margin is too small."""
    return [int(np.argmin(col)) if not col.all() else len(col) for col in decided.T]


def margins(jconfig, jq, prompts):
    """JAX's greedy tokens and which steps they are decided at, from its
    dense engine's own logits (gated as tests/test_torch_engine.py gates)."""
    jtokens, jlogits = jax_trajectory(jconfig, jq, prompts)
    n = len(prompts)
    jl = jlogits[:, :n]
    scale = np.abs(jl).max(axis=-1)
    top2 = np.sort(jl, axis=-1)[..., -2:]
    decided = (top2[..., 1] - top2[..., 0]) > 2 * BF16_RTOL * scale
    assert decided.mean() > 0.5, "too many near-ties for the test to say anything"
    return jtokens[:n], decided


def jax_reference(jconfig, jq, prompts):
    """What the port is held to: JAX's greedy tokens and which steps they
    are decided at (its dense engine), and JAX's PagedEngine (pool prefill)
    on the same requests: its tokens, per-step blocks in use and queue, and
    its prefix cache."""
    jtokens, decided = margins(jconfig, jq, prompts)
    jeng = JPagedEngine(params=jq, config=jconfig, **engine_kw(True))
    jout, jtrace = drive(jeng, prompts)
    assert jeng.prefix_hits == 1 and jeng.prefix_block_hits == 1
    ties = first_ties(decided)
    for i, tie in enumerate(ties):
        assert jout[i][:tie] == jtokens[i, :tie].tolist()
    return dict(ties=ties, out=jout, trace=jtrace, prefix=list(jeng._prefix_map))


def check_paged_against_jax(ref, config, tq, prompts, pool_prefill):
    """The port's PagedEngine at ``pool_prefill`` against JAX's (``ref``)
    and against the port's own Engine."""
    eng = Engine(params=tq, config=config, batch_size=4, max_len=64, device="cpu")
    dense_out = eng.generate(prompts, max_new_tokens=NEW_TOKENS)
    toks, offsets = left_pad(prompts)
    dense_first, _ = eng.prefill(torch.from_numpy(toks), torch.from_numpy(offsets))
    peng = PagedEngine(params=tq, config=config, device="cpu", **engine_kw(pool_prefill))
    rows = []
    sample_first = paged.sample_first

    def record(row, sampling, raw=None):
        rows.append(row.clone())
        return sample_first(row, sampling, raw)

    paged.sample_first = record  # the engine's first draw after each prefill
    try:
        out, trace = drive(peng, prompts)
    finally:
        paged.sample_first = sample_first
    assert trace == ref["trace"]
    assert trace[0][1] == 1, "the third request should wait for blocks"
    assert peng.prefix_hits == 1 and peng.prefix_block_hits == 1
    assert peng.blocks_in_use == 0
    assert list(peng._prefix_map) == ref["prefix"]
    assert [len(o) for o in out] == [NEW_TOKENS] * len(prompts)
    for i, tie in enumerate(ref["ties"]):
        assert out[i][:tie] == ref["out"][i][:tie], i
        assert out[i][:tie] == dense_out[i][:tie], i
    first = torch.stack(rows).numpy()
    want = dense_first[: len(prompts)].numpy()
    assert np.abs(first - want).max() / np.abs(want).max() < BF16_RTOL
    assert all(len(peng.finished_logprobs[r]) == NEW_TOKENS for r in range(len(prompts)))


@pytest.fixture(scope="module")
def jax_paged(models):
    jconfig, jq, _, _, _ = models
    return jax_reference(jconfig, jq, PROMPTS)


@pytest.mark.parametrize("pool_prefill", [False, True], ids=["dense_prefill", "pool_prefill"])
def test_paged_engine_matches_jax(models, jax_paged, pool_prefill):
    _, _, config, tq, _ = models
    check_paged_against_jax(jax_paged, config, tq, PROMPTS, pool_prefill)


def test_paged_engine_options_and_guards(models):
    _, _, config, tq, _ = models
    kw = dict(num_slots=2, block_size=8, num_blocks=12, max_len=32, device="cpu")
    base = PagedEngine(params=tq, config=config, **kw)
    rid = base.submit(PROMPTS[0], max_new_tokens=6)
    full = base.run()[rid]
    # stop tokens end a request without emitting the stop token
    eng = PagedEngine(params=tq, config=config, **kw)
    seen = []
    eng.token_callback = lambda r, t: seen.append((r, t))
    rid = eng.submit(PROMPTS[0], max_new_tokens=6, stop_token_ids=(full[2],))
    assert eng.run()[rid] == full[: full.index(full[2])]
    assert seen == [(rid, t) for t in full[: full.index(full[2])]]
    assert eng.blocks_in_use == 0
    # chunked prefill on both routes gives the one-call stream
    for pool in (False, True):
        ch = PagedEngine(params=tq, config=config, prefill_chunk=4, pool_prefill=pool, **kw)
        rid = ch.submit(PROMPTS[0], max_new_tokens=6)
        assert ch.run()[rid] == full, pool
    # penalties: no immediate repeats under a strong repetition penalty
    pen = PagedEngine(params=tq, config=config, **kw)
    rid = pen.submit(PROMPTS[1], max_new_tokens=6, repetition_penalty=5.0)
    out = pen.run()[rid]
    assert all(a != b for a, b in zip(out, out[1:]))
    with pytest.raises(ValueError, match="max_len"):
        base.submit(list(range(30)), max_new_tokens=8)
    with pytest.raises(ValueError, match="either"):
        base.submit([1, 2], max_new_tokens=4, sampling=SamplingParams(), temperature=1.0)
    with pytest.raises(TypeError, match="make_mesh"):
        PagedEngine(params=tq, config=config, mesh=object(), **kw)
    # Gemma-2 is served; a softcapped config without Gemma-2's other fields
    # is no family the paged path serves
    with pytest.raises(NotImplementedError, match="Gemma-2"):
        PagedEngine(params=tq, config=type("Gemma2Like", (), {"attn_logit_softcap": 50.0})(),
                    **kw)
    gemma = PagedEngine(params=tq, config=gemma2.Gemma2Config.tiny(), **kw)
    assert gemma.forward is gemma2.forward and gemma.init_cache is gemma2.init_cache


def test_paged_sampling_is_keyed_per_request(models):
    _, _, config, tq, _ = models
    kw = dict(block_size=8, num_blocks=12, max_len=32, device="cpu")
    sampled = dict(temperature=0.9, top_k=50, top_p=0.95, seed=7)

    def run(prompts_kw, slots):
        eng = PagedEngine(params=tq, config=config, num_slots=slots, **kw)
        rids = [eng.submit(p, max_new_tokens=NEW_TOKENS, **k) for p, k in prompts_kw]
        out = eng.run()
        return [out[r] for r in rids]

    alone = run([(PROMPTS[0], sampled)], 1)[0]
    mixed = run([(PROMPTS[1], {}), (PROMPTS[0], sampled), (PROMPTS[2], dict(sampled, seed=8))], 3)
    assert mixed[1] == alone
    greedy = run([(PROMPTS[0], {})], 1)[0]
    assert run([(PROMPTS[0], dict(temperature=1.0, top_k=1, seed=3))], 1)[0] == greedy
    assert run([(PROMPTS[0], dict(temperature=0.0, seed=3))], 1)[0] == greedy
    assert mixed[0] == run([(PROMPTS[1], {})], 1)[0]  # greedy neighbour unaffected


def test_dense_prefill_after_a_long_shared_prefix(models):
    """Five shared blocks and a suffix whose bucket ends past the prompt's
    bucket: the scratch cache holds every write, so the request gives the
    same tokens after its prefix was cached as alone (ROADMAP.md queue 3
    item 12: the JAX engine's scratch is too small here)."""
    _, _, config, tq, _ = models
    rng = np.random.default_rng(0)
    a = rng.integers(1, 500, 60).tolist()
    b = a[:40] + rng.integers(1, 500, 20).tolist()
    kw = dict(num_slots=1, block_size=8, num_blocks=24, max_len=80, device="cpu")
    alone = PagedEngine(params=tq, config=config, **kw)
    rid = alone.submit(b, max_new_tokens=6)
    want = alone.run()[rid]
    for pool in (False, True):
        warm = PagedEngine(params=tq, config=config, prefix_cache_blocks=8, pool_prefill=pool,
                           **kw)
        warm.submit(a, max_new_tokens=6)
        warm.run()
        rid = warm.submit(b, max_new_tokens=6)
        assert warm.run()[rid] == want, pool
        assert warm.prefix_hits == 1 and warm.prefix_block_hits == 5
