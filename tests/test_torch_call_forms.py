"""The JAX package's call forms run in the port and do what they do in JAX
(queue 3 items 51 and 52), on the CPU, against the JAX package on the same
seeded numpy inputs.

* ``QuantizedLinear`` built positionally in JAX's field order from a JAX
  HIGGS-W4 layer with a bias: ``pair_values`` and ``bias`` land where JAX
  puts them, and the CPU forward is within the bf16 threshold (1.1e-2,
  relative Frobenius) of the JAX layer's (Pallas in interpret mode).
* ``LearnableQuantizedLinear`` with ``num_bits`` and ``group_size``
  positional: the keyword form's forward bit for bit, and JAX's positional
  layer's within 1e-5 (f32, as ``tests/test_torch_learnable.py``).
* ``Engine`` and ``PagedSpeculativeEngine`` with JAX's positionals (taken
  from JAX's own signature, ``mesh=None`` among them) bind JAX's names and
  serve the keyword form's greedy tokens on tiny Llama.
* ``init_params(config, 0)`` and ``init_params(config, rng=Generator)``
  equal JAX's leaf for leaf, bit for bit, for Llama and Gemma-2 ``tiny()``
  in bf16, f16 and f32: numpy draws the same float64 values and both cast
  them as numpy does. Without ``rng``, and with ``seed``, the values are
  the ``torch.Generator`` draws the port made before it took ``rng``
  (pinned by a digest taken then). ``rng`` and ``seed`` together raise.
* ``bench_op`` takes JAX's forms and raises without CUDA, as
  ``bench_cycled`` does; nothing is built inside a CUDA graph capture.
"""

import dataclasses
import hashlib
import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flute_tpu.models import gemma2 as jgemma2
from flute_tpu.models import llama as jllama
from flute_tpu.quantize import higgs as jhiggs
from flute_tpu.quantize import learnable as jlearn
from flute_tpu.serving.engine import Engine as JEngine
from flute_tpu.serving.paged_spec import PagedSpeculativeEngine as JPagedSpec
from flute_tpu.utils import benchmark as jbenchmark
from flute_tpu_torch import nn
from flute_tpu_torch.models import gemma2, llama
from flute_tpu_torch.ops import _build
from flute_tpu_torch.quantize import learnable
from flute_tpu_torch.serving import Engine, PagedSpeculativeEngine
from flute_tpu_torch.utils import benchmark

BF16_RTOL = 1.1e-2
PROMPTS = [[3, 17, 42, 9], [11, 5]]


@pytest.fixture(autouse=True, scope="module")
def few_torch_threads():
    """Many small CPU ops beside the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def jax_positionals(jax_cls, **values) -> list:
    """The arguments of ``jax_cls``'s positional form: ``values`` by name,
    JAX's defaults between them, up to the last named one."""
    names = list(inspect.signature(jax_cls).parameters)
    last = max(names.index(n) for n in values)
    params = inspect.signature(jax_cls).parameters
    return [values.get(n, params[n].default) for n in names[:last + 1]]


def test_quantized_linear_takes_jax_positional_order():
    k, n, g, had, bits = 512, 256, 64, 128, 4
    rng = np.random.default_rng(0)
    e = 2**bits
    codes = rng.integers(0, e * e, (k // 2, n), dtype=np.int64)
    grid = rng.standard_normal((e * e, 2)).astype(np.float32)
    scales = rng.uniform(0.5, 1.5, (k // g, n)).astype(np.float32)
    bias = rng.standard_normal(n).astype(np.float32)
    x = rng.standard_normal((3, k)).astype(np.float32)
    jl = jhiggs.from_higgs(codes, grid, jnp.asarray(scales, jnp.bfloat16), num_bits=bits,
                           group_size=g, hadamard_size=had, bias=jnp.asarray(bias, jnp.bfloat16))
    assert jl.pair_values is not None and jl.bias is not None

    def t(a):
        return torch.from_numpy(np.asarray(a, np.float32))

    tl = nn.QuantizedLinear([torch.from_numpy(np.array(p)) for p in jl.planes],
                            t(jl.scales).bfloat16(), t(jl.table), t(jl.pair_values),
                            t(jl.bias).bfloat16(), jl.num_bits, jl.group_size, jl.config_key,
                            jl.hadamard_size, jl.layout)
    np.testing.assert_array_equal(tl.pair_values.numpy(), np.asarray(jl.pair_values))
    np.testing.assert_array_equal(tl.bias.float().numpy(), np.asarray(jl.bias, np.float32))
    assert (tl.num_bits, tl.group_size, tl.hadamard_size, tl.layout) == (
        jl.num_bits, jl.group_size, jl.hadamard_size, jl.layout)
    assert tl.config.lut_mode == jl.config.lut_mode == "pair_lut"
    assert tl.kernel_layout == "pair"
    got = tl(torch.from_numpy(x).bfloat16()).float().numpy()
    want = np.asarray(jl(jnp.asarray(x, jnp.bfloat16)), np.float32)
    assert np.linalg.norm(got - want) / np.linalg.norm(want) < BF16_RTOL
    # the same layer without its pair table and bias, JAX's positional None
    plain = nn.QuantizedLinear(tl.planes, tl.scales, tl.table, None, tl.bias, 4, 64)
    assert plain.pair_values is None and plain.bias is tl.bias


def test_learnable_takes_num_bits_and_group_size_positionally():
    rng = np.random.default_rng(3)
    w = rng.standard_normal((256, 128)).astype(np.float32)
    bias = rng.standard_normal(128).astype(np.float32)
    x = rng.standard_normal((4, 256)).astype(np.float32)
    base = learnable.make_learnable(torch.from_numpy(w), 3, 32)
    args = (base.weight, base.scales.detach(), base.table, torch.from_numpy(bias))
    pos = learnable.LearnableQuantizedLinear(*args, 3, 32)
    kw = learnable.LearnableQuantizedLinear(*args, num_bits=3, group_size=32)
    assert (pos.num_bits, pos.group_size) == (3, 32)
    got = pos(torch.from_numpy(x)).detach()
    assert torch.equal(got, kw(torch.from_numpy(x)).detach())
    jl = jlearn.LearnableQuantizedLinear(*(jnp.asarray(a.numpy()) for a in args), 3, 32)
    np.testing.assert_allclose(got.numpy(), np.asarray(jl(jnp.asarray(x))), rtol=1e-5,
                               atol=1e-5)


@pytest.fixture(scope="module")
def tiny():
    config = llama.LlamaConfig.tiny()
    params = llama.quantize_model(llama.init_params(config, device="cpu"), group_size=64,
                                  fuse=True, device="cpu")
    return config, params


def test_engine_takes_jax_positionals(tiny):
    config, params = tiny
    args = jax_positionals(JEngine, params=params, config=config, forward=llama.forward,
                           init_cache=llama.init_cache, max_len=64, batch_size=2, pad_id=0,
                           mesh=None)
    assert len(args) == 8
    bound = inspect.signature(Engine).bind(*args).arguments
    assert bound == inspect.signature(JEngine).bind(*args).arguments
    pos = Engine(*args, device="cpu")
    kw = Engine(params=params, config=config, max_len=64, batch_size=2, device="cpu")
    assert pos.mesh is None and pos.device == torch.device("cpu")
    want = kw.generate(PROMPTS, max_new_tokens=6)
    assert pos.generate(PROMPTS, max_new_tokens=6) == want
    assert [len(t) for t in want] == [6, 6]


def test_paged_speculative_engine_takes_jax_positionals(tiny):
    config, params = tiny
    shape = dict(num_slots=2, block_size=8, num_blocks=16, max_len=64)
    args = jax_positionals(JPagedSpec, params=params, config=config, **shape,
                           draft_params=params, draft_config=config, k=3)
    assert args[-3:] == [params, config, 3]
    bound = inspect.signature(PagedSpeculativeEngine).bind(*args).arguments
    assert bound == inspect.signature(JPagedSpec).bind(*args).arguments

    def serve(eng):
        rids = [eng.submit(p, max_new_tokens=8) for p in PROMPTS]
        out = eng.run()
        return [out[r] for r in rids]

    pos = PagedSpeculativeEngine(*args, device="cpu")
    kw = PagedSpeculativeEngine(params=params, config=config, draft_params=params,
                                draft_config=config, k=3, device="cpu", **shape)
    assert pos.draft_params is params and pos.k == 3 and pos.device == torch.device("cpu")
    want = serve(kw)
    assert serve(pos) == want and [len(t) for t in want] == [8, 8]
    assert pos.stats.rounds == kw.stats.rounds > 0


FAMILIES = {"llama": (jllama, llama, "LlamaConfig"), "gemma2": (jgemma2, gemma2, "Gemma2Config")}
INT_VIEW = {2: (torch.int16, np.int16), 4: (torch.int32, np.int32)}
# digests of init_params(tiny(), device="cpu") (= seed=0) and of seed=3,
# scale=0.5, taken from the port before init_params took rng
PINNED = {"llama": ("0fe781310ced9750", "52e2f4d0c4c0404e"),
          "gemma2": ("6e76df0745bf27de", "16297b8ea65c1172")}


def leaves(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from leaves(tree[k], path + (k,))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from leaves(v, path + (i,))
    else:
        yield path, tree


def digest(tree) -> str:
    h = hashlib.sha256()
    for _, t in leaves(tree):
        if t is not None:
            h.update(t.contiguous().view(INT_VIEW[t.element_size()][0]).numpy().tobytes())
    return h.hexdigest()[:16]


def configs(family, dtype):
    jm, tm, name = FAMILIES[family]
    return (dataclasses.replace(getattr(jm, name).tiny(), dtype=getattr(jnp, dtype)),
            dataclasses.replace(getattr(tm, name).tiny(), dtype=getattr(torch, dtype)))


@pytest.mark.parametrize("form", ["positional_int", "generator"])
@pytest.mark.parametrize("dtype", ["bfloat16", "float16", "float32"])
@pytest.mark.parametrize("family", list(FAMILIES))
def test_init_params_rng_draws_jax_values(family, dtype, form):
    jm, tm, _ = FAMILIES[family]
    jc, tc = configs(family, dtype)
    want = dict(leaves(jm.init_params(jc, 5, 0.05)))
    if form == "positional_int":
        got = tm.init_params(tc, 5, 0.05, device="cpu")
    else:
        got = tm.init_params(tc, rng=np.random.default_rng(5), scale=0.05, device="cpu")
    got = dict(leaves(got))
    assert list(got) == list(want)
    for path, t in got.items():
        if t is None:
            assert want[path] is None, path
            continue
        assert t.dtype == tc.dtype and t.device == torch.device("cpu")
        tview, nview = INT_VIEW[t.element_size()]
        np.testing.assert_array_equal(t.view(tview).numpy(), np.asarray(want[path]).view(nview),
                                      err_msg=str(path))


@pytest.mark.parametrize("family", list(FAMILIES))
def test_init_params_without_rng_keeps_the_torch_draws(family):
    _, tm, name = FAMILIES[family]
    config = getattr(tm, name).tiny()
    default, seeded = PINNED[family]
    assert digest(tm.init_params(config, device="cpu")) == default
    assert digest(tm.init_params(config, seed=0, device="cpu")) == default
    assert digest(tm.init_params(config, seed=3, scale=0.5, device="cpu")) == seeded
    # rng=0, passed, is JAX's draw, not the default's
    assert digest(tm.init_params(config, 0, device="cpu")) != default
    assert str(inspect.signature(tm.init_params).parameters["rng"]) == "rng=0"
    for rng in (0, np.random.default_rng(0)):
        with pytest.raises(ValueError, match="not both"):
            tm.init_params(config, rng, seed=0, device="cpu")


def test_bench_op_takes_the_jax_forms(monkeypatch):
    def f(x, w):
        return x @ w

    x, w = torch.ones(2, 4), torch.ones(4, 3)
    for call in ((f, x, w), (f, x)):
        kw = dict(iters=10, warmup=False, min_window=0.0)
        got = inspect.signature(benchmark.bench_op).bind(*call, **kw).arguments
        assert got == inspect.signature(jbenchmark.bench_op).bind(*call, **kw).arguments
        assert got["args"] == call[1:]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA device"):
        benchmark.bench_op(lambda x: x, torch.ones(4), iters=10)
    with pytest.raises(RuntimeError, match="CUDA device"):
        benchmark.bench_cycled(lambda x: x, [(torch.ones(4),)])


def test_nothing_is_built_inside_a_capture(monkeypatch, tmp_path):
    """``_build.load`` refuses inside a CUDA graph capture before it looks
    for the source or nvcc, so a capture never builds a kernel."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: True)
    monkeypatch.setattr(_build, "build", lambda source: pytest.fail("built in a capture"))
    with pytest.raises(RuntimeError, match="CUDA graph capture"):
        _build.load("lut_gemm_w4sym.cu")
