"""The port's tensor parallelism (``flute_tpu_torch.parallel``) against the
JAX package's (``flute_tpu.parallel``), on the CPU.

* In one process, on the same packed layers: ``shard_linear`` /
  ``merge_shards`` (2 bits, 3 bits in two planes and wide, 4 bits, w4sym),
  ``permute_fused_linear`` and ``repack`` give JAX's planes and scales bit
  for bit; ``llama_partition_specs`` gives JAX's spec leaf for leaf;
  ``validate_tp`` accepts and refuses what JAX's does, for the tiny trees
  and for the presets at every tp the shape registry lists and more.
  Intended difference: the port also refuses a HIGGS row-parallel layer
  whose local K splits a Hadamard group, which JAX accepts and then fails
  on at its first forward.
* In gloo worlds on the CPU (``parallel.launch``, rank functions in
  ``torch_tp_ranks``): the port's TP forward against JAX's on its virtual
  CPU mesh, on the same weights and tokens, within the bf16 threshold
  (1.1e-2 of the largest logit), with the ranks' LUT-GEMM summing as
  JAX's kernel does (``torch_tp_ranks.group_order_plain``); the ranks'
  logits bit-identical; two all-reduces per block. A world of 2 runs
  Llama (unfused and fused) and Gemma-2 at tp = 2; a world of 4 runs
  ``tp_forward_fn`` at dp = 2 x tp = 2 (the KV caches against JAX's too)
  and the hybrid mesh's groups. A world where a rank raises, and one where
  a rank never joins an all-reduce, end with an error in the caller.

Each world costs about 5-25 s here, most of it the ranks' start.
"""

import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_tp_ranks
from jax.sharding import PartitionSpec as P
from test_torch_llama import to_numpy_tree

from flute_tpu import nn as jnn
from flute_tpu.models import gemma2 as jgemma2
from flute_tpu.models import llama as jllama
from flute_tpu.ops.kernel_config import KernelConfig as JKernelConfig
from flute_tpu.parallel import llama_partition_specs as jspecs
from flute_tpu.parallel import make_mesh as jmake_mesh
from flute_tpu.parallel import merge_shards as jmerge
from flute_tpu.parallel import permute_fused_linear as jpermute
from flute_tpu.parallel import repack as jrepack
from flute_tpu.parallel import shard_linear as jshard
from flute_tpu.parallel import shard_params as jshard_params
from flute_tpu.parallel import tp_forward_fn as jtp_forward_fn
from flute_tpu.parallel import tp_model_forward as jtp_model_forward
from flute_tpu.parallel import validate_tp as jvalidate
from flute_tpu.quantize.higgs import from_higgs as jfrom_higgs
from flute_tpu_torch import interop
from flute_tpu_torch.models import gemma2, llama
from flute_tpu_torch.nn import QuantizedLinear
from flute_tpu_torch.ops.kernel_config import KernelConfig
from flute_tpu_torch.parallel import (
    fused_member_widths,
    llama_partition_specs,
    merge_shards,
    permute_fused_linear,
    repack,
    shard_linear,
    validate_tp,
)
from flute_tpu_torch.parallel import launch

BF16_RTOL = 1.1e-2
LAYOUTS = {  # name: (bits, JAX quantize_linear keywords)
    "w2": (2, dict(chunk=128)),
    "w3_two_planes": (3, dict(chunk=128, wide=False)),
    "w3_wide": (3, dict(chunk=256)),
    "w4": (4, dict(chunk=128, symmetric=False)),
    "w4sym": (4, dict(chunk=128)),
}


def port_layer(jlayer) -> QuantizedLinear:
    return interop.params_from_numpy({"l": to_numpy_tree(jlayer)}, device="cpu")["l"]


def bits_equal(got: QuantizedLinear, want):
    assert len(got.planes) == len(want.planes)
    for g, w in zip(got.planes, want.planes):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        assert g.is_contiguous()
    np.testing.assert_array_equal(got.scales.float().numpy(), np.asarray(want.scales, np.float32))


def max_rel(got, want) -> float:
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-6))


@pytest.fixture(autouse=True, scope="module")
def few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# One process: the packed layers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", list(LAYOUTS))
def test_shard_and_merge_match_jax(name):
    bits, kw = LAYOUTS[name]
    rng = np.random.default_rng(0)
    w = jnp.asarray(rng.standard_normal((256, 1024)), jnp.float32)  # [out, in]
    jlayer = jnn.quantize_linear(w, num_bits=bits, group_size=64, **kw)
    layer = port_layer(jlayer)
    x = torch.from_numpy(rng.standard_normal((3, 1024)).astype(np.float32)).bfloat16()
    full = layer(x).float()
    for axis in ("n", "k"):
        shards = shard_linear(layer, 2, axis)
        for got, want in zip(shards, jshard(jlayer, 2, axis)):
            bits_equal(got, want)
            assert got.layout == layer.layout and got.chunk == layer.chunk
        bits_equal(merge_shards(shards, axis), jmerge(jshard(jlayer, 2, axis), axis))
        bits_equal(merge_shards(shards, axis), jlayer)
    # an N-shard computes its columns exactly; K-shards' partials sum to it
    nsh = shard_linear(layer, 2, "n")
    np.testing.assert_array_equal(torch.cat([s(x) for s in nsh], dim=1).float(), full)
    ksh = shard_linear(layer, 2, "k")
    parts = sum(s(x[:, i * 512:(i + 1) * 512]).float() for i, s in enumerate(ksh))
    assert max_rel(parts, full) < BF16_RTOL
    # a shard owns its storage: no view of the unsharded planes
    assert all(p.untyped_storage().data_ptr() != q.untyped_storage().data_ptr()
               for s in nsh for p, q in zip(s.planes, layer.planes))


def test_shard_linear_refuses_what_jax_refuses():
    w = jnp.asarray(np.random.default_rng(1).standard_normal((384, 768)), jnp.float32)
    jlayer = jnn.quantize_linear(w, num_bits=4, group_size=64, chunk=256)
    layer = port_layer(jlayer)
    for parts, axis in ((5, "n"), (2, "k"), (4, "k")):  # 768 / 2 = 384: not a chunk multiple
        with pytest.raises(ValueError):
            jshard(jlayer, parts, axis)
        with pytest.raises(ValueError):
            shard_linear(layer, parts, axis)


def test_permute_fused_linear_matches_jax():
    rng = np.random.default_rng(0)
    w = jnp.asarray(rng.standard_normal((512, 256)), jnp.float32)  # [out, in]
    jlayer = jnn.quantize_linear(w, num_bits=4, group_size=64, chunk=128)
    layer = port_layer(jlayer)
    widths = (256, 128, 128)
    for tp in (1, 2, 4):
        got = permute_fused_linear(layer, widths, tp)
        bits_equal(got, jpermute(jlayer, widths, tp))
    dense = layer.dequantize().float()
    offs = np.concatenate([[0], np.cumsum(widths)])
    idx = np.concatenate([np.arange(offs[m] + r * (wd // 2), offs[m] + (r + 1) * (wd // 2))
                          for r in range(2) for m, wd in enumerate(widths)])
    np.testing.assert_array_equal(permute_fused_linear(layer, widths, 2).dequantize().float(),
                                  dense[:, idx])


@pytest.mark.parametrize("name", ["w4", "w4sym", "w3_two_planes"])
def test_repack_matches_jax(name):
    bits, kw = LAYOUTS[name]
    rng = np.random.default_rng(3)
    w = jnp.asarray(rng.standard_normal((128, 512)), jnp.float32)
    jlayer = jnn.quantize_linear(w, num_bits=bits, group_size=64, **dict(kw, chunk=256))
    layer = port_layer(jlayer)
    got = repack(layer, new_chunk=128)
    bits_equal(got, jrepack(jlayer, new_chunk=128))
    assert got.chunk == 128
    x = torch.from_numpy(rng.standard_normal((3, 512)).astype(np.float32)).bfloat16()
    np.testing.assert_array_equal(got(x).float(), layer(x).float())
    with pytest.raises(ValueError):
        repack(layer, new_config=KernelConfig(chunk=128), new_chunk=256)


def test_repack_keeps_the_wide_layout():
    """JAX's repack turns a wide 3-bit layer into two planes; the port's
    keeps it wide (same codes, same products)."""
    rng = np.random.default_rng(4)
    w = jnp.asarray(rng.standard_normal((128, 1024)), jnp.float32)
    layer = port_layer(jnn.quantize_linear(w, num_bits=3, group_size=64, chunk=512))
    got = repack(layer, new_chunk=256)
    assert got.kernel_layout == "w3wide" and got.chunk == 256
    x = torch.from_numpy(rng.standard_normal((3, 1024)).astype(np.float32)).bfloat16()
    np.testing.assert_array_equal(got(x).float(), layer(x).float())


def _path_specs(tree, jax_side: bool) -> dict:
    """``"layers/0/qkv/planes/0" -> spec tuple`` of a spec tree."""
    if jax_side:
        leaves = jax.tree_util.tree_flatten_with_path(tree, is_leaf=lambda x: isinstance(x, P))[0]
        name = lambda e: str(getattr(e, "key", getattr(e, "idx", getattr(e, "name", e))))  # noqa: E731
        return {"/".join(name(e) for e in path): tuple(spec) for path, spec in leaves}
    out = {}

    def visit(node, path):
        if isinstance(node, dict):
            for k, v in node.items():
                visit(v, path + (str(k),))
        elif isinstance(node, list) or (isinstance(node, tuple) and node and
                                        isinstance(node[0], tuple)):
            for i, v in enumerate(node):
                visit(v, path + (str(i),))
        elif node is not None:
            out["/".join(path)] = node

    visit(tree, ())
    return out


@pytest.fixture(scope="module")
def jax_trees():
    """JAX's tiny params: Llama unfused (chunk 128) and fused, Gemma-2
    (chunk 128), and Llama dense."""
    lcfg, gcfg = jllama.LlamaConfig.tiny(), jgemma2.Gemma2Config.tiny()
    lp = jllama.init_params(lcfg, rng=0)
    return {
        "llama": jllama.quantize_model(lp, 4, 64, chunk=128),
        "llama_fused": jllama.quantize_model(lp, 4, 64, chunk=128, fuse=True),
        "gemma2": jgemma2.quantize_model(jgemma2.init_params(gcfg, rng=0), 4, 64, chunk=128),
        "llama_dense": lp,
    }


@pytest.mark.parametrize("key", ["llama", "llama_fused", "gemma2", "llama_dense"])
def test_partition_specs_match_jax(jax_trees, key):
    params = interop.params_from_numpy(to_numpy_tree(jax_trees[key]), device="cpu")
    got = _path_specs(llama_partition_specs(params), False)
    want = _path_specs(jspecs(jax_trees[key]), True)
    assert got == want
    assert any("tp" in s for s in got.values())


def test_fused_member_widths():
    c = llama.LlamaConfig.llama31_8b()
    assert fused_member_widths(c, "qkv") == (4096, 1024, 1024)
    assert fused_member_widths(c, "gate_up") == (14336, 14336)


def _skeletons(config, jconfig, fused: bool):
    """Shape-only trees of one block (o and down with their K), port and JAX."""
    qdim = config.num_heads * config.head_dim

    def port(k, n):
        meta = lambda *s: torch.empty(s, device="meta")  # noqa: E731
        return QuantizedLinear([meta(k // 8, n)], meta(k // 64, n), meta(16),
                               config_key=KernelConfig().key())

    def jax_side(k, n):
        sds = jax.ShapeDtypeStruct
        return jnn.QuantizedLinear(planes=(sds((k // 8, n), jnp.int32),),
                                   scales=sds((k // 64, n), jnp.bfloat16),
                                   table=sds((16,), jnp.float32),
                                   config_key=JKernelConfig().key())

    extra = {"qkv": None, "gate_up": None} if fused else {}
    h, i = config.hidden_size, config.intermediate_size
    return ({"layers": [dict(o=port(qdim, h), down=port(i, h), **extra)]},
            {"layers": [dict(o=jax_side(qdim, h), down=jax_side(i, h), **extra)]})


def _accepts(fn, *args) -> bool:
    try:
        fn(*args)
        return True
    except ValueError:
        return False


PRESETS = {
    "llama31_8b": (llama.LlamaConfig.llama31_8b, jllama.LlamaConfig.llama31_8b),
    "llama31_70b": (llama.LlamaConfig.llama31_70b, jllama.LlamaConfig.llama31_70b),
    "llama31_405b": (llama.LlamaConfig.llama31_405b, jllama.LlamaConfig.llama31_405b),
    "gemma2_9b": (gemma2.Gemma2Config.gemma2_9b, jgemma2.Gemma2Config.gemma2_9b),
    "gemma2_27b": (gemma2.Gemma2Config.gemma2_27b, jgemma2.Gemma2Config.gemma2_27b),
}


@pytest.mark.parametrize("preset", list(PRESETS))
def test_validate_tp_presets_match_jax(preset):
    """The counterpart of ``test_zoo_topologies.py::test_tp_divisibility``:
    the presets at tp 1-16, fused and not, accepted and refused alike."""
    config, jconfig = (f() for f in PRESETS[preset])
    verdicts = []
    for fused in (False, True):
        tree, jtree = _skeletons(config, jconfig, fused)
        for tp in (1, 2, 3, 4, 8, 16):
            got = _accepts(validate_tp, tree, config, tp)
            assert got == _accepts(jvalidate, jtree, jconfig, tp), (fused, tp)
            verdicts.append(got)
    assert any(verdicts) and not all(verdicts)


def test_validate_tp_tiny_trees_match_jax(jax_trees):
    for key in ("llama", "llama_fused", "gemma2"):
        params = interop.params_from_numpy(to_numpy_tree(jax_trees[key]), device="cpu")
        cfg = gemma2.Gemma2Config.tiny() if key == "gemma2" else llama.LlamaConfig.tiny()
        jcfg = jgemma2.Gemma2Config.tiny() if key == "gemma2" else jllama.LlamaConfig.tiny()
        for tp in (1, 2, 3, 4):
            assert _accepts(validate_tp, params, cfg, tp) == _accepts(
                jvalidate, jax_trees[key], jcfg, tp), (key, tp)
    assert _accepts(validate_tp, params, cfg, 2) and not _accepts(validate_tp, params, cfg, 4)


def test_validate_tp_refuses_higgs_groups_split_across_ranks():
    """A HIGGS ``down`` with K = 1536 and a rotation of 512 at tp = 2 keeps
    768 rows a rank: a chunk multiple, so JAX's ``validate_tp`` accepts it,
    and its rank forward then raises on the split rotation group (as
    Llama-3.1-8B's down at tp = 8, 1792 rows against 512, would). The port
    refuses it up front."""
    rng = np.random.default_rng(5)
    k, n, e = 1536, 256, 4
    codes = rng.integers(0, e * e, (k // 2, n))
    grid = rng.standard_normal((e * e, 2)).astype(np.float32)
    scales = jnp.asarray(rng.random((k // 64, n)) + 0.5, jnp.bfloat16)
    jlayer = jfrom_higgs(codes, grid, scales, num_bits=2, group_size=64, hadamard_size=512)
    cfg, jcfg = llama.LlamaConfig.tiny(), jllama.LlamaConfig.tiny()
    jvalidate({"layers": [{"down": jlayer}]}, jcfg, 2)
    shard = jshard(jlayer, 2, "k")[0]
    with pytest.raises(ValueError, match="had_size"):
        shard(jnp.ones((1, k // 2), jnp.bfloat16))
    layer = port_layer(jlayer)
    with pytest.raises(ValueError, match="Hadamard"):
        validate_tp({"layers": [{"down": layer}]}, cfg, 2)
    whole = port_layer(jfrom_higgs(codes, grid, scales, num_bits=2, group_size=64,
                                   hadamard_size=256))
    validate_tp({"layers": [{"down": whole}]}, cfg, 2)  # 768 rows a rank: whole groups


# ---------------------------------------------------------------------------
# Worlds: the TP forward against JAX's
# ---------------------------------------------------------------------------

TOKENS = np.random.default_rng(4).integers(0, 100, (4, 8)).astype(np.int64)
CACHE_LEN = 16
TP2_CASES = [("llama", "llama", False), ("llama_fused", "llama", True), ("gemma2", "gemma2", False)]
DP_CASES = [("llama", "llama", False), ("gemma2", "gemma2", False)]


def _jax_tp2(jtree, family, fused):
    """JAX's served TP forward (tp_model_forward over a tp = 2 mesh)."""
    jcfg = jgemma2.Gemma2Config.tiny() if family == "gemma2" else jllama.LlamaConfig.tiny()
    model = jgemma2 if family == "gemma2" else jllama
    from flute_tpu.parallel import permute_fused_params

    mesh = jmake_mesh(tp=2, dp=1)
    params = permute_fused_params(jtree, jcfg, 2) if fused else jtree
    specs = jspecs(params)
    fwd = jtp_model_forward(jcfg, mesh, specs, base_forward=model.forward)
    cache = model.init_cache(jcfg, TOKENS.shape[0], CACHE_LEN)
    logits, _ = jax.jit(lambda p, t, c: fwd(p, jcfg, t, c, jnp.int32(0)))(
        jshard_params(params, mesh, specs), jnp.asarray(TOKENS, jnp.int32), cache)
    return np.asarray(logits)


@pytest.fixture(scope="module")
def world_dp2_tp2(jax_trees):
    """One world of 4 on a dp = 2 x tp = 2 mesh: the tp = 2 forwards on each
    tp row, the dp x tp forwards, and the hybrid mesh's groups."""
    def cases(table):
        return [(fam, to_numpy_tree(jax_trees[key]), fused, TOKENS, CACHE_LEN)
                for key, fam, fused in table]

    return launch.run(torch_tp_ranks.forward_rank, 4, cases(TP2_CASES), cases(DP_CASES), 2,
                      threads=1, timeout=300)


@pytest.mark.parametrize("case", range(len(TP2_CASES)), ids=[c[0] for c in TP2_CASES])
def test_tp2_forward_matches_jax_tp_forward(jax_trees, world_dp2_tp2, case):
    """The served tp = 2 forward on each tp row of the world against JAX's
    ``tp_model_forward`` on a tp = 2 mesh."""
    key, family, fused = TP2_CASES[case]
    want = _jax_tp2(jax_trees[key], family, fused)
    got = [w["tp_cases"][case] for w in world_dp2_tp2]
    assert got[0]["logits"].shape == want.shape
    assert max_rel(got[0]["logits"], want) < BF16_RTOL
    layers = jllama.LlamaConfig.tiny().num_layers
    for r in got:
        np.testing.assert_array_equal(r["logits"], got[0]["logits"])  # ranks agree bit for bit
        assert r["all_reduces"] == 2 * layers
    assert [w["coords"] for w in world_dp2_tp2] == [(0, 0), (0, 1), (1, 0), (1, 1)]


@pytest.mark.parametrize("case", range(len(DP_CASES)), ids=[c[0] for c in DP_CASES])
def test_dp_tp_forward_matches_jax(jax_trees, world_dp2_tp2, case):
    """``tp_forward_fn`` on dp = 2 x tp = 2 against JAX's on its 4-device
    mesh: the gathered logits and each rank's (batch, head) block of the
    KV cache."""
    key, family, _ = DP_CASES[case]
    jcfg = jgemma2.Gemma2Config.tiny() if family == "gemma2" else jllama.LlamaConfig.tiny()
    model = jgemma2 if family == "gemma2" else jllama
    mesh = jmake_mesh(tp=2, dp=2)
    specs = jspecs(jax_trees[key])
    step = jtp_forward_fn(jcfg, mesh, specs, forward=model.forward)
    b = TOKENS.shape[0]
    logits, cache = step(jshard_params(jax_trees[key], mesh, specs), jnp.asarray(TOKENS, jnp.int32),
                         model.init_cache(jcfg, b, CACHE_LEN), 0, jnp.zeros((b,), jnp.int32))
    want_k = np.asarray(cache["k"][0], np.float32)
    for w in world_dp2_tp2:
        got = w["dp_cases"][case]
        assert max_rel(got["logits"], logits) < BF16_RTOL
        np.testing.assert_array_equal(got["logits"], world_dp2_tp2[0]["dp_cases"][case]["logits"])
        d, t = w["coords"]
        hk = jcfg.num_kv_heads // 2
        block = want_k[d * b // 2:(d + 1) * b // 2, t * hk:(t + 1) * hk]
        np.testing.assert_allclose(got["k0"], block, atol=2e-2, rtol=0)
        assert got["all_reduces"] == 2 * jcfg.num_layers


def test_hybrid_mesh_groups(world_dp2_tp2):
    """make_hybrid_mesh(tp=2, dp_dcn=2): tp rows (0, 1), (2, 3); dp
    columns (0, 2), (1, 3)."""
    got = [w["hybrid"] for w in world_dp2_tp2]
    assert got == [((0, 0), 1.0, 2.0), ((0, 1), 1.0, 4.0), ((1, 0), 5.0, 2.0), ((1, 1), 5.0, 4.0)]


def test_a_failing_rank_fails_the_world():
    with pytest.raises(RuntimeError, match="rank 1 gives up"):
        launch.run(torch_tp_ranks.failing_rank, 2, 1, threads=1, timeout=120)


def test_a_rank_that_never_joins_does_not_hang_the_world():
    t0 = time.perf_counter()
    with pytest.raises((RuntimeError, TimeoutError)):
        launch.run(torch_tp_ranks.hanging_rank, 2, threads=1, timeout=6)
    assert time.perf_counter() - t0 < 40
