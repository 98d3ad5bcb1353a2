"""The port's tuner against ``tests/test_tune.py``'s contract: on the CPU
the static default and its memo, ``verify_config`` (identity bit for bit,
random input within the threshold, the planner's bits), the metadata round
trip and ``maybe_retune``, the registry saved and loaded, ``pick_verified``
skipping a failing candidate, and the host oracle against JAX's plain
product; and the Hopper config space: no candidate changes the split of K,
and every candidate gives the planner's bits on the CPU path."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flute_tpu.ops import lut_gemm as jlut
from flute_tpu.tune import _host_oracle as jax_host_oracle
from flute_tpu_torch import nn as tnn
from flute_tpu_torch import tune
from flute_tpu_torch.ops import kernel_config as kc
from flute_tpu_torch.ops.kernel_config import KernelConfig
from flute_tpu_torch.shapes import unique_nk

CPU = "cpu"


def test_tune_config_cpu_heuristic_and_memo():
    cfg = tune.tune_config(8, 1024, 512, 4, 64, device=CPU)
    assert isinstance(cfg, KernelConfig) and cfg == KernelConfig()
    # memoized: M below 16 shares the key
    assert tune.tune_config(3, 1024, 512, 4, 64, device=CPU) is cfg


def test_verify_config_passes_for_default_and_candidates():
    for cfg in [tune.tune_config(16, 512, 512, 4, 64, device=CPU),
                KernelConfig(m_tiles=2), KernelConfig(simt_block_m=4)]:
        tune.verify_config(cfg, n=512, k=512, num_bits=4, group_size=64, seeds=(0,), device=CPU)


def test_metadata_roundtrip_and_maybe_retune():
    rng = np.random.default_rng(0)
    w = torch.from_numpy(rng.standard_normal((256, 512)).astype(np.float32))
    layer = tnn.quantize_linear(w, num_bits=4, group_size=64)
    tuned = layer.with_config(dataclasses.replace(layer.config, m_tiles=2))
    meta = tune.metadata_for(tuned, m=8)
    assert tune.TuneMetaData.from_json(meta.to_json()) == meta
    assert meta.m_tiles == 2 and meta.layout == "w4sym" and meta.device_kind == "cpu"
    # same deployment -> the stored launch restored
    same = tune.maybe_retune(layer, meta, m=8)
    assert same.config_key == layer.config_key and same.config.m_tiles == 2
    # changed batch size -> retuned (CPU: the default), key kept
    retuned = tune.maybe_retune(layer, meta, m=256)
    assert retuned.config_key == layer.config_key and retuned.config.m_tiles == 0
    x = torch.from_numpy(rng.standard_normal((4, 512))).to(torch.bfloat16)
    assert torch.equal(layer(x), retuned(x)) and torch.equal(layer(x), same(x))


def test_registry_save_load(tmp_path):
    tune.tune_config(8, 1024, 512, 4, 64, device=CPU)
    key = tune._memo_key(40, 6144, 4096, 4, 64, "bfloat16", "cpu", "w4sym")
    tune._MEMO[key] = KernelConfig(m_tiles=1)
    path = str(tmp_path / "reg.json")
    tune.save_registry(path)
    saved = dict(tune._MEMO)
    tune._MEMO.clear()
    assert tune.load_registry(path) == len(saved) >= 2
    assert tune._MEMO == saved
    # a loaded entry short-circuits tuning and is what get_kernel_config gives
    assert tune.tune_config(40, 6144, 4096, 4, 64, layout="w4sym", device=CPU).m_tiles == 1
    if not torch.cuda.is_available():
        assert kc.get_kernel_config(40, 6144, 4096, 4, 64, layout="w4sym").m_tiles == 1
    # a key never carries the tuned launch: JAX's key grammar reads it
    from flute_tpu.ops.kernel_config import KernelConfig as JaxKernelConfig

    assert JaxKernelConfig.from_key(KernelConfig(m_tiles=1).key()).key() == KernelConfig().key()
    del tune._MEMO[key]


def test_pick_verified_rejects_failing_candidate():
    a, b, c = KernelConfig(m_tiles=1), KernelConfig(m_tiles=2), KernelConfig(m_tiles=4)
    timed = [(3.0, c), (1.0, a), (2.0, b)]
    best, t = tune.pick_verified(timed, lambda cfg: cfg is not a)
    assert best is b and t == 2.0
    best, t = tune.pick_verified(timed, lambda cfg: cfg is a)
    assert best is a and t == 1.0

    def raises(cfg):
        raise RuntimeError("boom")

    best, _ = tune.pick_verified(timed, raises)
    assert best is None


@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
def test_host_oracle_matches_jax(dtype):
    rng = np.random.default_rng(0)
    k, n, g = 256, 128, 64
    codes = rng.integers(0, 16, (k, n), dtype=np.int32)
    scales = rng.uniform(0.5, 1.5, (k // g, n)).astype(np.float32)
    table = np.sort(rng.standard_normal(16)).astype(np.float32)
    x = rng.standard_normal((8, k)).astype(np.float32)
    got = tune._host_oracle(x, codes, scales, table, getattr(torch, dtype))
    np.testing.assert_array_equal(got, jax_host_oracle(x, codes, scales, table,
                                                       getattr(jnp, dtype)))
    ref = np.asarray(jlut.lut_qgemm_reference(
        jnp.asarray(x, getattr(jnp, dtype)), jnp.asarray(codes),
        jnp.asarray(scales, getattr(jnp, dtype)), jnp.asarray(table)), np.float32)
    assert np.abs(got - ref).max() / np.abs(ref).max() < tune.RTOL[dtype]


@pytest.mark.parametrize("n,k", unique_nk(["llama3-8b"]) + [(28672, 4096), (6144, 4096)])
@pytest.mark.parametrize("m", [1, 8, 40, 512])
def test_candidates_never_change_the_split(n, k, m):
    """Every candidate launch keeps mma_plan's split (a function of N, K
    and the chunk), at each layout and dtype."""
    for layout, bits in (("w4sym", 4), ("auto", 3), ("plane", 2), ("pair", 4)):
        for dtype in (torch.bfloat16, torch.float16, torch.float32):
            cands = list(kc.get_candidate_configs(m, n, k, bits, 64, dtype, layout))
            if layout == "pair" and dtype == torch.float32:
                assert cands == []
                continue
            assert cands and all(c.key() == KernelConfig().key() for c in cands)
            path = kc.launch_path(dtype, bits, 256, layout)
            split = kc.mma_plan(m, n, k, 256).splits
            for c in cands:
                assert (c.m_tiles > 0) == (path == "mma")
                assert (c.simt_block_m > 0) == (path == "simt")
                assert kc.mma_plan(m, n, k, 256, c.m_tiles).splits == split
                assert kc.is_config_supported(c, m, n, k, bits, 64, dtype, layout)
            first = cands[0]
            planner = kc.mma_plan(m, n, k, 256).m_tiles if path == "mma" else \
                kc.launch_config(m).block_m
            assert (first.m_tiles or first.simt_block_m) == planner


def test_config_functions():
    assert not kc.is_config_supported(KernelConfig(m_tiles=3), 8, 512, 512, 4, 64, None, "w4sym")
    assert not kc.is_config_supported(KernelConfig(simt_block_m=4), 8, 512, 512, 4, 64,
                                      torch.bfloat16, "w4sym")
    assert kc.is_config_supported(KernelConfig(simt_block_m=4), 8, 512, 512, 4, 64,
                                  torch.float32, "w4sym")
    assert not kc.is_config_supported(KernelConfig(chunk=256), 8, 512, 384, 4, 64)
    assert not kc.is_config_supported(KernelConfig(chunk=128), 8, 512, 512, 3, 64, None, "w3wide")
    cfg = KernelConfig(m_tiles=1)
    assert kc.fit_config(cfg, 8, 256, 512, 4, 64) is cfg
    assert kc.fit_config(cfg, 16 * 65536, 256, 512, 4, 64).m_tiles == 0
    with pytest.raises(ValueError):
        kc.fit_config(cfg, 8, 256, 320, 4, 64)


@pytest.mark.parametrize("layout,bits", [("w4sym", 4), ("auto", 3), ("plane", 2)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_tuned_layer_gives_the_planners_bits(layout, bits, dtype):
    """A layer with each candidate launch (on the CPU the plain version,
    which ignores the launch) and ``tune_linear``'s layer keep the key and
    the bits."""
    rng = np.random.default_rng(bits)
    w = torch.from_numpy(rng.standard_normal((256, 512)).astype(np.float32))
    layer = tnn.quantize_linear(w, num_bits=bits, group_size=64,
                                symmetric=None if layout == "w4sym" else False,
                                wide=True if layout == "auto" else None, dtype=dtype)
    x = torch.from_numpy(rng.standard_normal((40, 512))).to(dtype)
    want = layer(x)
    for cfg in kc.get_candidate_configs(40, 256, 512, bits, 64, dtype, layer.kernel_layout):
        tuned = layer.with_config(dataclasses.replace(layer.config, m_tiles=cfg.m_tiles,
                                                      simt_block_m=cfg.simt_block_m))
        assert tuned.config_key == layer.config_key and torch.equal(tuned(x), want)
    tuned = tune.tune_linear(layer, 40)
    assert tuned.config_key == layer.config_key and torch.equal(tuned(x), want)
