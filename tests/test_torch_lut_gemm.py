"""The port's LUT-GEMM against the JAX package's.

On this host the port runs its plain version (CPU tensors) and the JAX
package runs its Pallas kernel in interpret mode, as its own tests do. The
same numpy inputs go to both: identity input is bit-exact, random input is
within the reference thresholds (f16 2e-3, bf16 1.1e-2, f32 1e-5), and bad
shapes raise the same ValueErrors. The kernel-vs-plain checks on the card
are in ``test_torch_cuda.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flute_tpu import packing as jpacking
from flute_tpu.ops import lut_gemm as jlut
from flute_tpu_torch import packing
from flute_tpu_torch.ops import lut_gemm
from flute_tpu_torch.ops.kernel_config import KernelConfig, launch_config

DTYPES = {
    "bfloat16": (jnp.bfloat16, torch.bfloat16, 1.1e-2),
    "float16": (jnp.float16, torch.float16, 2.0e-3),
    "float32": (jnp.float32, torch.float32, 1e-5),
}
N, K, G = 256, 512, 64


def rel_err(y, y_ref):
    y = np.asarray(y, dtype=np.float64)
    y_ref = np.asarray(y_ref, dtype=np.float64)
    return np.linalg.norm(y - y_ref) / np.linalg.norm(y_ref)


def f32(a):
    return np.asarray(a.float().numpy() if isinstance(a, torch.Tensor) else a, np.float32)


def sym_table(rng, mixed_signs=False):
    mags = rng.standard_normal(8).astype(np.float32)
    if not mixed_signs:
        mags = np.sort(np.abs(mags))
    return np.concatenate([mags, -mags])


def w4sym_case(m, dtype, seed, chunk=256, mixed_signs=False):
    jd, td, _ = DTYPES[dtype]
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 16, size=(K, N), dtype=np.int32)
    plane = packing.pack_w4_sym_np(codes, chunk=chunk)[0]
    scales = rng.uniform(0.5, 1.5, (K // G, N)).astype(np.float32)
    table = sym_table(rng, mixed_signs)
    x = rng.standard_normal((m, K)).astype(np.float32)
    jax_in = (jnp.asarray(x, jd), [jnp.asarray(plane)], jnp.asarray(scales, jd), jnp.asarray(table))
    t_in = (
        torch.from_numpy(x).to(td), [torch.from_numpy(plane)],
        torch.from_numpy(scales).to(td), torch.from_numpy(table),
    )
    return codes, jax_in, t_in


@pytest.mark.parametrize("mixed_signs", [False, True])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_w4sym_identity_bit_exact_vs_jax(dtype, mixed_signs):
    jd, td, _ = DTYPES[dtype]
    codes, (_, _, sj, tj), (_, planes, st, tt) = w4sym_case(1, dtype, 0, mixed_signs=mixed_signs)
    got = lut_gemm.lut_qgemm(
        torch.eye(K, dtype=td), planes, st, tt, num_bits=4, layout="w4sym"
    )
    want = jlut.dequantize_codes(jnp.asarray(codes), sj, tj, jd)
    np.testing.assert_array_equal(f32(got), f32(want))


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("m", [1, 7, 32])
def test_w4sym_random_vs_jax_kernel(dtype, m):
    _, (xj, pj, sj, tj), (xt, pt, st, tt) = w4sym_case(m, dtype, 1)
    want = jlut.lut_qgemm(xj, pj, sj, tj, num_bits=4, layout="w4sym")
    got = lut_gemm.lut_qgemm(xt, pt, st, tt, num_bits=4, layout="w4sym")
    assert got.dtype == DTYPES[dtype][1] and tuple(got.shape) == (m, N)
    assert rel_err(f32(got), f32(want)) < DTYPES[dtype][2]


def test_w4sym_chunk_from_config_and_batch_dims():
    """chunk travels in the config (128 here); x may carry batch dims."""
    _, (xj, _, sj, tj), _ = w4sym_case(6, "bfloat16", 2)
    codes, _, (xt, _, st, tt) = w4sym_case(6, "bfloat16", 2, chunk=128)
    plane = torch.from_numpy(packing.pack_w4_sym_np(codes, chunk=128)[0])
    got = lut_gemm.lut_qgemm(
        xt.reshape(2, 3, K), plane, st, tt, num_bits=4, layout="w4sym",
        config=KernelConfig(chunk=128),
    )
    want = jlut.lut_qgemm_reference(xj, jnp.asarray(codes), sj, tj)
    assert tuple(got.shape) == (2, 3, N)
    assert rel_err(f32(got.reshape(6, N)), f32(want)) < 1.1e-2


@pytest.mark.parametrize("layout", ["plane2", "plane3", "plane4", "w3wide"])
def test_other_layouts_plain_vs_jax(layout):
    """On the CPU every layout runs the plain version."""
    bits = 3 if layout == "w3wide" else int(layout[-1])
    rng = np.random.default_rng(bits)
    codes = rng.integers(0, 2**bits, size=(K, N), dtype=np.int32)
    planes = (
        packing.pack_w3_wide_np(codes) if layout == "w3wide" else packing.pack_np(codes, bits)
    )
    table = np.sort(rng.standard_normal(2**bits)).astype(np.float32)
    scales = rng.uniform(0.5, 1.5, (K // G, N)).astype(np.float32)
    x = rng.standard_normal((3, K)).astype(np.float32)
    want = jlut.lut_qgemm(
        jnp.asarray(x, jnp.bfloat16), [jnp.asarray(p) for p in planes],
        jnp.asarray(scales, jnp.bfloat16), jnp.asarray(table), num_bits=bits,
    )
    got = lut_gemm.lut_qgemm(
        torch.from_numpy(x).bfloat16(), [torch.from_numpy(p) for p in planes],
        torch.from_numpy(scales).bfloat16(), torch.from_numpy(table), num_bits=bits,
    )
    assert rel_err(f32(got), f32(want)) < 1.1e-2
    eye = torch.eye(K, dtype=torch.float32)
    got_eye = lut_gemm.lut_qgemm(
        eye, [torch.from_numpy(p) for p in planes], torch.from_numpy(scales),
        torch.from_numpy(table), num_bits=bits,
    )
    want_eye = jlut.dequantize_codes(
        jnp.asarray(codes), jnp.asarray(scales), jnp.asarray(table), jnp.float32
    )
    np.testing.assert_array_equal(f32(got_eye), f32(want_eye))


def test_pair_values_plain_vs_jax_oracle():
    rng = np.random.default_rng(3)
    codes = rng.integers(0, 4, size=(K, N), dtype=np.int32)
    pv = rng.standard_normal((4, 4, 2)).astype(np.float32)
    scales = rng.uniform(0.5, 1.5, (K // G, N)).astype(np.float32)
    planes = [torch.from_numpy(p) for p in packing.pack_np(codes, 2)]
    got = lut_gemm.lut_qgemm(
        torch.eye(K), planes, torch.from_numpy(scales), torch.zeros(4), num_bits=2,
        pair_values=torch.from_numpy(pv),
    )
    want = jlut.dequantize_codes_pair(
        jnp.asarray(codes), jnp.asarray(scales), jnp.asarray(pv), jnp.float32
    )
    np.testing.assert_array_equal(f32(got), f32(want))


@pytest.mark.parametrize("bits", [2, 3, 4])
def test_pair_lut_without_pair_values_vs_jax(bits, monkeypatch):
    """``lut_mode="pair_lut"`` and no ``pair_values``: both packages look the
    weights up in pairs from the separable joint table of the scalar one
    (JAX's kernel in interpret mode); on the CPU the port takes the pair
    path of its plain version."""
    from flute_tpu.ops.kernel_config import KernelConfig as JKernelConfig

    rng = np.random.default_rng(40 + bits)
    codes = rng.integers(0, 2**bits, size=(K, N), dtype=np.int32)
    planes = packing.pack_np(codes, bits)
    table = rng.standard_normal(2**bits).astype(np.float32)
    scales = rng.uniform(0.5, 1.5, (K // G, N)).astype(np.float32)
    x = rng.standard_normal((5, K)).astype(np.float32)
    want = jlut.lut_qgemm(
        jnp.asarray(x, jnp.bfloat16), [jnp.asarray(p) for p in planes],
        jnp.asarray(scales, jnp.bfloat16), jnp.asarray(table), num_bits=bits,
        config=JKernelConfig(block_m=8, block_n=128, block_k=256, lut_mode="pair_lut"),
    )
    pair_calls = []
    pair = lut_gemm.dequantize_codes_pair
    monkeypatch.setattr(lut_gemm, "dequantize_codes_pair",
                        lambda *a: pair_calls.append(a[2]) or pair(*a))
    tplanes = [torch.from_numpy(p) for p in planes]
    args = (torch.from_numpy(x).bfloat16(), tplanes, torch.from_numpy(scales).bfloat16(),
            torch.from_numpy(table))
    got = lut_gemm.lut_qgemm(*args, num_bits=bits, config=KernelConfig(lut_mode="pair_lut"))
    assert len(pair_calls) == 1 and tuple(pair_calls[0].shape) == (2**bits, 2**bits, 2)
    assert rel_err(f32(got), f32(want)) < 1.1e-2
    # the same values as the scalar lookup: both round table[c] to bf16
    scalar = lut_gemm.lut_qgemm(*args, num_bits=bits)
    np.testing.assert_array_equal(f32(got), f32(scalar))
    assert len(pair_calls) == 1


def _bad_cases():
    rng = np.random.default_rng(9)
    codes = rng.integers(0, 16, size=(256, 128), dtype=np.int32)
    plane = packing.pack_w4_sym_np(codes)[0]
    p4 = packing.pack_np(codes, 4)[0]
    p3 = packing.pack_np(codes % 8, 3)
    scales = np.ones((4, 128), np.float32)
    table = sym_table(rng)
    x = np.ones((2, 256), np.float32)
    return {
        "w4sym_needs_4_bits": (x, [plane], scales, table, dict(num_bits=3, layout="w4sym")),
        "w4sym_plane_shape": (x, [plane[:16]], scales, table, dict(num_bits=4, layout="w4sym")),
        "plane_shape": (x, [p4[:16]], scales, table, dict(num_bits=4)),
        "plane_count": (x, p3[:1] + p3, scales, np.arange(8, dtype=np.float32), dict(num_bits=3)),
        "k_not_divisible": (x[:, :200], [p4], scales[:3], table, dict(num_bits=4)),
        "table_entries": (x, [p4], scales, table[:8], dict(num_bits=4)),
        "unknown_layout": (x, [p4], scales, table, dict(num_bits=4, layout="bogus")),
        "w3wide_needs_wide": (x, p3, scales, np.arange(8, dtype=np.float32),
                              dict(num_bits=3, layout="w3wide")),
    }


@pytest.mark.parametrize("case", list(_bad_cases()))
def test_same_value_errors_as_jax(case):
    x, planes, scales, table, kw = _bad_cases()[case]
    with pytest.raises(ValueError):
        jlut.lut_qgemm(
            jnp.asarray(x), [jnp.asarray(p) for p in planes], jnp.asarray(scales),
            jnp.asarray(table), **kw,
        )
    with pytest.raises(ValueError):
        lut_gemm.lut_qgemm(
            torch.from_numpy(x), [torch.from_numpy(p) for p in planes],
            torch.from_numpy(scales), torch.from_numpy(table), **kw,
        )


def test_qgemm_group_size_check():
    _, (xj, pj, sj, tj), (xt, pt, st, tt) = w4sym_case(2, "bfloat16", 4)
    with pytest.raises(ValueError):
        jlut.qgemm(xj, pj, sj, tj, 4, 128)
    with pytest.raises(ValueError):
        lut_gemm.qgemm(xt, pt, st, tt, 4, 128, layout="w4sym")
    y = lut_gemm.qgemm(xt, pt, st, tt, 4, G, layout="w4sym")
    assert tuple(y.shape) == (2, N)


@pytest.mark.parametrize("chunk", [128, 256])
def test_reconstruct_and_unpack_via_kernel(chunk):
    codes, (_, _, sj, tj), (_, _, st, tt) = w4sym_case(1, "bfloat16", 5)
    plane = torch.from_numpy(packing.pack_w4_sym_np(codes, chunk=chunk)[0])
    back = packing.unpack_via_kernel([plane], 4, N, K, chunk=chunk, layout="w4sym")
    np.testing.assert_array_equal(back.numpy(), codes)
    want = jlut.dequantize_codes(jnp.asarray(codes), sj, tj, jnp.bfloat16)
    for use_kernel in (True, False):
        got = packing.reconstruct(
            [plane], st, tt, 4, chunk=chunk, use_kernel=use_kernel, layout="w4sym"
        )
        np.testing.assert_array_equal(f32(got), f32(want))
    for bits in (2, 3, 4):
        c = codes % (2**bits)
        planes = [torch.from_numpy(p) for p in packing.pack_np(c, bits, chunk=chunk)]
        back = packing.unpack_via_kernel(planes, bits, N, K, chunk=chunk)
        np.testing.assert_array_equal(back.numpy(), c)
    wide = [torch.from_numpy(packing.pack_w3_wide_np(codes % 8)[0])]
    np.testing.assert_array_equal(packing.unpack_via_kernel(wide, 3, N, K).numpy(), codes % 8)
    jback = jpacking.unpack_via_kernel(
        [jnp.asarray(packing.pack_w4_sym_np(codes)[0])], 4, N, K, layout="w4sym"
    )
    np.testing.assert_array_equal(np.asarray(jback), codes)


def test_kernel_config_keys_roundtrip():
    from flute_tpu.ops.kernel_config import KernelConfig as JKernelConfig

    for key in ("m16n2048k1024_gather8_c256_s1", "m8n512k512_pair_lut_c128_s1_alow"):
        cfg = KernelConfig.from_key(key)
        jcfg = JKernelConfig.from_key(key)
        assert cfg.key() == jcfg.key() == key
        assert cfg.chunk == jcfg.chunk
    with pytest.raises(ValueError):
        KernelConfig.from_key("nonsense")
    assert [launch_config(m).block_m for m in (1, 2, 3, 8, 9, 512)] == [1, 2, 4, 8, 8, 8]


# JAX's kernel takes its weight-side branch (each weight scaled before one
# dot per (bm, bk) block, flute_tpu/ops/lut_gemm.py:611-615) above
# group_acc_max_bm rows per block: a block of 128 rows
WEIGHT_SIDE = dict(block_m=128, block_n=256, block_k=256, chunk=256)


@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
@pytest.mark.parametrize("m", [130, 256])
@pytest.mark.parametrize("layout", ["w4sym", "plane2", "plane3", "plane4", "w3wide", "pair2",
                                    "pair3", "pair4"])
def test_weight_side_branch_vs_port(layout, m, dtype):
    """The TPU kernel's prefill regime (the branch the port's wide-M kernel
    replaces) against the port's ``lut_qgemm`` on the same numpy inputs, at
    a ragged and a whole number of 128-row blocks: K1 (w4sym), K2 (plane),
    K3 (w3wide) and K4 (the joint pair table: ``pair_values``, JAX's
    ``pair_lut`` mode)."""
    from flute_tpu.ops.kernel_config import KernelConfig as JKernelConfig

    assert WEIGHT_SIDE["block_m"] > jlut._group_acc_max_bm()
    jd, td, tol = DTYPES[dtype]
    bits = {"w4sym": 4, "w3wide": 3}.get(layout) or int(layout[-1])
    rng = np.random.default_rng(90 + bits + m + 7 * layout.startswith("pair"))
    codes = rng.integers(0, 2**bits, size=(K, N), dtype=np.int32)
    pv = None
    if layout == "w4sym":
        planes = packing.pack_w4_sym_np(codes)
        table = sym_table(rng, mixed_signs=True)
    elif layout == "w3wide":
        planes = packing.pack_w3_wide_np(codes)
        table = rng.standard_normal(8).astype(np.float32)
    else:
        planes = packing.pack_np(codes, bits)
        table = rng.standard_normal(2**bits).astype(np.float32)
        if layout.startswith("pair"):
            pv = rng.standard_normal((2**bits, 2**bits, 2)).astype(np.float32)
    scales = rng.uniform(0.5, 1.5, (K // G, N)).astype(np.float32)
    x = rng.standard_normal((m, K)).astype(np.float32)
    kind = layout if layout in ("w4sym", "w3wide") else "plane"
    config = dict(WEIGHT_SIDE, lut_mode="pair_lut") if pv is not None else WEIGHT_SIDE
    want = jlut.lut_qgemm(
        jnp.asarray(x, jd), [jnp.asarray(p) for p in planes], jnp.asarray(scales, jd),
        jnp.asarray(table), num_bits=bits, config=JKernelConfig(**config), layout=kind,
        pair_values=None if pv is None else jnp.asarray(pv), interpret=True,
    )
    got = lut_gemm.lut_qgemm(
        torch.from_numpy(x).to(td), [torch.from_numpy(p) for p in planes],
        torch.from_numpy(scales).to(td), torch.from_numpy(table), num_bits=bits, layout=kind,
        pair_values=None if pv is None else torch.from_numpy(pv),
    )
    assert got.dtype == td and tuple(got.shape) == (m, N)
    assert rel_err(f32(got), f32(want)) < tol


GROUP_ACC = dict(block_n=256, block_k=256, chunk=256)


@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
@pytest.mark.parametrize("m", [16, 40, 64])
@pytest.mark.parametrize("layout", ["w4sym", "plane2", "plane3", "plane4", "w3wide", "pair2",
                                    "pair3", "pair4"])
def test_group_acc_branch_vs_port(layout, m, dtype):
    """The TPU kernel's group-accumulating decode branch (blocks of at most
    ``group_acc_max_bm`` rows: the regime the port's mid route serves, the
    speculative verify's 40 rows and the paged engines' admissions among
    them) against the port's ``lut_qgemm`` on the same numpy inputs: K1
    (w4sym), K2 (plane), K3 (w3wide) and K4 (the joint pair table:
    ``pair_values``, JAX's ``pair_lut`` mode)."""
    from flute_tpu.ops.kernel_config import KernelConfig as JKernelConfig

    block_m = 16 if m <= 16 else 64
    assert block_m <= jlut._group_acc_max_bm()
    jd, td, tol = DTYPES[dtype]
    bits = {"w4sym": 4, "w3wide": 3}.get(layout) or int(layout[-1])
    rng = np.random.default_rng(140 + bits + m + 7 * layout.startswith("pair")
                                + 11 * (layout == "w3wide"))
    codes = rng.integers(0, 2**bits, size=(K, N), dtype=np.int32)
    pv = None
    if layout == "w4sym":
        planes = packing.pack_w4_sym_np(codes)
        table = sym_table(rng, mixed_signs=True)
    elif layout == "w3wide":
        planes = packing.pack_w3_wide_np(codes)
        table = rng.standard_normal(8).astype(np.float32)
    else:
        planes = packing.pack_np(codes, bits)
        table = rng.standard_normal(2**bits).astype(np.float32)
        if layout.startswith("pair"):
            pv = rng.standard_normal((2**bits, 2**bits, 2)).astype(np.float32)
    scales = rng.uniform(0.5, 1.5, (K // G, N)).astype(np.float32)
    x = rng.standard_normal((m, K)).astype(np.float32)
    kind = layout if layout in ("w4sym", "w3wide") else "plane"
    config = dict(block_m=block_m, **GROUP_ACC)
    if pv is not None:
        config["lut_mode"] = "pair_lut"
    want = jlut.lut_qgemm(
        jnp.asarray(x, jd), [jnp.asarray(p) for p in planes], jnp.asarray(scales, jd),
        jnp.asarray(table), num_bits=bits, config=JKernelConfig(**config), layout=kind,
        pair_values=None if pv is None else jnp.asarray(pv), interpret=True,
    )
    got = lut_gemm.lut_qgemm(
        torch.from_numpy(x).to(td), [torch.from_numpy(p) for p in planes],
        torch.from_numpy(scales).to(td), torch.from_numpy(table), num_bits=bits, layout=kind,
        pair_values=None if pv is None else torch.from_numpy(pv),
    )
    assert got.dtype == td and tuple(got.shape) == (m, N)
    assert rel_err(f32(got), f32(want)) < tol
