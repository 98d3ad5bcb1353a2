"""Card-only checks of the port: each LUT-GEMM kernel (K1 w4sym, K2 plane at
2/3/4 bits, K3 w3wide, K4 joint pair lookup), each paged-attention kernel
(K5 decode, K6 verify) and each kernel of the Hopper lab (L1-L12) against its
plain version on the same CUDA tensors, and the model, Engine and
PagedEngine through the kernels.

Every test is marked ``cuda`` and skips without a GPU (the kernel has no CPU
mode). The file imports no JAX, so it also runs on a machine that has none:

    python -m pytest tests/test_torch_cuda.py -m cuda -q --noconftest

Tolerances: relative Frobenius error of the reference thresholds (bf16
1.1e-2, f16 2e-3, f32 1e-5); the kernel and the plain version differ only in
the order of their f32 sums. Identity input is bit-exact.
"""

import numpy as np
import pytest
import torch

from flute_tpu_torch import packing
from flute_tpu_torch.interop import move_params
from flute_tpu_torch.lab import kernel_lab, kernel_lab2, ops2
from flute_tpu_torch.lab import ops as lab
from flute_tpu_torch.models import llama
from flute_tpu_torch.ops import lut_gemm
from flute_tpu_torch.ops import paged_attention as pa
from flute_tpu_torch.ops.kernel_config import KernelConfig
from flute_tpu_torch.quantize import higgs
from flute_tpu_torch.serving import Engine, PagedEngine

pytestmark = pytest.mark.cuda

TOL = {torch.bfloat16: 1.1e-2, torch.float16: 2.0e-3, torch.float32: 1e-5}
DTYPES = list(TOL)
N, K, G = 384, 512, 64


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the LUT-GEMM kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def rel_err(y, ref):
    y, ref = y.double(), ref.double()
    return float(torch.linalg.norm(y - ref) / torch.linalg.norm(ref))


def w4sym_case(dev, m, dtype, seed, chunk=256, mixed_signs=False):
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 16, size=(K, N), dtype=np.int32)
    mags = rng.standard_normal(8).astype(np.float32)
    if not mixed_signs:
        mags = np.sort(np.abs(mags))
    table = np.concatenate([mags, -mags])
    scales = rng.uniform(0.5, 1.5, (K // G, N)).astype(np.float32)
    x = rng.standard_normal((m, K)).astype(np.float32)
    plane = packing.pack_w4_sym_np(codes, chunk=chunk)[0]
    return (
        torch.from_numpy(codes).to(dev),
        torch.from_numpy(x).to(dev, dtype),
        torch.from_numpy(plane).to(dev),
        torch.from_numpy(scales).to(dev, dtype),
        torch.from_numpy(table).to(dev),
    )


# (layout, bits, chunk): every kernel at each pack chunk its layout takes
KERNEL_CASES = [("w4sym", 4, 128), ("w4sym", 4, 256)] + [
    ("plane", b, c) for b in (2, 3, 4) for c in (128, 256)
] + [("w3wide", 3, 256), ("w3wide", 3, 512)]


def layout_case(dev, layout, bits, m, dtype, seed, chunk):
    """codes, x, planes, scales, table on ``dev`` for one layout: a random
    general table (any order and signs) for plane and w3wide."""
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 2**bits, size=(K, N), dtype=np.int32)
    if layout == "w4sym":
        planes = packing.pack_w4_sym_np(codes, chunk=chunk)
        mags = np.sort(np.abs(rng.standard_normal(8))).astype(np.float32)
        table = np.concatenate([mags, -mags])
    elif layout == "w3wide":
        planes = packing.pack_w3_wide_np(codes, chunk=chunk)
        table = rng.standard_normal(8).astype(np.float32)
    else:
        planes = packing.pack_np(codes, bits, chunk=chunk)
        table = rng.standard_normal(2**bits).astype(np.float32)
    scales = rng.uniform(0.5, 1.5, (K // G, N)).astype(np.float32)
    x = rng.standard_normal((m, K)).astype(np.float32)
    return (
        torch.from_numpy(codes).to(dev),
        torch.from_numpy(x).to(dev, dtype),
        [torch.from_numpy(p).to(dev) for p in planes],
        torch.from_numpy(scales).to(dev, dtype),
        torch.from_numpy(table).to(dev),
    )


@pytest.mark.parametrize("layout,bits,chunk", KERNEL_CASES)
@pytest.mark.parametrize("m", [1, 3, 8, 9, 40])
@pytest.mark.parametrize("dtype", DTYPES)
def test_kernel_vs_plain(dev, dtype, m, layout, bits, chunk):
    _, x, planes, s, t = layout_case(dev, layout, bits, m, dtype, seed=m, chunk=chunk)
    cfg = KernelConfig(chunk=chunk)
    before = dict(lut_gemm.LAUNCHES)
    y = lut_gemm.lut_qgemm(x, planes, s, t, num_bits=bits, layout=layout, config=cfg)
    assert lut_gemm.LAUNCHES == {**before, layout: before[layout] + 1}
    y_plain = lut_gemm.lut_qgemm_plain(x, planes, s, t, num_bits=bits, chunk=chunk,
                                       layout=layout)
    torch.cuda.synchronize()
    assert y.dtype == dtype and tuple(y.shape) == (m, N)
    assert rel_err(y, y_plain) < TOL[dtype]


@pytest.mark.parametrize("layout,bits,chunk", KERNEL_CASES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_identity_bit_exact_every_layout(dev, dtype, layout, bits, chunk):
    codes, _, planes, s, t = layout_case(dev, layout, bits, 1, dtype, seed=21, chunk=chunk)
    eye = torch.eye(K, dtype=dtype, device=dev)
    got = lut_gemm.qgemm(eye, planes, s, t, bits, G, layout=layout,
                         config=KernelConfig(chunk=chunk))
    want = lut_gemm.dequantize_codes(codes, s, t, dtype)
    assert torch.equal(got.float(), want.float())


@pytest.mark.parametrize("layout,bits,chunk", KERNEL_CASES)
def test_unpack_via_kernel_and_reconstruct_every_layout(dev, layout, bits, chunk):
    codes, _, planes, s, t = layout_case(dev, layout, bits, 1, torch.bfloat16, seed=22,
                                         chunk=chunk)
    before = dict(lut_gemm.LAUNCHES)
    back = packing.unpack_via_kernel(planes, bits, N, K, chunk=chunk, layout=layout)
    assert torch.equal(back, codes)
    with_kernel = packing.reconstruct(planes, s, t, bits, chunk=chunk, layout=layout)
    without = packing.reconstruct(planes, s, t, bits, chunk=chunk, use_kernel=False,
                                  layout=layout)
    assert torch.equal(with_kernel.float(), without.float())
    assert lut_gemm.LAUNCHES[layout] == before[layout] + 2


@pytest.mark.parametrize("mixed_signs", [False, True])
@pytest.mark.parametrize("dtype", DTYPES)
def test_identity_bit_exact(dev, dtype, mixed_signs):
    codes, _, plane, s, t = w4sym_case(dev, 1, dtype, seed=11, mixed_signs=mixed_signs)
    eye = torch.eye(K, dtype=dtype, device=dev)
    got = lut_gemm.qgemm(eye, plane, s, t, 4, G, layout="w4sym")
    want = lut_gemm.dequantize_codes(codes, s, t, dtype)
    assert torch.equal(got.float(), want.float())


def test_only_pair_values_raises_on_cuda(dev):
    """pair_values runs K4 in bf16/f16 on the plane layout; f32 and a wide
    3-bit plane with pair_values raise, as does w4sym."""
    _, x, planes, s, t = layout_case(dev, "plane", 4, 2, torch.bfloat16, seed=13, chunk=256)
    pv = torch.ones(16, 16, 2, device=dev)
    before = dict(lut_gemm.LAUNCHES)
    with pytest.raises(NotImplementedError, match="16-bit"):
        lut_gemm.lut_qgemm(x.float(), planes, s.float(), t, num_bits=4, pair_values=pv)
    _, x3, wide, s3, t3 = layout_case(dev, "w3wide", 3, 2, torch.bfloat16, seed=13, chunk=256)
    with pytest.raises(ValueError, match="wide"):
        lut_gemm.lut_qgemm(x3, wide, s3, t3, num_bits=3, pair_values=torch.ones(8, 8, 2, device=dev))
    with pytest.raises(ValueError, match="w4sym"):
        lut_gemm.lut_qgemm(x, planes, s, t, num_bits=4, layout="w4sym", pair_values=pv)
    assert lut_gemm.LAUNCHES == before
    lut_gemm.lut_qgemm(x, planes, s, t, num_bits=4, pair_values=pv)
    assert lut_gemm.LAUNCHES == {**before, "pair": before["pair"] + 1}


@pytest.mark.parametrize("bits", [2, 3, 4])
def test_pair_lut_without_pair_values_launches_k4(dev, bits):
    """lut_mode="pair_lut" with a scalar table runs K4 on its separable joint
    table (K2 not at all), with the scalar lookup's values; f32 raises."""
    _, x, planes, s, t = layout_case(dev, "plane", bits, 5, torch.bfloat16, seed=40 + bits,
                                     chunk=256)
    cfg = KernelConfig(lut_mode="pair_lut")
    before = dict(lut_gemm.LAUNCHES)
    y = lut_gemm.lut_qgemm(x, planes, s, t, num_bits=bits, config=cfg)
    assert lut_gemm.LAUNCHES == {**before, "pair": before["pair"] + 1}
    y_plain = lut_gemm.lut_qgemm_plain(x, planes, s, t, num_bits=bits, chunk=256,
                                       layout="plane")
    torch.cuda.synchronize()
    assert rel_err(y, y_plain) < TOL[torch.bfloat16]
    with pytest.raises(NotImplementedError, match="16-bit"):
        lut_gemm.lut_qgemm(x.float(), planes, s.float(), t, num_bits=bits, config=cfg)


def pair_case(dev, bits, m, dtype, seed, chunk):
    """codes, x, planes, scales and a random pair table on ``dev``."""
    codes, x, planes, s, _ = layout_case(dev, "plane", bits, m, dtype, seed, chunk)
    rng = np.random.default_rng(seed + 100)
    pv = torch.from_numpy(rng.standard_normal((2**bits, 2**bits, 2)).astype(np.float32)).to(dev)
    return codes, x, planes, s, pv


@pytest.mark.parametrize("chunk", [128, 256])
@pytest.mark.parametrize("bits", [2, 3, 4])
@pytest.mark.parametrize("m", [1, 3, 8, 9, 40])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_pair_kernel_vs_plain(dev, dtype, m, bits, chunk):
    _, x, planes, s, pv = pair_case(dev, bits, m, dtype, seed=m + bits, chunk=chunk)
    cfg = KernelConfig(chunk=chunk)
    zeros = torch.zeros(2**bits, device=dev)
    y = lut_gemm.lut_qgemm(x, planes, s, zeros, num_bits=bits, config=cfg, pair_values=pv)
    y_plain = lut_gemm.lut_qgemm_plain(x, planes, s, zeros, num_bits=bits, chunk=chunk,
                                       layout="plane", pair_values=pv)
    torch.cuda.synchronize()
    assert y.dtype == dtype and tuple(y.shape) == (m, N)
    assert rel_err(y, y_plain) < TOL[dtype]


@pytest.mark.parametrize("chunk", [128, 256])
@pytest.mark.parametrize("bits", [2, 3, 4])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_pair_identity_bit_exact(dev, dtype, bits, chunk):
    codes, _, planes, s, pv = pair_case(dev, bits, 1, dtype, seed=31, chunk=chunk)
    eye = torch.eye(K, dtype=dtype, device=dev)
    got = lut_gemm.qgemm(eye, planes, s, torch.zeros(2**bits, device=dev), bits, G,
                         config=KernelConfig(chunk=chunk), pair_values=pv)
    want = lut_gemm.dequantize_codes_pair(codes, s, pv, dtype)
    assert torch.equal(got.float(), want.float())


def test_pair_wrapper_checks(dev):
    _, x, planes, s, pv = pair_case(dev, 3, 2, torch.bfloat16, seed=32, chunk=256)
    kw = dict(num_bits=3, group_size=G, chunk=256)
    with pytest.raises(ValueError, match="pair_values"):
        lut_gemm.lut_qgemm_pair_cuda(x, planes, s, pv[:4], **kw)
    with pytest.raises(ValueError, match="pair_values"):
        lut_gemm.lut_qgemm_pair_cuda(x, planes, s, pv.half(), **kw)
    with pytest.raises(ValueError, match="plane"):
        lut_gemm.lut_qgemm_pair_cuda(x, planes[:1], s, pv, **kw)
    with pytest.raises(NotImplementedError, match="16-bit"):
        lut_gemm.lut_qgemm_pair_cuda(x.float(), planes, s.float(), pv, **kw)
    with pytest.raises(ValueError, match="on cpu"):
        lut_gemm.lut_qgemm_pair_cuda(x, planes, s, pv.cpu(), **kw)


def test_higgs_layer_through_the_kernel(dev):
    rng = np.random.default_rng(33)
    codes = rng.integers(0, 256, (K // 2, N))
    grid = rng.standard_normal((256, 2)).astype(np.float32)
    scales = torch.from_numpy(rng.uniform(0.5, 1.5, (K // G, N)).astype(np.float32))
    layer = higgs.from_higgs(codes, grid, scales.bfloat16().to(dev), num_bits=4, group_size=G,
                             hadamard_size=128, device=dev)
    x = torch.from_numpy(rng.standard_normal((5, K)).astype(np.float32)).to(dev, torch.bfloat16)
    before = lut_gemm.LAUNCHES["pair"]
    y = layer(x)
    assert lut_gemm.LAUNCHES["pair"] == before + 1
    cpu = move_params(layer, torch.device("cpu"))
    assert rel_err(y.cpu(), cpu(x.cpu())) < TOL[torch.bfloat16]


PAGED_OPTIONS = [(None, None), (50.0, None), (None, 10), (30.0, 24), (50.0, 3)]


def paged_case(dev, dtype, b, h, hkv, d, bs, mb, nb, seed, t=None):
    rng = np.random.default_rng(seed)
    shape = (b, h, d) if t is None else (b, t, h, d)
    q = torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dev, dtype)
    kp, vp = (torch.from_numpy(rng.standard_normal((nb, hkv, bs, d)).astype(np.float32))
              .to(dev, dtype) for _ in range(2))
    tables = torch.from_numpy(rng.permutation(nb)[: b * mb].reshape(b, mb).astype(np.int32))
    return q, kp, vp, tables.to(dev)


def max_rel(got, want):
    return float((got.float() - want.float()).abs().max() / want.float().abs().max())


@pytest.mark.parametrize("softcap,window", PAGED_OPTIONS)
@pytest.mark.parametrize("hkv,h,d,bs", [(2, 8, 128, 16), (4, 4, 128, 16), (8, 32, 128, 16),
                                         (2, 4, 256, 16), (2, 8, 64, 32), (2, 8, 128, 8)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_paged_decode_kernel_vs_plain(dev, dtype, hkv, h, d, bs, softcap, window):
    q, kp, vp, tables = paged_case(dev, dtype, 4, h, hkv, d, bs, 96 // bs, 32 * 16 // bs,
                                   seed=h + d)
    lengths = torch.tensor([37, 16, 96, 0], dtype=torch.int32, device=dev)
    kw = dict(softcap=softcap, window=window)
    before = pa.LAUNCHES["paged_decode"]
    got = pa.paged_decode_attention(q, kp, vp, tables, lengths, **kw)
    assert pa.LAUNCHES["paged_decode"] == before + 1
    want = pa.paged_gqa_reference(q, kp, vp, tables, lengths, **kw)
    torch.cuda.synchronize()
    assert got.dtype == dtype and torch.isfinite(got.float()).all()
    assert not got[3].float().any()  # a parked slot of length 0 gives zeros
    assert max_rel(got[:3], want[:3]) < TOL[torch.bfloat16]


@pytest.mark.parametrize("softcap,window", PAGED_OPTIONS)
@pytest.mark.parametrize("t", [1, 3, 16, 70])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_paged_verify_kernel_vs_plain(dev, dtype, t, softcap, window):
    q, kp, vp, tables = paged_case(dev, dtype, 3, 8, 2, 128, 16, 12, 40, seed=t, t=t)
    lengths = torch.tensor([15, 37, 0], dtype=torch.int32, device=dev)
    kw = dict(softcap=softcap, window=window)
    before = pa.LAUNCHES["paged_verify"]
    got = pa.paged_verify_attention(q, kp, vp, tables, lengths, **kw)
    assert pa.LAUNCHES["paged_verify"] == before + 1
    want = pa.paged_verify_reference(q, kp, vp, tables, lengths, **kw)
    torch.cuda.synchronize()
    assert tuple(got.shape) == tuple(q.shape) and torch.isfinite(got.float()).all()
    assert max_rel(got, want) < TOL[torch.bfloat16]


def test_paged_wrappers_on_the_card(dev):
    q, kp, vp, tables = paged_case(dev, torch.bfloat16, 2, 8, 2, 128, 16, 3, 8, seed=5)
    lengths = torch.tensor([20, 9], dtype=torch.int32, device=dev)
    want = pa.paged_decode_attention(q, kp, vp, tables, lengths)
    junk = tables.clone()
    junk[0, 2], junk[1, 1:] = 99, -4
    assert torch.equal(pa.paged_decode_attention(q, kp, vp, junk, lengths), want)
    with pytest.raises(ValueError, match="share"):
        pa.paged_decode_attention(q.half(), kp, vp, tables, lengths)
    with pytest.raises(ValueError, match="on cpu"):
        pa.paged_decode_attention(q, kp, vp, tables.cpu(), lengths)
    for d, bs in ((512, 16), (96, 16), (128, 64), (64, 2), (64, 8), (256, 4)):
        z = torch.zeros(8, 2, bs, d, device=dev, dtype=torch.bfloat16)
        with pytest.raises(ValueError, match="head_dim"):
            pa.paged_decode_attention(torch.zeros(2, 8, d, device=dev, dtype=torch.bfloat16),
                                      z, z, tables, lengths)


@pytest.mark.parametrize("pool_prefill", [False, True])
@pytest.mark.parametrize("case", ["w4sym", "higgs"])
def test_paged_engine_through_the_kernels(dev, case, pool_prefill):
    config = llama.LlamaConfig.tiny()
    params = llama.init_params(config, seed=0, device=dev)
    qparams = llama.quantize_model(params, group_size=G, fuse=True, device=dev)
    if case == "higgs":
        rng = np.random.default_rng(9)
        for layer in qparams["layers"]:
            for name in ("qkv", "o", "gate_up", "down"):
                k, n = layer[name].in_features, layer[name].out_features
                scales = torch.from_numpy(rng.uniform(0.015, 0.025, (k // G, n)).astype(np.float32))
                layer[name] = higgs.from_higgs(
                    rng.integers(0, 256, (k // 2, n)), rng.standard_normal((256, 2)),
                    scales.bfloat16().to(dev), num_bits=4, group_size=G, hadamard_size=128,
                    device=dev)
    gemm = "pair" if case == "higgs" else "w4sym"
    prompts = [[5, 9, 2, 14, 3, 8, 1, 6, 20, 21, 22], [11, 5, 3], [5, 9, 2, 14, 3, 8, 1, 6, 30]]
    kw = dict(num_slots=3, block_size=8, num_blocks=6, max_len=32, prefix_cache_blocks=2,
              pool_prefill=pool_prefill)
    eng = PagedEngine(params=qparams, config=config, device=dev, **kw)
    for d in (lut_gemm.LAUNCHES, pa.LAUNCHES):
        for k in d:
            d[k] = 0
    rids = [eng.submit(p, max_new_tokens=5) for p in prompts]
    decode_steps = 0
    while eng.step():
        decode_steps += 1
    out = eng.run()
    prefills = 3  # one forward (or pool chunk) per admission
    assert eng.prefix_hits == 1 and eng.blocks_in_use == 0
    assert [len(out[r]) for r in rids] == [5, 5, 5]
    want = {k: 0 for k in lut_gemm.LAUNCHES}
    want[gemm] = (decode_steps + prefills) * config.num_layers * 4
    assert lut_gemm.LAUNCHES == want
    assert pa.LAUNCHES == {"paged_decode": decode_steps * config.num_layers,
                           "paged_verify": (prefills if pool_prefill else 0) * config.num_layers}
    # the same requests on the CPU plain path give the same tokens
    cpu = PagedEngine(params=move_params(qparams, torch.device("cpu")), config=config,
                      device="cpu", **kw)
    crids = [cpu.submit(p, max_new_tokens=5) for p in prompts]
    cout = cpu.run()
    assert sum(out[r] == cout[c] for r, c in zip(rids, crids)) >= 2


def test_wrapper_checks(dev):
    _, x, plane, s, t = w4sym_case(dev, 2, torch.bfloat16, seed=14)
    kw = dict(group_size=G, chunk=256)
    with pytest.raises(ValueError, match="contiguous"):
        lut_gemm.lut_qgemm_w4sym_cuda(x.t().contiguous().t(), plane, s, t, **kw)
    with pytest.raises(ValueError, match="dtype"):
        lut_gemm.lut_qgemm_w4sym_cuda(x, plane, s.half(), t, **kw)
    with pytest.raises(ValueError, match="on cpu"):
        lut_gemm.lut_qgemm_w4sym_cuda(x, plane.cpu(), s, t, **kw)
    with pytest.raises(ValueError, match="int32"):
        lut_gemm.lut_qgemm_w4sym_cuda(x, plane[:-1], s, t, **kw)


def test_plane_and_w3wide_wrapper_checks(dev):
    _, x, p3, s, t = layout_case(dev, "plane", 3, 2, torch.bfloat16, seed=15, chunk=256)
    kw = dict(group_size=G, chunk=256)
    with pytest.raises(ValueError, match="plane"):
        lut_gemm.lut_qgemm_plane_cuda(x, p3[:1], s, t, num_bits=3, **kw)
    with pytest.raises(ValueError, match="int32"):
        lut_gemm.lut_qgemm_plane_cuda(x, [p3[0], p3[1][:-1]], s, t, num_bits=3, **kw)
    with pytest.raises(ValueError, match="table"):
        lut_gemm.lut_qgemm_plane_cuda(x, p3, s, t[:4], num_bits=3, **kw)
    with pytest.raises(ValueError, match="bits"):
        lut_gemm.lut_qgemm_plane_cuda(x, p3, s, t, num_bits=8, **kw)
    with pytest.raises(ValueError, match="chunk"):
        lut_gemm.lut_qgemm_plane_cuda(x, p3, s, t, num_bits=3, group_size=G, chunk=48)
    with pytest.raises(ValueError, match="on cpu"):
        lut_gemm.lut_qgemm_plane_cuda(x, p3, s.cpu(), t, num_bits=3, **kw)
    _, x, wide, s, t = layout_case(dev, "w3wide", 3, 2, torch.float16, seed=16, chunk=256)
    with pytest.raises(ValueError, match="chunk"):
        lut_gemm.lut_qgemm_w3wide_cuda(x, wide[0], s, t, group_size=G, chunk=128)
    with pytest.raises(ValueError, match="dtype"):
        lut_gemm.lut_qgemm_w3wide_cuda(x, wide[0], s.float(), t, **kw)
    with pytest.raises(ValueError, match="contiguous"):
        lut_gemm.lut_qgemm_w3wide_cuda(x, wide[0].t().contiguous().t(), s, t, **kw)
    with pytest.raises(ValueError, match="int32"):
        lut_gemm.lut_qgemm_w3wide_cuda(x, wide[0][:-1], s, t, **kw)


# (quantize_model arguments, the kernel they run on)
MODEL_CASES = {
    "w4sym": (dict(num_bits=4), "w4sym"),
    "w3wide": (dict(num_bits=3), "w3wide"),
    "w4_general": (dict(num_bits=4, symmetric=False), "plane"),
    "w3_planes": (dict(num_bits=3, chunk=128), "plane"),
}


@pytest.mark.parametrize("case", list(MODEL_CASES))
def test_model_and_engine_through_the_kernel(dev, case):
    kw, kernel = MODEL_CASES[case]
    config = llama.LlamaConfig.tiny()
    params = llama.init_params(config, seed=0, device=dev)
    qparams = llama.quantize_model(params, group_size=G, fuse=True, device=dev, **kw)
    # only w4sym must travel as metadata; plane and w3wide are told by shape
    assert {layer["down"].layout for layer in qparams["layers"]} == {
        "w4sym" if kernel == "w4sym" else "auto"}
    qcpu = move_params(qparams, torch.device("cpu"))
    rng = np.random.default_rng(3)
    tokens = torch.from_numpy(rng.integers(0, config.vocab_size, (2, 16)))
    offsets = torch.tensor([0, 5])
    logits = {}
    for name, p, d in (("cuda", qparams, dev), ("cpu", qcpu, torch.device("cpu"))):
        cache = llama.init_cache(config, 2, 32, device=d)
        with torch.inference_mode():
            logits[name], _ = llama.forward(p, config, tokens.to(d), cache, 0, offsets.to(d))
    got, want = logits["cuda"].cpu(), logits["cpu"]
    assert float((got - want).abs().max() / want.abs().max()) < TOL[torch.bfloat16]

    prompts = [rng.integers(1, config.vocab_size, n).tolist() for n in (3, 11, 7)]
    eng = Engine(params=qparams, config=config, batch_size=4, max_len=64, device=dev)
    for k in lut_gemm.LAUNCHES:
        lut_gemm.LAUNCHES[k] = 0
    out = eng.generate(prompts, max_new_tokens=5)
    # one prefill and four decode steps, four projections in each of 2 layers,
    # all through the layout's kernel
    want_launches = {k: 0 for k in lut_gemm.LAUNCHES}
    want_launches[kernel] = 5 * config.num_layers * 4
    assert lut_gemm.LAUNCHES == want_launches
    assert [len(o) for o in out] == [5, 5, 5]


# the lab's variants at a width that is not a multiple of 32 (the column mask)
LAB_N, LAB_K = 200, 1024


def lab_case(dev, m, name, k=LAB_K):
    """The lab's inputs on ``dev`` (floor's planes masked to finite bf16
    halves) and variant ``name``'s function and flags."""
    _, planes, scales, table, x = kernel_lab.make_inputs(m, LAB_N, k, 4, G, device=dev)
    if name == "floor":
        planes = [lab.finite_halves(planes[0])]
    fn, flags = kernel_lab.VARIANTS[name]
    return x, planes, scales, table, fn, flags


@pytest.mark.parametrize("bk", [256, 512, 1024])
@pytest.mark.parametrize("name", list(kernel_lab.VARIANTS))
@pytest.mark.parametrize("m", [1, 16, 40])
def test_lab_kernel_vs_plain(dev, m, name, bk):
    x, planes, scales, table, fn, flags = lab_case(dev, m, name)
    before = dict(lab.LAUNCHES)
    y = lab.run(fn, x, planes, scales, table, m, LAB_N, bk, G, **flags)
    assert lab.LAUNCHES == {**before, fn: before[fn] + 1}
    want = lab.plain(fn, x, planes, scales, table, m, LAB_N, bk, G, **flags)
    torch.cuda.synchronize()
    assert y.dtype == torch.bfloat16 and tuple(y.shape) == (m, LAB_N)
    assert torch.isfinite(y.float()).all()
    if name == "unpack":  # subnormal operand: an absolute tolerance
        err = float((y.float() - want.float()).abs().max())
        assert float(want.float().abs().max()) > 0
        assert err <= TOL[torch.bfloat16] * float(want.float().abs().max())
    else:
        assert rel_err(y, want) < TOL[torch.bfloat16]


@pytest.mark.parametrize("name", list(kernel_lab.VARIANTS))
def test_lab_identity_bit_exact(dev, name):
    """With x the identity every output is one product: the kernel gives the
    plain version bit for bit (unpack_only: its subnormal operand)."""
    x, planes, scales, table, fn, flags = lab_case(dev, 512, name, k=512)
    eye = torch.eye(512, dtype=torch.bfloat16, device=dev)
    y = lab.run(fn, eye, planes, scales, table, 16, LAB_N, 256, G, **flags)
    want = lab.plain(fn, eye, planes, scales, table, 16, LAB_N, 256, G, **flags)
    assert torch.equal(y.view(torch.int16), want.view(torch.int16))
    if name == "unpack":
        assert torch.equal(y.view(torch.int16), lab.unpack_weight(planes[0]).view(torch.int16))


def test_lab_main_on_the_card(capsys):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the lab times its kernels on the card")
    before = dict(lab.LAUNCHES)
    rows = kernel_lab.main(["--n", "2048", "--k", "1024", "--bn", "256", "--bk", "512",
                            "--iters", "4", "--variants", ",".join(kernel_lab.ORDER)])
    assert [r["name"] for r in rows] == list(kernel_lab.ORDER)
    assert all(r["us"] > 0 for r in rows) and "GB/s" in capsys.readouterr().out
    assert all(lab.LAUNCHES[f] > before[f] for f in lab.LAUNCHES)


# the second lab at a width that is not a multiple of 32 (the column mask)
LAB2_N, LAB2_K = 200, 1024


def same_bits(y, want):
    """Bit for bit, the sign of a zero aside."""
    return bool(((y.view(torch.int16) == want.view(torch.int16)) | ((y == 0) & (want == 0))).all())


@pytest.mark.parametrize("name", kernel_lab2.LAB_GEMMS)
@pytest.mark.parametrize("m", [1, 16, 40])
def test_lab2_kernel_vs_plain(dev, m, name):
    inp = kernel_lab2.make_inputs(m, LAB2_N, LAB2_K, device=dev)
    fn, args = kernel_lab2.lab_call(name, inp, kernel_lab2.operands(name, inp), m, LAB2_N, 512)
    before = dict(ops2.LAUNCHES)
    y = ops2.FUNCTIONS[fn](*args)
    assert ops2.LAUNCHES == {**before, fn: before[fn] + 1}
    want = ops2.plain(fn, *args)
    torch.cuda.synchronize()
    assert y.dtype == torch.bfloat16 and tuple(y.shape) == (m, LAB2_N)
    assert torch.isfinite(y.float()).all()
    assert rel_err(y, want) < TOL[torch.bfloat16]


@pytest.mark.parametrize("name", ["pfdirect", "sep", "int4", "w3wide"])
@pytest.mark.parametrize("g", [2, 32, 512])
def test_lab2_other_group_sizes(dev, g, name):
    """Groups smaller than a pair row's word (g 2), within a chunk (32) and
    across chunks (512): the kernels' per-group scaling and int4's x sums."""
    inp = kernel_lab2.make_inputs(16, LAB2_N, LAB2_K, g=g, device=dev)
    fn, args = kernel_lab2.lab_call(name, inp, kernel_lab2.operands(name, inp), 16, LAB2_N,
                                    1024, g=g)
    y = ops2.FUNCTIONS[fn](*args)
    assert rel_err(y, ops2.plain(fn, *args)) < TOL[torch.bfloat16]


@pytest.mark.parametrize("name", kernel_lab2.LAB_GEMMS)
def test_lab2_identity_bit_exact(dev, name):
    """With x the identity every output is one product: the kernel gives the
    plain version bit for bit (the sign of a zero aside)."""
    inp = kernel_lab2.make_inputs(512, LAB2_N, 512, device=dev)
    inp.x = torch.eye(512, dtype=torch.bfloat16, device=dev)
    fn, args = kernel_lab2.lab_call(name, inp, kernel_lab2.operands(name, inp), 16, LAB2_N, 256)
    assert same_bits(ops2.FUNCTIONS[fn](*args), ops2.plain(fn, *args))


@pytest.mark.parametrize("nops", [0, 2, 8, 33])
def test_lab2_vmembw_bit_exact(dev, nops):
    w = kernel_lab2.vmembw_block(dev)
    for block in (w, w[:, 3:1000]):  # the lab's block, and a strided one
        before = dict(ops2.LAUNCHES)
        y = ops2.vmembw(block, nops)
        assert ops2.LAUNCHES == {**before, "vmembw": before["vmembw"] + 1}
        assert torch.equal(y, ops2.plain("vmembw", block, nops))


def test_lab2_launch_error_raises(dev):
    """A launch the kernel refuses (an odd group size) raises and is not
    counted."""
    inp = kernel_lab2.make_inputs(16, LAB2_N, LAB2_K, device=dev)
    out = torch.empty((16, LAB2_N), dtype=torch.bfloat16, device=dev)
    before = dict(ops2.LAUNCHES)
    with pytest.raises(RuntimeError, match="launch failed"):
        ops2._launch("pfdirect", out, [inp.x, inp.planes[0], inp.scales, inp.table],
                     [16, LAB2_N, LAB2_K, 3])
    assert ops2.LAUNCHES == before


def test_lab2_main_on_the_card(capsys):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the lab times its kernels on the card")
    before = dict(ops2.LAUNCHES)
    rows = kernel_lab2.main(["--n", "2048", "--k", "1024", "--bn", "256", "--bk", "512",
                             "--iters", "4", "--variants", ",".join(kernel_lab2.ORDER)])
    assert [r["name"] for r in rows] == list(kernel_lab2.ORDER)
    gemm = [r for r in rows if r["name"] != "vmembw"]
    assert all(r["us"] > 0 and r["rel"] < 1.1e-2 for r in gemm)
    assert rows[-1]["ns_per_op_per_1024"] is not None and "GB/s" in capsys.readouterr().out
    assert all(ops2.LAUNCHES[f] > before[f] for f in ops2.LAUNCHES)
