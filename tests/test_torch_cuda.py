"""Card-only checks of the port: each LUT-GEMM kernel (K1 w4sym, K2 plane at
2/3/4 bits, K3 w3wide, K4 joint pair lookup; K1-K3 on the tensor-core loop
and on their SIMT kernel), each paged-attention kernel
(K5 decode, K6 verify) and each kernel of the Hopper lab (L1-L12; L3-L6, L9,
L10 and L11 on the lab's tensor-core loop and on their SIMT kernel, L1 on the
loop at every g) against its plain version on the same CUDA tensors, what
the tensor core does with subnormal operands, and the models (Llama, Gemma-2),
Engine and PagedEngine through the kernels, with their decode step replayed
from a CUDA graph and held bit for bit against the eager step.

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
from flute_tpu_torch.models import gemma2, llama
from flute_tpu_torch.ops import lut_gemm
from flute_tpu_torch.ops import paged_attention as pa
from flute_tpu_torch.ops import kernel_config
from flute_tpu_torch.ops.kernel_config import KernelConfig
from flute_tpu_torch.quantize import higgs
from flute_tpu_torch.serving import (
    ContinuousBatchingEngine,
    Engine,
    PagedEngine,
    PagedSpeculativeEngine,
    SamplingParams,
    SpeculativeEngine,
)

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


def mma_pair_case(dev, bits, m, n, k, dtype, seed, chunk, g=G):
    """codes, x, planes, scales and a pair table for K4 at any N, K, g."""
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 2**bits, size=(k, n), dtype=np.int32)
    planes = packing.pack_np(codes, bits, chunk=chunk)
    scales = rng.uniform(0.5, 1.5, (k // g, n)).astype(np.float32)
    x = rng.standard_normal((m, k)).astype(np.float32)
    pv = rng.standard_normal((2**bits, 2**bits, 2)).astype(np.float32)
    return (torch.from_numpy(codes).to(dev), torch.from_numpy(x).to(dev, dtype),
            [torch.from_numpy(p).to(dev) for p in planes],
            torch.from_numpy(scales).to(dev, dtype), torch.from_numpy(pv).to(dev))


# N: whole 128-column blocks, a ragged block (N % 4 == 0: 16-byte loads) and
# N % 4 != 0 (the kernel's element loads)
@pytest.mark.parametrize("n", [384, 200, 198])
@pytest.mark.parametrize("chunk", [128, 256])
@pytest.mark.parametrize("bits", [2, 3, 4])
@pytest.mark.parametrize("m", [1, 5, 8, 16, 64, 512])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_pair_mma_kernel_vs_plain(dev, dtype, m, bits, chunk, n):
    """The tensor-core K4 at one, two and four m16 tiles per warp, split-K
    (K = 1024: up to 8 splits) and ragged N, against the plain version."""
    _, x, planes, s, pv = mma_pair_case(dev, bits, m, n, 1024, dtype, seed=m + bits + n,
                                        chunk=chunk)
    cfg = KernelConfig(chunk=chunk)
    zeros = torch.zeros(2**bits, device=dev)
    before = lut_gemm.LAUNCHES["pair"]
    y = lut_gemm.lut_qgemm(x, planes, s, zeros, num_bits=bits, config=cfg, pair_values=pv)
    assert lut_gemm.LAUNCHES["pair"] == before + 1
    y_plain = lut_gemm.lut_qgemm_plain(x, planes, s, zeros, num_bits=bits, chunk=chunk,
                                       layout="plane", pair_values=pv)
    torch.cuda.synchronize()
    assert y.dtype == dtype and tuple(y.shape) == (m, n)
    assert rel_err(y, y_plain) < TOL[dtype]


@pytest.mark.parametrize("n", [256, 198])
@pytest.mark.parametrize("chunk", [128, 256])
@pytest.mark.parametrize("bits", [2, 3, 4])
def test_pair_mma_identity_bit_exact(dev, bits, chunk, n):
    codes, _, planes, s, pv = mma_pair_case(dev, bits, 1, n, 512, torch.bfloat16, seed=41,
                                            chunk=chunk)
    eye = torch.eye(512, dtype=torch.bfloat16, device=dev)
    got = lut_gemm.qgemm(eye, planes, s, torch.zeros(2**bits, device=dev), bits, G,
                         config=KernelConfig(chunk=chunk), pair_values=pv)
    want = lut_gemm.dequantize_codes_pair(codes, s, pv, torch.bfloat16)
    assert torch.equal(got.float(), want.float())


@pytest.mark.parametrize("m", [1, 8, 512])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_pair_mma_repeat_calls_bit_identical(dev, dtype, m):
    """Split-K adds its partial sums in split order: a repeat call gives the
    same bits (K = 2048 at chunk 128: 16 chunks, several splits)."""
    _, x, planes, s, pv = mma_pair_case(dev, 4, m, 384, 2048, dtype, seed=42, chunk=128)
    kw = dict(num_bits=4, config=KernelConfig(chunk=128), pair_values=pv)
    assert lut_gemm.mma_plan(m, 384, 2048, 128).splits > 1 or m == 512
    first = lut_gemm.lut_qgemm(x, planes, s, None, **kw)
    for _ in range(3):
        again = lut_gemm.lut_qgemm(x, planes, s, None, **kw)
        assert torch.equal(again.view(torch.int16), first.view(torch.int16))


@pytest.mark.parametrize("g", [2, 32, 128, 512])
@pytest.mark.parametrize("bits", [3, 4])
def test_pair_mma_other_group_sizes(dev, bits, g):
    """Groups smaller than a field's rows (g 2), within a chunk (32), across
    fields (128) and across chunks (512)."""
    codes, x, planes, s, pv = mma_pair_case(dev, bits, 8, 256, 1024, torch.bfloat16, seed=43,
                                            chunk=256, g=g)
    zeros = torch.zeros(2**bits, device=dev)
    y = lut_gemm.lut_qgemm(x, planes, s, zeros, num_bits=bits, pair_values=pv)
    y_plain = lut_gemm.lut_qgemm_plain(x, planes, s, zeros, num_bits=bits, chunk=256,
                                       layout="plane", pair_values=pv)
    assert rel_err(y, y_plain) < TOL[torch.bfloat16]
    eye = torch.eye(1024, dtype=torch.bfloat16, device=dev)
    got = lut_gemm.lut_qgemm(eye, planes, s, zeros, num_bits=bits, pair_values=pv)
    assert torch.equal(got.float(), lut_gemm.dequantize_codes_pair(codes, s, pv,
                                                                   torch.bfloat16).float())


def test_pair_mma_unaligned_x_and_small_chunk(dev):
    """x at an odd offset is copied before the 16-byte loads; a chunk whose
    first plane has fewer than 4 word rows is refused."""
    _, x, planes, s, pv = mma_pair_case(dev, 4, 9, 256, 512, torch.bfloat16, seed=44, chunk=256)
    zeros = torch.zeros(16, device=dev)
    buf = torch.empty(9 * 512 + 1, dtype=torch.bfloat16, device=dev)
    xo = buf[1:].view(9, 512)
    xo.copy_(x)
    assert xo.data_ptr() % 16
    kw = dict(num_bits=4, pair_values=pv)
    assert torch.equal(lut_gemm.lut_qgemm(xo, planes, s, zeros, **kw),
                       lut_gemm.lut_qgemm(x, planes, s, zeros, **kw))
    _, x2, planes2, s2, pv2 = mma_pair_case(dev, 2, 2, 256, 512, torch.bfloat16, seed=45,
                                            chunk=32)
    with pytest.raises(ValueError, match="word rows"):
        lut_gemm.lut_qgemm_pair_cuda(x2, planes2, s2, pv2, num_bits=2, group_size=G, chunk=32)


def loop_case(dev, layout, bits, m, n, k, dtype, seed, chunk, g=G, mixed_signs=False):
    """codes, x, planes, scales and table for K1 (w4sym), K2 (plane) or K3
    (w3wide) at any N, K and g: a w4sym table of 8 magnitudes and their
    negations, or any 2^b values."""
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 2**bits, size=(k, n), dtype=np.int32)
    if layout == "w4sym":
        planes = packing.pack_w4_sym_np(codes, chunk=chunk)
        mags = rng.standard_normal(8).astype(np.float32)
        if not mixed_signs:
            mags = np.sort(np.abs(mags))
        table = np.concatenate([mags, -mags])
    elif layout == "w3wide":
        planes = packing.pack_w3_wide_np(codes, chunk=chunk)
        table = rng.standard_normal(8).astype(np.float32)
    else:
        planes = packing.pack_np(codes, bits, chunk=chunk)
        table = rng.standard_normal(2**bits).astype(np.float32)
    scales = rng.uniform(0.5, 1.5, (k // g, n)).astype(np.float32)
    x = rng.standard_normal((m, k)).astype(np.float32)
    return (torch.from_numpy(codes).to(dev), torch.from_numpy(x).to(dev, dtype),
            [torch.from_numpy(p).to(dev) for p in planes],
            torch.from_numpy(scales).to(dev, dtype), torch.from_numpy(table).to(dev))


LOOP_LAYOUTS = [("w4sym", 4), ("plane", 2), ("plane", 3), ("plane", 4)]
# a chunk each layout takes that the tensor-core loop does not: its SIMT kernel
SIMT_CHUNK = {("w4sym", 4): 16, ("plane", 2): 32, ("plane", 3): 32, ("plane", 4): 16}


@pytest.mark.parametrize("g", [32, 64, 128])
@pytest.mark.parametrize("chunk", [128, 256])
@pytest.mark.parametrize("layout,bits", LOOP_LAYOUTS)
@pytest.mark.parametrize("m", [1, 8, 17, 64, 512])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_k1_k2_loop_vs_plain(dev, dtype, m, layout, bits, chunk, g):
    """K1 and K2 on the tensor cores (the loop at one m16 tile per warp;
    M = 17 and 64 take the wide-M kernel's mid route, M = 512 the wide-M
    kernel), split-K (K = 1024) and groups within a chunk, across its
    fields and across chunks, against the plain version."""
    _, x, planes, s, t = loop_case(dev, layout, bits, m, 256, 1024, dtype, seed=m + bits + g,
                                   chunk=chunk, g=g)
    assert lut_gemm.lut_path(dtype, bits, chunk) == "mma"
    before = lut_gemm.LAUNCHES[layout]
    y = lut_gemm.lut_qgemm(x, planes, s, t, num_bits=bits, layout=layout,
                           config=KernelConfig(chunk=chunk))
    assert lut_gemm.LAUNCHES[layout] == before + 1
    y_plain = lut_gemm.lut_qgemm_plain(x, planes, s, t, num_bits=bits, chunk=chunk,
                                       layout=layout)
    torch.cuda.synchronize()
    assert y.dtype == dtype and tuple(y.shape) == (m, 256)
    assert rel_err(y, y_plain) < TOL[dtype]


@pytest.mark.parametrize("layout,bits", LOOP_LAYOUTS)
def test_k1_k2_loop_ragged_n_and_unaligned_x(dev, layout, bits):
    """N % 4 != 0 takes the loop's element loads; x at an odd offset is
    copied before its 16-byte loads and gives the aligned call's bits."""
    _, x, planes, s, t = loop_case(dev, layout, bits, 9, 198, 512, torch.bfloat16, seed=46,
                                   chunk=256)
    kw = dict(num_bits=bits, layout=layout)
    y = lut_gemm.lut_qgemm(x, planes, s, t, **kw)
    y_plain = lut_gemm.lut_qgemm_plain(x, planes, s, t, num_bits=bits, chunk=256, layout=layout)
    assert rel_err(y, y_plain) < TOL[torch.bfloat16]
    buf = torch.empty(9 * 512 + 1, dtype=torch.bfloat16, device=dev)
    xo = buf[1:].view(9, 512)
    xo.copy_(x)
    assert xo.data_ptr() % 16
    assert torch.equal(lut_gemm.lut_qgemm(xo, planes, s, t, **kw), y)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("layout,bits", LOOP_LAYOUTS)
def test_k1_k2_simt_chunk_vs_plain(dev, layout, bits, dtype):
    """A chunk whose first plane has no multiple of 4 word rows runs the
    SIMT kernel in every dtype."""
    chunk = SIMT_CHUNK[(layout, bits)]
    _, x, planes, s, t = loop_case(dev, layout, bits, 5, 256, 512, dtype, seed=47, chunk=chunk)
    assert lut_gemm.lut_path(dtype, bits, chunk) == "simt"
    cfg = KernelConfig(chunk=chunk)
    y = lut_gemm.lut_qgemm(x, planes, s, t, num_bits=bits, layout=layout, config=cfg)
    y_plain = lut_gemm.lut_qgemm_plain(x, planes, s, t, num_bits=bits, chunk=chunk,
                                       layout=layout)
    torch.cuda.synchronize()
    assert rel_err(y, y_plain) < TOL[dtype]


@pytest.mark.parametrize("chunk_kind", ["loop", "simt"])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("layout,bits", LOOP_LAYOUTS)
def test_k1_k2_identity_bit_exact_on_each_path(dev, layout, bits, dtype, chunk_kind):
    """Identity x gives the oracle's bits (K1 with a mixed-sign table): bf16
    and f16 at chunk 256 on the loop, at a small chunk on the SIMT kernel;
    f32 on the SIMT kernel at both (no TF32 loop)."""
    chunk = 256 if chunk_kind == "loop" else SIMT_CHUNK[(layout, bits)]
    on_loop = chunk_kind == "loop" and dtype != torch.float32
    assert lut_gemm.lut_path(dtype, bits, chunk) == ("mma" if on_loop else "simt")
    codes, _, planes, s, t = loop_case(dev, layout, bits, 1, 256, 512, dtype, seed=48,
                                       chunk=chunk, mixed_signs=True)
    eye = torch.eye(512, dtype=dtype, device=dev)
    got = lut_gemm.qgemm(eye, planes, s, t, bits, G, layout=layout,
                         config=KernelConfig(chunk=chunk))
    assert torch.equal(got.float(), lut_gemm.dequantize_codes(codes, s, t, dtype).float())


@pytest.mark.parametrize("m", [1, 8, 512])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("layout,bits", LOOP_LAYOUTS)
def test_k1_k2_repeat_calls_bit_identical(dev, layout, bits, dtype, m):
    """Split-K adds its partial sums in split order: a repeat call gives the
    same bits (K = 2048 at chunk 128: 16 chunks, several splits)."""
    _, x, planes, s, t = loop_case(dev, layout, bits, m, 384, 2048, dtype, seed=49, chunk=128)
    kw = dict(num_bits=bits, layout=layout, config=KernelConfig(chunk=128))
    assert lut_gemm.mma_plan(m, 384, 2048, 128).splits > 1
    first = lut_gemm.lut_qgemm(x, planes, s, t, **kw)
    for _ in range(3):
        again = lut_gemm.lut_qgemm(x, planes, s, t, **kw)
        assert torch.equal(again.view(torch.int16), first.view(torch.int16))


@pytest.mark.parametrize("m", [17, 64, 512])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("kernel", ["w4sym", "plane2", "plane3", "plane4", "pair", "w3wide"])
def test_row_result_does_not_depend_on_m(dev, kernel, dtype, m):
    """Row i of an M-row call has the bits of the one-row call on row i:
    the split is the same at every M (K1, K2, K3 and K4 on the loop)."""
    bits = {"w4sym": 4, "pair": 4, "w3wide": 3}.get(kernel) or int(kernel[-1])
    chunk = 256 if kernel == "w3wide" else 128
    if kernel == "pair":
        _, x, planes, s, pv = mma_pair_case(dev, bits, m, 384, 2048, dtype, seed=50, chunk=chunk)
        t, kw = None, dict(pair_values=pv)
    else:
        layout = kernel if kernel in ("w4sym", "w3wide") else "plane"
        _, x, planes, s, t = loop_case(dev, layout, bits, m, 384, 2048, dtype, seed=50,
                                       chunk=chunk)
        kw = dict(layout=layout)
    kw.update(num_bits=bits, config=KernelConfig(chunk=chunk))
    y = lut_gemm.lut_qgemm(x, planes, s, t, **kw)
    for i in sorted({0, 1, m // 2, m - 1}):
        row = lut_gemm.lut_qgemm(x[i:i + 1], planes, s, t, **kw)
        assert torch.equal(row.view(torch.int16), y[i:i + 1].view(torch.int16)), i


@pytest.mark.parametrize("g", [32, 64, 128])
@pytest.mark.parametrize("chunk", [256, 512])
@pytest.mark.parametrize("m", [1, 8, 17, 64, 512])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_k3_loop_vs_plain(dev, dtype, m, chunk, g):
    """K3 on the tensor-core loop at one, two and four m16 tiles per warp,
    split-K (K = 1024) and 2-8 groups per chunk (the chunk-scale path),
    against the plain version."""
    _, x, planes, s, t = loop_case(dev, "w3wide", 3, m, 256, 1024, dtype, seed=m + g + chunk,
                                   chunk=chunk, g=g)
    assert lut_gemm.lut_path(dtype, 3, chunk, "w3wide") == "mma"
    before = lut_gemm.LAUNCHES["w3wide"]
    y = lut_gemm.lut_qgemm(x, planes, s, t, num_bits=3, layout="w3wide",
                           config=KernelConfig(chunk=chunk))
    assert lut_gemm.LAUNCHES["w3wide"] == before + 1
    y_plain = lut_gemm.lut_qgemm_plain(x, planes, s, t, num_bits=3, chunk=chunk, layout="w3wide")
    torch.cuda.synchronize()
    assert y.dtype == dtype and tuple(y.shape) == (m, 256)
    assert rel_err(y, y_plain) < TOL[dtype]


@pytest.mark.parametrize("g", [2, 16, 48, 512])
@pytest.mark.parametrize("chunk", [256, 512])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_k3_loop_other_group_sizes(dev, dtype, chunk, g):
    """Group sizes that are not a multiple of a field's 2 kc rows (the
    per-field scale cache: g 2, and 16 and 48 at chunk 512), a non-power of
    two that is one (48 at chunk 256), and groups longer than a chunk."""
    _, x, planes, s, t = loop_case(dev, "w3wide", 3, 9, 256, 1536, dtype, seed=g + chunk,
                                   chunk=chunk, g=g)
    y = lut_gemm.lut_qgemm(x, planes, s, t, num_bits=3, layout="w3wide",
                           config=KernelConfig(chunk=chunk))
    y_plain = lut_gemm.lut_qgemm_plain(x, planes, s, t, num_bits=3, chunk=chunk, layout="w3wide")
    torch.cuda.synchronize()
    assert rel_err(y, y_plain) < TOL[dtype]


def test_k3_loop_ragged_n_and_unaligned_x(dev):
    """N % 4 != 0 takes the loop's element loads; x at an odd offset is
    copied before its 16-byte loads and gives the aligned call's bits."""
    _, x, planes, s, t = loop_case(dev, "w3wide", 3, 9, 198, 512, torch.bfloat16, seed=51,
                                   chunk=256)
    kw = dict(num_bits=3, layout="w3wide")
    y = lut_gemm.lut_qgemm(x, planes, s, t, **kw)
    y_plain = lut_gemm.lut_qgemm_plain(x, planes, s, t, num_bits=3, chunk=256, layout="w3wide")
    assert rel_err(y, y_plain) < TOL[torch.bfloat16]
    buf = torch.empty(9 * 512 + 1, dtype=torch.bfloat16, device=dev)
    xo = buf[1:].view(9, 512)
    xo.copy_(x)
    assert xo.data_ptr() % 16
    assert torch.equal(lut_gemm.lut_qgemm(xo, planes, s, t, **kw), y)


@pytest.mark.parametrize("chunk", [256, 1024])
@pytest.mark.parametrize("dtype", DTYPES)
def test_k3_paths_vs_plain_and_identity(dev, dtype, chunk):
    """The SIMT kernel in f32 and at chunk 1024 (its x ring would not fit
    the loop's shared memory), the loop in bf16 and f16 at chunk 256: each
    against the plain version, and an identity x bit-exact on each path."""
    on_loop = dtype != torch.float32 and chunk == 256
    assert lut_gemm.lut_path(dtype, 3, chunk, "w3wide") == ("mma" if on_loop else "simt")
    cfg = KernelConfig(chunk=chunk)
    codes, x, planes, s, t = loop_case(dev, "w3wide", 3, 5, 256, 2048, dtype, seed=52,
                                       chunk=chunk)
    y = lut_gemm.lut_qgemm(x, planes, s, t, num_bits=3, layout="w3wide", config=cfg)
    y_plain = lut_gemm.lut_qgemm_plain(x, planes, s, t, num_bits=3, chunk=chunk, layout="w3wide")
    torch.cuda.synchronize()
    assert rel_err(y, y_plain) < TOL[dtype]
    eye = torch.eye(2048, dtype=dtype, device=dev)
    got = lut_gemm.qgemm(eye, planes, s, t, 3, G, layout="w3wide", config=cfg)
    assert torch.equal(got.float(), lut_gemm.dequantize_codes(codes, s, t, dtype).float())


@pytest.mark.parametrize("m", [1, 8, 512])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_k3_repeat_calls_bit_identical(dev, dtype, m):
    """Split-K adds its partial sums in split order: a repeat call gives the
    same bits (K = 2048 at chunk 256: 8 chunks, several splits)."""
    _, x, planes, s, t = loop_case(dev, "w3wide", 3, m, 384, 2048, dtype, seed=53, chunk=256)
    kw = dict(num_bits=3, layout="w3wide", config=KernelConfig(chunk=256))
    assert lut_gemm.mma_plan(m, 384, 2048, 256).splits > 1
    first = lut_gemm.lut_qgemm(x, planes, s, t, **kw)
    for _ in range(3):
        again = lut_gemm.lut_qgemm(x, planes, s, t, **kw)
        assert torch.equal(again.view(torch.int16), first.view(torch.int16))


@pytest.mark.parametrize("case", ["head", "head_tied", "attention"])
def test_matmul_f32_on_the_card(dev, case):
    """llama.matmul_f32: 16-bit operands, f32 result, within 1e-5 of the
    upcast product, and no f32 copy of the large operand (the peak rises by
    less than an f32 head would take)."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(46)
    if case == "attention":  # [B * Hkv, rep * T, D] @ [B * Hkv, D, S], K as a transposed view
        a = torch.randn((8, 2, 4, 128), generator=gen, device=dev).bfloat16()
        big = torch.randn((8, 2, 4096, 128), generator=gen, device=dev).bfloat16()
        b = big.transpose(-1, -2)
    else:  # [8, 1, 4096] @ a 4096 x 128256 head, stored [in, out] or tied [out, in]
        a = torch.randn((8, 1, 4096), generator=gen, device=dev).bfloat16()
        big = torch.randn((128256, 4096) if case == "head_tied" else (4096, 128256),
                          generator=gen, device=dev).bfloat16()
        b = big.T if case == "head_tied" else big
    want = torch.matmul(a.float(), b.float())
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    got = llama.matmul_f32(a, b)
    torch.cuda.synchronize()
    rise = torch.cuda.max_memory_allocated(dev) - base
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert rel_err(got, want) < 1e-5
    assert rise < big.numel() * 4


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


SPAN = pa.DECODE_SPAN
K5_LENGTHS = [0, 1, SPAN - 1, SPAN, SPAN + 1, 4096]


def k5_case(dev, dtype, lengths, hkv, h, d, bs, extra_blocks, seed):
    """q, pools and a table ``extra_blocks`` wider than the longest sequence
    needs, every block its own pool row."""
    mb = -(-max(lengths) // bs) + extra_blocks
    q, kp, vp, tables = paged_case(dev, dtype, len(lengths), h, hkv, d, bs, mb,
                                   len(lengths) * mb + 1, seed=seed)
    return q, kp, vp, tables, torch.tensor(lengths, dtype=torch.int32, device=dev)


@pytest.mark.parametrize("softcap,window", PAGED_OPTIONS + [(None, 300)])
@pytest.mark.parametrize("hkv,h,d,bs", [(8, 32, 128, 16), (2, 8, 64, 32), (2, 4, 256, 8),
                                         (1, 32, 128, 16)])
@pytest.mark.parametrize("dtype", DTYPES)
def test_k5_spans_vs_plain(dev, dtype, hkv, h, d, bs, softcap, window):
    """K5 at lengths 0, 1, P - 1, P, P + 1 and 4096 (spans of P positions,
    merged in order; f32 on the unsplit kernel), rep 4, 4 and 2 and 32 (two
    tiles of 16 heads), against the plain version; length 0 gives zeros."""
    q, kp, vp, tables, lengths = k5_case(dev, dtype, K5_LENGTHS, hkv, h, d, bs, 3, seed=h + d)
    kw = dict(softcap=softcap, window=window)
    before = pa.LAUNCHES["paged_decode"]
    got = pa.paged_decode_attention(q, kp, vp, tables, lengths, **kw)
    assert pa.LAUNCHES["paged_decode"] == before + 1
    want = pa.paged_gqa_reference(q, kp, vp, tables, lengths, **kw)
    torch.cuda.synchronize()
    assert got.dtype == dtype and torch.isfinite(got.float()).all()
    assert not got[0].float().any()
    assert max_rel(got[1:], want[1:]) < TOL[torch.bfloat16]


@pytest.mark.parametrize("softcap,window", [(None, None), (30.0, 300)])
@pytest.mark.parametrize("dtype", DTYPES)
def test_k5_repeat_calls_and_batch_independence(dev, dtype, softcap, window):
    """A repeat call gives the same bits, and each sequence of a batch of 8
    (table wider than its longest) has the bits it has alone with a table
    just wide enough for it (one span, written directly, where it fits)."""
    lengths = [1, SPAN - 1, SPAN + 1, 4096, 0, 37, 1000, SPAN]
    q, kp, vp, tables, lens = k5_case(dev, dtype, lengths, 8, 32, 128, 16, 3, seed=61)
    kw = dict(softcap=softcap, window=window)
    got = pa.paged_decode_attention(q, kp, vp, tables, lens, **kw)
    again = pa.paged_decode_attention(q, kp, vp, tables, lens, **kw)
    bits = (lambda y: y.view(torch.int32)) if dtype == torch.float32 else (
        lambda y: y.view(torch.int16))
    assert torch.equal(bits(again), bits(got))
    for i, n in enumerate(lengths):
        mb = max(1, -(-n // 16))
        alone = pa.paged_decode_attention(q[i:i + 1], kp, vp, tables[i:i + 1, :mb],
                                          lens[i:i + 1], **kw)
        assert torch.equal(bits(alone), bits(got[i:i + 1])), n


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


def verify_case(dev, dtype, lengths, t, d, bs, seed):
    """q [B, T, 32, d], pools of blocks of ``bs`` holding every live block of
    the sequences (a random permutation of pool rows) and their tables."""
    rng = np.random.default_rng(seed)
    need = [-(-(n + t) // bs) for n in lengths]
    mb, nb = max(need), sum(need) + 1
    rows = rng.permutation(np.arange(1, nb))
    tables = np.zeros((len(lengths), mb), np.int32)
    start = 0
    for i, k in enumerate(need):
        tables[i, :k] = rows[start:start + k]
        start += k
    q = torch.from_numpy(rng.standard_normal((len(lengths), t, 32, d)).astype(np.float32))
    kp, vp = (torch.from_numpy(rng.standard_normal((nb, 8, bs, d)).astype(np.float32))
              for _ in range(2))
    return (q.to(dev, dtype), kp.to(dev, dtype), vp.to(dev, dtype),
            torch.from_numpy(tables).to(dev),
            torch.tensor(lengths, dtype=torch.int32, device=dev))


def check_verify(q, kp, vp, tables, lengths, softcap, window):
    kw = dict(softcap=softcap, window=window)
    before = pa.LAUNCHES["paged_verify"]
    got = pa.paged_verify_attention(q, kp, vp, tables, lengths, **kw)
    again = pa.paged_verify_attention(q, kp, vp, tables, lengths, **kw)
    assert pa.LAUNCHES["paged_verify"] == before + 2
    want = pa.paged_verify_reference(q, kp, vp, tables, lengths, **kw)
    torch.cuda.synchronize()
    assert got.dtype == q.dtype and torch.isfinite(got.float()).all()
    assert torch.equal(got.view(torch.uint8), again.view(torch.uint8))
    # f32: the kernel and the plain version differ in the order of f32 sums
    limit = TOL[torch.bfloat16] if q.dtype != torch.float32 else 1e-4
    assert max_rel(got, want) < limit


@pytest.mark.parametrize("softcap,window", PAGED_OPTIONS)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("lengths", [[1024], [0, 37, 1024]])
@pytest.mark.parametrize("t", [1, 5, 16, 64, 256])
def test_paged_verify_tensor_cores_vs_plain(dev, t, lengths, dtype, softcap, window):
    """K6 at Llama's 32/8 heads, D 128, blocks of 16: bf16/f16 on the
    tensor-core kernel (64-row tiles, several per (sequence, KV head) from T
    = 17 on), f32 on the f32 kernel; a repeat call gives the same bits."""
    case = verify_case(dev, dtype, lengths, t, 128, 16, seed=t + len(lengths))
    check_verify(*case, softcap, window)


@pytest.mark.parametrize("softcap,window", PAGED_OPTIONS)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("d,bs", [(64, 16), (64, 32), (128, 8), (128, 32), (256, 8), (256, 16)])
def test_paged_verify_head_dims_and_blocks(dev, d, bs, dtype, softcap, window):
    case = verify_case(dev, dtype, [0, 37, 300], 70, d, bs, seed=d + bs)
    check_verify(*case, softcap, window)


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
                     [16, LAB2_N, LAB2_K, 3, 1], work=[None])
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


# ---------------------------------------------------------------------------
# L1, L3, L4, L5, L6, L9, L10 and L11 on the lab's tensor-core loop
# (csrc/lab_mma.cuh)
# ---------------------------------------------------------------------------


def test_lab_mma_keeps_subnormals(dev):
    """One mma.sync.m16n8k16 (bf16 in, f32 sums) of the identity and a B
    holding bf16 subnormals (0x0001, 0x007F, 0x8001, 0x0040) beside normal
    values gives B's values exactly, and their bf16 rounding B's bits;
    2^-100 times the identity against normal values near 2^-40 gives the
    exact f32 subnormal products; and rows of powers of two against columns
    of bf16 subnormals give each output's sum of 16 subnormal products
    exactly. So the tensor core neither flushes a subnormal operand nor a
    subnormal product, nor truncates a step's sum of them: floor, whose
    finite halves are subnormal one time in 128, and unpack_only, whose
    operand is all subnormal, are bit-exact on the loop with x the
    identity."""
    (_, b), (tiny, small), (rows, sub) = lab.probe_operands(dev)
    assert int((b.cpu().float().abs() < 2.0**-126).sum()) == 3 * len(lab.PROBE_SUBNORMALS)
    want = lab.mma_probe(tiny.cpu(), small.cpu())
    assert bool(((want != 0) & (want.abs() < 2.0**-126)).all())
    assert bool((sub.cpu().float().abs() < 2.0**-126).all())
    out = lab.probe_subnormals(dev)
    assert out["operands_kept"] and out["subnormal_products_kept"]
    assert out["subnormal_sums_kept"]
    assert out["operand_bits"] == [f"0x{v:04X}" for v in lab.PROBE_SUBNORMALS]


# floor and unpack_only on the loop (they read no scales): their K blocks
# (3584 is MAX_BLOCK_K, where bk/4 = 896 is not a power of two), each at a K
# that holds it
FLOOR_BKS = (256, 512, 1024, 3584)
UNSCALED = ("floor", "unpack_only")


def floor_call(dev, fn, m, bk, k=None, n=LAB_N, g=G, eye=False):
    """(a call of ``fn``, floor or unpack_only, its plain version) on the
    lab's inputs (floor's planes masked to finite halves), at K block
    ``bk`` (x the identity with ``eye``: M = K)."""
    k = k or max(LAB_K, bk)
    _, planes, scales, _, x = kernel_lab.make_inputs(m, n, k, 4, g, device=dev)
    if fn == "floor":
        planes = [lab.finite_halves(planes[0])]
    if eye:
        x = torch.eye(k, dtype=torch.bfloat16, device=dev)
    bm = 16 if eye else m
    return (lambda: lab.FUNCTIONS[fn](x, planes, scales, bm, n, bk, g),
            lambda: lab.plain(fn, x, planes, scales, None, bm, n, bk, g))


def unscaled_err(fn, y, want) -> float:
    """Relative Frobenius error, or for unpack_only, whose operand is
    subnormal, the largest error over the largest output (the threshold is
    the same)."""
    if fn == "unpack_only":
        assert float(want.float().abs().max()) > 0
        return float((y.float() - want.float()).abs().max() / want.float().abs().max())
    return rel_err(y, want)


@pytest.mark.parametrize("bk", FLOOR_BKS)
@pytest.mark.parametrize("m", [1, 16, 40])
@pytest.mark.parametrize("fn", UNSCALED)
def test_lab_floor_loop_vs_plain(dev, fn, m, bk):
    """floor and unpack_only on the loop at every K block: one launch
    counted, path "mma", the plain version within the bf16 threshold (floor:
    the x map picks the block's four stretches right), a repeated call bit
    for bit."""
    call, plain = floor_call(dev, fn, m, bk)
    before = dict(lab.LAUNCHES)
    y = call()
    assert lab.LAUNCHES == {**before, fn: before[fn] + 1}
    assert lab.LAST_PATH[fn] == "mma" == lab.path_of(fn, G)
    again = call()
    torch.cuda.synchronize()
    assert y.dtype == torch.bfloat16 and tuple(y.shape) == (m, LAB_N)
    assert torch.isfinite(y.float()).all()
    assert unscaled_err(fn, y, plain()) < TOL[torch.bfloat16]
    assert torch.equal(y.view(torch.int16), again.view(torch.int16))


@pytest.mark.parametrize("bk", [256, 1024])
@pytest.mark.parametrize("fn", UNSCALED)
def test_lab_floor_identity_bit_exact(dev, fn, bk):
    """x the identity (K 1024): every output one word half (unpack_only:
    one code as a bf16 subnormal), bit for bit; at bk 1024 floor's four
    stretches of a block are 256 rows apart, so a wrong x map moves
    outputs."""
    call, plain = floor_call(dev, fn, 1024, bk, k=1024, eye=True)
    y, want = call(), plain()
    assert lab.LAST_PATH[fn] == "mma"
    assert torch.equal(y.view(torch.int16), want.view(torch.int16))


@pytest.mark.parametrize("bk", [512, 3584])
@pytest.mark.parametrize("fn", UNSCALED)
def test_lab_floor_one_split_and_the_planned_split(dev, monkeypatch, fn, bk):
    """One split and the split lab_splits plans from the chunk (N 2048:
    more than one) each agree with the plain version and repeat their
    bits."""
    k = 8 * bk if bk == 512 else 2 * bk
    call, plain = floor_call(dev, fn, 16, bk, k=k, n=2048)
    planned = lab.launch_splits(fn, 2048, k, G)
    assert planned > 1
    want = plain()
    for splits in (1, planned):
        monkeypatch.setattr(lab, "lab_splits", lambda n, k, g, s=splits: s)
        y, again = call(), call()
        torch.cuda.synchronize()
        assert lab.LAST_PATH[fn] == "mma"
        assert unscaled_err(fn, y, want) < TOL[torch.bfloat16]
        assert torch.equal(y.view(torch.int16), again.view(torch.int16))


@pytest.mark.parametrize("g,bk", [(2, 256), (6, 768), (512, 512)])
@pytest.mark.parametrize("fn", UNSCALED)
def test_lab_floor_loop_at_every_g(dev, fn, g, bk):
    """floor and unpack_only read no scales: the loop runs them at a g that
    16 does not divide too, with the same result as their plain
    versions."""
    call, plain = floor_call(dev, fn, 16, bk, k=2 * bk, g=g)
    y = call()
    assert lab.LAST_PATH[fn] == "mma" == lab.path_of(fn, g)
    assert unscaled_err(fn, y, plain()) < TOL[torch.bfloat16]


@pytest.mark.parametrize("n", [50, 130])
@pytest.mark.parametrize("fn", UNSCALED)
def test_lab_floor_narrow_copies(dev, fn, n):
    """A ragged N: 50 (not a multiple of 4: the plane in 4-byte copies) and
    130 (a second block of two columns)."""
    call, plain = floor_call(dev, fn, 16, 1024, n=n)
    y = call()
    assert tuple(y.shape) == (16, n) and unscaled_err(fn, y, plain()) < TOL[torch.bfloat16]


# (bk, K, splits, workspace) of floor and unpack_only launches the C entries
# refuse: a split not dividing K's chunks, none, more than one with no
# workspace, a bk that is not a multiple of the chunk
FLOOR_BAD_LAUNCHES = {"split": (1024, 1024, 3, True), "zero_splits": (1024, 1024, 0, False),
                      "no_workspace": (1024, 1024, 2, False), "bk": (384, 768, 1, False)}


@pytest.mark.parametrize("case", list(FLOOR_BAD_LAUNCHES))
@pytest.mark.parametrize("fn", UNSCALED)
def test_lab_floor_refuses_bad_launches(dev, fn, case):
    bk, k, splits, with_work = FLOOR_BAD_LAUNCHES[case]
    _, planes, _, _, x = kernel_lab.make_inputs(16, LAB_N, k, 4, G, device=dev)
    y = torch.full((16, LAB_N), 7.0, dtype=torch.bfloat16, device=dev)
    work = torch.empty((max(splits, 1), 16, LAB_N), dtype=torch.float32, device=dev)
    entry, _ = lab._kernel_fn(fn)
    err = entry(x.data_ptr(), planes[0].data_ptr(), y.data_ptr(),
                work.data_ptr() if with_work else None, 16, LAB_N, k, bk, splits,
                torch.cuda.current_stream(dev).cuda_stream)
    torch.cuda.synchronize()
    assert err == 1  # cudaErrorInvalidValue
    assert bool((y == 7.0).all())


# L6 in its two scale modes, L10, L4's four distinct flag sets (g8_wrap's
# are g8_nochain's entries), L9's two modes, L5's two (the pair table in
# shared memory), L3 (the 16 entries in shared memory), L11 (L5
# group_acc's pair table), L8 (L11's decoder, the operand through a tile in
# shared memory) and L12 (the wide 3-bit layout's 24 word rows a chunk)
LOOP_VARIANTS = ("g8_hoist group_acc", "g8_hoist repeat", "int4", "g8_ablate full",
                 "g8_ablate nochain", "g8_ablate noscale", "g8_ablate bare", "sep", "sep1",
                 "g8_rs group_acc", "g8_rs repeat", "gather16 expand", "slabstream", "pfdirect",
                 "w3wide")
LAB2_LOOP_VARIANTS = ("int4", "sep", "sep1", "slabstream", "pfdirect", "w3wide")
# the loop variants of lab/ops.py
LAB1_LOOP_VARIANTS = tuple(v for v in LOOP_VARIANTS if v not in LAB2_LOOP_VARIANTS)


def loop_call(dev, variant, m, g, k=LAB_K, eye=False, n=LAB_N):
    """(function name, its module, a call, its plain version) of a loop
    variant at group size ``g`` (x the identity with ``eye``: M = K)."""
    bk = max(512, g)
    bm = 16 if eye else m
    if variant in LAB2_LOOP_VARIANTS:
        inp = kernel_lab2.make_inputs(m, n, k, g=g, device=dev, w3=variant == "w3wide")
        if eye:
            inp.x = torch.eye(k, dtype=torch.bfloat16, device=dev)
        fn, args = kernel_lab2.lab_call(variant, inp, kernel_lab2.operands(variant, inp), bm, n,
                                        bk, g=g)
        return fn, ops2, (lambda: ops2.FUNCTIONS[fn](*args)), (lambda: ops2.plain(fn, *args))
    fn, mode = variant.split()
    if fn in ("g8_hoist", "g8_rs"):
        flags = dict(scale_mode=mode)
    elif fn == "gather16":
        flags = {}
    else:
        flags = kernel_lab.VARIANTS["g8_" + mode][1]
    _, planes, scales, table, x = kernel_lab.make_inputs(m, n, k, 4, g, device=dev)
    if eye:
        x = torch.eye(k, dtype=torch.bfloat16, device=dev)
    return (fn, lab,
            lambda: lab.run(fn, x, planes, scales, table, bm, n, bk, g, **flags),
            lambda: lab.plain(fn, x, planes, scales, table, bm, n, bk, g, **flags))


@pytest.mark.parametrize("variant", LOOP_VARIANTS)
@pytest.mark.parametrize("g", [32, 64, 512])
@pytest.mark.parametrize("m", [1, 16, 40])
def test_lab_loop_vs_plain(dev, m, g, variant):
    """The tensor-core path at every g the lab's tests use that 16 divides:
    one launch counted per call whatever the split, the path recorded, the
    plain version within the bf16 threshold, a repeated call bit for bit."""
    fn, mod, call, plain = loop_call(dev, variant, m, g)
    before = dict(mod.LAUNCHES)
    y = call()
    assert mod.LAUNCHES == {**before, fn: before[fn] + 1}
    assert mod.LAST_PATH[fn] == "mma" == lab.lab_path(g)
    again = call()
    torch.cuda.synchronize()
    assert y.dtype == torch.bfloat16 and tuple(y.shape) == (m, LAB_N)
    assert torch.isfinite(y.float()).all()
    assert rel_err(y, plain()) < TOL[torch.bfloat16]
    assert torch.equal(y.view(torch.int16), again.view(torch.int16))


@pytest.mark.parametrize("variant", (*LAB1_LOOP_VARIANTS, "slabstream", "pfdirect", "w3wide"))
@pytest.mark.parametrize("g", [64, 512])
def test_lab_loop_one_split_and_the_planned_split(dev, monkeypatch, g, variant):
    """One split and the split lab_splits plans (N 2048, K 4096: more than
    one) each agree with the plain version and repeat their bits; the
    planned split launches the loop and its reduction as one call."""
    fn, mod, call, plain = loop_call(dev, variant, 16, g, k=4096, n=2048)
    planned = lab.lab_splits(2048, 4096, g)
    assert planned > 1
    want = plain()
    for splits in (1, planned):
        monkeypatch.setattr(mod, "lab_splits", lambda n, k, g, s=splits: s)
        before = dict(mod.LAUNCHES)
        y = call()
        assert mod.LAUNCHES == {**before, fn: before[fn] + 1}
        assert mod.LAST_PATH[fn] == "mma"
        again = call()
        torch.cuda.synchronize()
        assert rel_err(y, want) < TOL[torch.bfloat16]
        assert torch.equal(y.view(torch.int16), again.view(torch.int16))


def allocator_block(ptr: int) -> tuple[str | None, int]:
    """(state, bytes from ``ptr`` to its end) of the caching allocator's
    block that holds device address ``ptr``, or (None, 0)."""
    for seg in torch.cuda.memory_snapshot():
        addr = seg["address"]
        for block in seg["blocks"]:
            start = block.get("address", addr)
            if start <= ptr < start + block["size"]:
                return block["state"], start + block["size"] - ptr
            addr = start + block["size"]
    return None, 0


@pytest.mark.parametrize("variant", LAB2_LOOP_VARIANTS)
def test_lab2_loop_keeps_its_workspace_through_the_launch(dev, monkeypatch, variant):
    """sep, sep1, int4, slabstream, pfdirect and w3wide with four splits at N 2048, K 1024 (a
    512 KiB workspace, from the allocator's pool of small blocks, as the
    output is), right after a free block of the workspace's size: when the
    C entry is called, the workspace it gets is an allocated block that
    holds all of it, apart from the output (else the allocator could hand
    its memory to the output, and the split reduction would read partials
    that it overwrites), and the result agrees with the plain version."""
    m, n, k, g = 16, 2048, 1024, 64
    fn, mod, call, plain = loop_call(dev, variant, m, g, k=k, n=n)
    splits = lab.lab_splits(n, k, g)
    ws_bytes = splits * m * n * 4
    assert mod is ops2 and splits > 1
    seen = []
    entry, error_string = ops2._kernel_fn(fn)
    n_ptr = ops2._ENTRIES[fn][1].count(ops2._P)

    def spy(*args):
        y_ptr, ws_ptr = args[n_ptr - 2:n_ptr]
        seen.append((y_ptr, ws_ptr, allocator_block(ws_ptr) if ws_ptr else (None, 0)))
        return entry(*args)

    monkeypatch.setattr(ops2, "_kernel_fn", lambda name: (spy, error_string))
    want = plain()
    torch.cuda.synchronize()
    block = torch.empty(ws_bytes, dtype=torch.uint8, device=dev)
    del block
    y = call()
    torch.cuda.synchronize()
    ((y_ptr, ws_ptr, (state, room)),) = seen
    assert y_ptr == y.data_ptr() and ws_ptr is not None
    assert state == "active_allocated" and room >= ws_bytes
    assert ws_ptr + ws_bytes <= y_ptr or y_ptr + m * n * 2 <= ws_ptr
    assert rel_err(y, want) < TOL[torch.bfloat16]


# L5's and L3's loop variants (tables in shared memory) and their register
# twins (the same functions with the table in registers)
LOOP_TWINS = {"g8_rs group_acc": "g8_hoist group_acc", "g8_rs repeat": "g8_hoist repeat",
              "gather16 expand": "g8_ablate full"}


@pytest.mark.parametrize("variant", list(LOOP_TWINS))
@pytest.mark.parametrize("g", [32, 64, 512])
def test_lab_loop_shared_table_gives_its_twins_bits(dev, g, variant):
    """L5 and L3 compute L6's and L4 full's functions from the same bf16
    entries in the same sum order on the loop: where the table lives
    changes no bit."""
    y = loop_call(dev, variant, 40, g)[2]()
    twin = loop_call(dev, LOOP_TWINS[variant], 40, g)[2]()
    assert torch.equal(y.view(torch.int16), twin.view(torch.int16))


@pytest.mark.parametrize("g", [16, 32, 64, 512])
def test_lab_loop_pfdirect_gives_l11s_bits(dev, g):
    """L8 runs L11's pair table (in 2 copies), scaling, split and step
    order; only its B registers go through shared memory first: the same
    bits on the same inputs."""
    inp = kernel_lab2.make_inputs(40, LAB_N, LAB_K, g=g, device=dev, w3=False)
    bk = max(512, g)
    y = ops2.pfdirect(inp.x, inp.planes, inp.scales, inp.table, 40, LAB_N, bk, g)
    l11 = ops2.slabstream(inp.x, inp.planes, inp.scales, inp.table, 40, LAB_N, bk, g)
    assert ops2.LAST_PATH["pfdirect"] == ops2.LAST_PATH["slabstream"] == "mma"
    assert torch.equal(y.view(torch.int16), l11.view(torch.int16))


@pytest.mark.parametrize("g", [2, 16, 32, 64, 128])
@pytest.mark.parametrize("m", [1, 5, 16, 17, 33])
@pytest.mark.parametrize("variant", ["pfdirect", "w3wide"])
def test_lab_loop_l8_l12_rows_and_groups(dev, variant, m, g):
    """L8 and L12 at row counts around the loop's m16 tiles and at every
    group size the lab's shapes take: the loop where 16 divides g, the SIMT
    kernel at g = 2; one launch counted; the plain version within the bf16
    threshold; a repeated call bit for bit."""
    fn, mod, call, plain = loop_call(dev, variant, m, g)
    before = dict(mod.LAUNCHES)
    y = call()
    assert mod.LAUNCHES == {**before, fn: before[fn] + 1}
    assert mod.LAST_PATH[fn] == lab.lab_path(g) == ("simt" if g == 2 else "mma")
    again = call()
    torch.cuda.synchronize()
    assert y.dtype == torch.bfloat16 and tuple(y.shape) == (m, LAB_N)
    assert torch.isfinite(y.float()).all()
    assert rel_err(y, plain()) < TOL[torch.bfloat16]
    assert torch.equal(y.view(torch.int16), again.view(torch.int16))


@pytest.mark.parametrize("g", [32, 64, 512])
def test_lab_loop_slabstream_gives_l5s_bits(dev, g):
    """L11 (kernel_lab2.cu) and L5 group_acc (kernel_lab.cu) run one decoder,
    one scaling and one split on the same inputs: the two libraries give the
    same bits."""
    inp = kernel_lab2.make_inputs(40, LAB_N, LAB_K, g=g, device=dev, w3=False)
    bk = max(512, g)
    y = ops2.slabstream(inp.x, inp.planes, inp.scales, inp.table, 40, LAB_N, bk, g)
    l5 = lab.g8_rs(inp.x, inp.planes, inp.scales, inp.table, 40, LAB_N, bk, g, "group_acc")
    assert ops2.LAST_PATH["slabstream"] == lab.LAST_PATH["g8_rs"] == "mma"
    assert torch.equal(y.view(torch.int16), l5.view(torch.int16))


def test_lab_loop_occupancy(dev):
    """Every instantiation of the loop in both lab libraries keeps four
    blocks an SM at its lab's shape; its dynamic shared memory is the ring
    (L12: 24 word rows a chunk, the others 32), its decoder's table (L5 and
    L11: 4 copies of 256 words with group_acc, L5 and L8: 2 beside
    "repeat"'s scale rows or L8's tiles; L3: 16 words; L12: 8 copies of 64;
    L1's WordDecoder and L2's UnpackDecoder none), L8's warp tiles (4 x 1
    KB) and "repeat"'s scale rows."""
    def ring(word_rows):
        return 2 * (16 * (256 + 8) * 2 + word_rows * 128 * 4)

    table = {"PairTableDecoder<4>": 4 * 256 * 4, "PairTableDecoder<2>": 2 * 256 * 4,
             "Gather16Decoder": 16 * 4, "PairTileDecoder": 2 * 256 * 4 + 4 * 1024,
             "W3PairDecoder": 8 * 64 * 4}
    seen = {}
    for source, bk in (("kernel_lab.cu", 1024), ("kernel_lab2.cu", 2048)):
        seen[source] = []
        for inst in lab.loop_instances(source, bk, G):
            rows = bk // G * 128 * 2 if inst["scaling"] == "repeat" else 0
            words = 24 if inst["decoder"] == "W3PairDecoder" else 32
            assert inst["smem_bytes"] == ring(words) + table.get(inst["decoder"], 0) + rows, inst
            assert inst["blocks_per_sm"] == 4, inst
            seen[source].append((inst["decoder"], inst["scaling"]))
    lab1, lab2 = seen["kernel_lab.cu"], seen["kernel_lab2.cu"]
    assert len(set(lab1)) == len(lab1) == 11 and len(set(lab2)) == len(lab2) == 6
    assert {("PairTableDecoder<4>", "group_acc"), ("PairTableDecoder<2>", "repeat"),
            ("Gather16Decoder", "expand"), ("WordDecoder", "none"),
            ("UnpackDecoder", "none")} <= set(lab1)
    assert {("PairTableDecoder<4>", "group_acc"), ("PairTileDecoder", "group_acc"),
            ("W3PairDecoder", "group_acc")} <= set(lab2)


@pytest.mark.parametrize("variant", LOOP_VARIANTS)
def test_lab_loop_narrow_copies(dev, variant):
    """N = 50, not a multiple of 4: the loop stages the plane (sep: both
    planes) in 4-byte copies and loads and stages the scales 2 bytes at a
    time."""
    fn, mod, call, plain = loop_call(dev, variant, 16, 64, n=50)
    y = call()
    assert mod.LAST_PATH[fn] == "mma"
    assert tuple(y.shape) == (16, 50) and rel_err(y, plain()) < TOL[torch.bfloat16]


@pytest.mark.parametrize("variant", LOOP_VARIANTS)
def test_lab_loop_simt_path_at_g2(dev, variant):
    """g = 2 cannot put a k16 step inside one group: the SIMT kernel runs it,
    chosen before the launch, with the same checks."""
    fn, mod, call, plain = loop_call(dev, variant, 16, 2)
    y = call()
    assert mod.LAST_PATH[fn] == "simt" == lab.lab_path(2)
    again = call()
    assert rel_err(y, plain()) < TOL[torch.bfloat16]
    assert torch.equal(y.view(torch.int16), again.view(torch.int16))


@pytest.mark.parametrize("variant", LOOP_VARIANTS)
@pytest.mark.parametrize("g", [2, 64, 512])
def test_lab_loop_identity_bit_exact(dev, g, variant):
    """x the identity on both paths: every output one product, the plain
    version bit for bit (int4: the sign of a zero aside)."""
    fn, mod, call, plain = loop_call(dev, variant, 512, g, k=512, eye=True)
    y, want = call(), plain()
    assert mod.LAST_PATH[fn] == lab.lab_path(g)
    if fn in ("int4", "w3wide"):  # T3 holds a -0
        assert same_bits(y, want)
    else:
        assert torch.equal(y.view(torch.int16), want.view(torch.int16))


# (g, K, splits, workspace) launches the C entries refuse: a split not
# dividing K's units, none, more than one with no workspace, the SIMT
# kernel (g = 6) split
BAD_LAUNCHES = {
    "split": (64, LAB_K, 3, True),
    "zero_splits": (64, LAB_K, 0, False),
    "no_workspace": (64, LAB_K, 2, False),
    "simt_split": (6, 768, 2, True),
}


@pytest.mark.parametrize("case", list(BAD_LAUNCHES))
@pytest.mark.parametrize("fn", ["g8_hoist", "int4", "g8_ablate", "sep", "g8_rs", "gather16",
                                "slabstream", "pfdirect", "w3wide"])
def test_lab_loop_refuses_bad_launches(dev, fn, case):
    """The C entry refuses a launch it cannot run (cudaErrorInvalidValue)
    and writes nothing."""
    g, k, splits, with_work = BAD_LAUNCHES[case]
    inp = kernel_lab2.make_inputs(16, LAB_N, k, g=g, device=dev, w3=fn == "w3wide")
    y = torch.full((16, LAB_N), 7.0, dtype=torch.bfloat16, device=dev)
    work = torch.empty((max(splits, 1), 16, LAB_N), dtype=torch.float32, device=dev)
    ptrs = [inp.x.data_ptr(), inp.planes[0].data_ptr(), inp.scales.data_ptr()]
    wp = work.data_ptr() if with_work else None
    stream = torch.cuda.current_stream(dev).cuda_stream
    table = inp.table.float().contiguous()
    if fn == "int4":
        entry, _ = ops2._kernel_fn("int4")
        err = entry(*ptrs, y.data_ptr(), wp, 16, LAB_N, k, g, -0.4, 0.05, splits, stream)
    elif fn == "sep":
        entry, _ = ops2._kernel_fn("sep")
        err = entry(inp.x.data_ptr(), inp.planes_a[0].data_ptr(), inp.planes_b[0].data_ptr(),
                    inp.scales.data_ptr(), inp.sep_a.data_ptr(), inp.sep_b.data_ptr(),
                    y.data_ptr(), wp, 16, LAB_N, k, g, 0, splits, stream)
    elif fn == "g8_ablate":
        entry, _ = lab._kernel_fn("g8_ablate")
        err = entry(*ptrs, table.data_ptr(), y.data_ptr(), wp, 16, LAB_N, k, k, g, 1, 1, splits,
                    stream)
    elif fn == "gather16":
        entry, _ = lab._kernel_fn("gather16")
        err = entry(*ptrs, table.data_ptr(), y.data_ptr(), wp, 16, LAB_N, k, k, g, splits, stream)
    elif fn in ("slabstream", "pfdirect", "w3wide"):
        entry, _ = ops2._kernel_fn(fn)
        if fn == "w3wide":
            ptrs[1], table = inp.planes3[0].data_ptr(), inp.table3.float().contiguous()
        err = entry(*ptrs, table.data_ptr(), y.data_ptr(), wp, 16, LAB_N, k, g, splits, stream)
    else:  # g8_hoist, g8_rs
        entry, _ = lab._kernel_fn(fn)
        err = entry(*ptrs, table.data_ptr(), y.data_ptr(), wp, 16, LAB_N, k, k, g, 1, splits,
                    stream)
    torch.cuda.synchronize()
    assert err == 1  # cudaErrorInvalidValue
    assert bool((y == 7.0).all())


@pytest.mark.parametrize("fn", ["g8_ablate", "sep"])
def test_lab_loop_refused_launch_raises(dev, fn):
    """A launch the C entry refuses (a bk that is not a multiple of the
    chunk; an odd g) raises through the wrapper's launch and is not
    counted."""
    inp = kernel_lab2.make_inputs(16, LAB_N, LAB_K, device=dev, w3=False)
    mod = lab if fn == "g8_ablate" else ops2
    before, paths = dict(mod.LAUNCHES), dict(mod.LAST_PATH)
    with pytest.raises(RuntimeError, match="launch failed"):
        if fn == "g8_ablate":
            lab._launch("g8_ablate", inp.x, inp.planes[0], inp.scales, inp.table.float(), 384,
                        G, (1, 1))
        else:
            out = torch.empty((16, LAB_N), dtype=torch.bfloat16, device=dev)
            ops2._launch("sep", out, [inp.x, inp.planes_a[0], inp.planes_b[0], inp.scales,
                                      inp.sep_a, inp.sep_b], [None, 16, LAB_N, LAB_K, 3, 0, 1])
    assert mod.LAUNCHES == before and mod.LAST_PATH == paths


# ---------------------------------------------------------------------------
# The decode step in a CUDA graph; Gemma-2 on the card
# ---------------------------------------------------------------------------

FAMILIES = {
    "llama": (llama, llama.LlamaConfig.tiny()),
    "gemma2": (gemma2, gemma2.Gemma2Config.tiny()),
}


def tiny_model(dev, family):
    module, config = FAMILIES[family]
    params = module.init_params(config, seed=0, device=dev)
    return module, config, module.quantize_model(params, group_size=G, fuse=True, device=dev)


def reset_launches():
    for d in (lut_gemm.LAUNCHES, pa.LAUNCHES):
        for k in d:
            d[k] = 0


def bits32(y):
    return y.float().contiguous().view(torch.int32)


@pytest.mark.parametrize("family", list(FAMILIES))
def test_engine_graphed_step_is_the_eager_step(dev, family):
    """Engine's decode step: the first call runs eagerly and captures, later
    calls replay; a replay's logits have the eager step's bits on the same
    state, and LAUNCHES counts each replay's launches, not the capture."""
    module, config, qparams = tiny_model(dev, family)
    eng = Engine(params=qparams, config=config, forward=module.forward,
                 init_cache=module.init_cache, batch_size=4, max_len=64, device=dev)
    rng = np.random.default_rng(1)
    toks = torch.from_numpy(rng.integers(1, config.vocab_size, (4, 16))).to(dev)
    offs = torch.tensor([0, 3, 9, 15], device=dev)
    reset_launches()
    eng.prefill(toks, offs)
    nxt = toks[:, -1:]
    eng.decode_step(nxt, 16, offs)  # eager, then captured
    assert eng._graph.captured
    per_step = config.num_layers * 4  # a prefill, the eager first step
    assert {k: v for k, v in lut_gemm.LAUNCHES.items() if v} == {"w4sym": 2 * per_step}
    for pos in (17, 18):
        before = lut_gemm.LAUNCHES["w4sym"]
        graphed = eng.decode_step(nxt, pos, offs).clone()
        assert lut_gemm.LAUNCHES["w4sym"] == before + per_step
        eager = eng.decode(nxt, eng._cache, pos, offs)[0]
        assert torch.equal(bits32(graphed), bits32(eager)), pos
        assert lut_gemm.LAUNCHES["w4sym"] == before + 2 * per_step


def test_capture_survives_a_dropped_engine(dev):
    """A dropped engine's graph (freed by the garbage collector: engine and
    graph refer to each other) is collected before the next capture, and
    the collector stays off while a capture runs."""
    import gc
    import weakref

    from flute_tpu_torch.serving.graph import StepGraph

    x = torch.ones(4, device=dev)
    dropped = {"x": x}
    dropped["graph"] = StepGraph(lambda: dropped["x"] * 2, dev)  # a cycle
    dropped["graph"]()
    assert dropped["graph"].captured
    gone = weakref.ref(dropped["graph"])
    del dropped
    seen = []

    def step():
        seen.append(gc.isenabled())
        return x + 1

    graph = StepGraph(step, dev)
    graph()
    assert gone() is None
    assert seen == [gc.isenabled(), False]
    assert torch.equal(graph(), x + 1)


def paged_graph_pair(dev, family, pool_prefill, **kw):
    module, config, qparams = tiny_model(dev, family)
    engines = [PagedEngine(params=qparams, config=config, device=dev, pool_prefill=pool_prefill,
                           **kw) for _ in range(2)]
    engines[1]._graph = None  # the eager step on the card
    return config, engines


@pytest.mark.parametrize("family", list(FAMILIES))
def test_paged_graphed_step_is_the_eager_step(dev, family):
    config, (eng, _) = paged_graph_pair(dev, family, True, num_slots=3, block_size=8,
                                        num_blocks=16, max_len=32)
    for p in ([5, 9, 2, 14, 3, 8, 1, 6, 20, 21, 22], [11, 5, 3]):
        eng.submit(p, max_new_tokens=6)
    eng.step()  # admits both; its decode step runs eagerly and captures
    assert eng._graph.captured
    for _ in range(2):
        graphed = eng._step_logits().clone()  # a replay; K/V written at the same slots
        eager = eng._decode_logits(eng._step_tables, eng._step_lengths, eng._step_tokens)
        assert torch.equal(bits32(graphed), bits32(eager))
        eng.step()


@pytest.mark.parametrize("pool_prefill", [False, True])
@pytest.mark.parametrize("family", list(FAMILIES))
def test_paged_graph_through_admissions_finishes_and_a_queue(dev, family, pool_prefill):
    """Seven requests of other lengths and budgets on three slots and a pool
    that makes some wait: the graphed engine gives the eager engine's
    tokens, and its launches are exact under replay."""
    config, (graphed, eager) = paged_graph_pair(dev, family, pool_prefill, num_slots=3,
                                                block_size=8, num_blocks=9, max_len=40)
    rng = np.random.default_rng(2)
    requests = [(rng.integers(1, config.vocab_size, n).tolist(), b)
                for n, b in ((5, 6), (13, 3), (2, 9), (17, 4), (7, 7), (3, 2), (9, 5))]
    outs = []
    for eng in (graphed, eager):
        reset_launches()
        rids = [eng.submit(p, max_new_tokens=b) for p, b in requests]
        steps = 0
        waited = False
        while eng.step():
            steps += 1
            waited |= bool(eng._queue)
        out = eng.run()
        outs.append([out[r] for r in rids])
        assert waited and eng.blocks_in_use == 0
        prefills = len(requests)  # one chunk (or dense call) per admission
        want = {k: 0 for k in lut_gemm.LAUNCHES}
        want["w4sym"] = (steps + prefills) * config.num_layers * 4
        assert lut_gemm.LAUNCHES == want
        assert pa.LAUNCHES == {"paged_decode": steps * config.num_layers,
                               "paged_verify": (prefills if pool_prefill else 0)
                               * config.num_layers}
    assert outs[0] == outs[1]
    assert [len(o) for o in outs[0]] == [b for _, b in requests]


def test_gemma2_on_the_card_matches_the_cpu(dev):
    """Gemma-2 tiny (w4sym, fused) on the card against the CPU plain path:
    prefill and decode logits within the bf16 threshold; greedy Engine and
    PagedEngine (pool prefill, decode past the window of 8) tokens."""
    _, config, qparams = tiny_model(dev, "gemma2")
    qcpu = move_params(qparams, torch.device("cpu"))
    rng = np.random.default_rng(3)
    tokens = torch.from_numpy(rng.integers(0, config.vocab_size, (2, 16)))
    offsets = torch.tensor([0, 5])
    nxt = torch.from_numpy(rng.integers(0, config.vocab_size, (2, 1)))
    logits = {}
    for name, p, d in (("cuda", qparams, dev), ("cpu", qcpu, torch.device("cpu"))):
        cache = gemma2.init_cache(config, 2, 32, device=d)
        with torch.inference_mode():
            pre, cache = gemma2.forward(p, config, tokens.to(d), cache, 0, offsets.to(d))
            dec, _ = gemma2.forward(p, config, nxt.to(d), cache, torch.tensor(16, device=d),
                                    offsets.to(d))
        logits[name] = (pre.cpu(), dec.cpu())
    for got, want in zip(logits["cuda"], logits["cpu"]):
        assert float((got - want).abs().max() / want.abs().max()) < TOL[torch.bfloat16]
    prompts = [rng.integers(1, config.vocab_size, n).tolist() for n in (3, 11, 7)]
    outs = []
    for p, d in ((qparams, dev), (qcpu, "cpu")):
        eng = PagedEngine(params=p, config=config, num_slots=3, block_size=8, num_blocks=12,
                          max_len=32, pool_prefill=True, device=d)
        rids = [eng.submit(pr, max_new_tokens=10) for pr in prompts]
        out = eng.run()
        outs.append([out[r] for r in rids])
    assert sum(a == b for a, b in zip(*outs)) >= 2


# One Gemma-2-9B decoder layer's projections (N, K), fused qkv and gate_up
GEMMA2_SHAPES = [(8192, 3584), (3584, 4096), (28672, 3584), (3584, 14336)]


@pytest.mark.parametrize("m", [1, 8, 64])
@pytest.mark.parametrize("n,k", GEMMA2_SHAPES)
def test_k1_at_gemma2_shapes(dev, n, k, m):
    """K1 (w4sym, bf16, on the loop) at Gemma-2-9B's layer shapes (K = 3584
    is 14 chunks of 256) against the plain version; rows 0 and M-1 have the
    bits of the one-row call, and a repeat call the same bits."""
    rng = np.random.default_rng(n + k + m)
    codes = rng.integers(0, 16, size=(k, n), dtype=np.int32)
    mags = np.sort(np.abs(rng.standard_normal(8))).astype(np.float32)
    table = torch.from_numpy(np.concatenate([mags, -mags])).to(dev)
    plane = torch.from_numpy(packing.pack_w4_sym_np(codes, chunk=256)[0]).to(dev)
    scales = torch.from_numpy(rng.uniform(0.5, 1.5, (k // G, n)).astype(np.float32)).to(
        dev, torch.bfloat16)
    x = torch.from_numpy(rng.standard_normal((m, k)).astype(np.float32)).to(dev, torch.bfloat16)
    kw = dict(num_bits=4, layout="w4sym", config=KernelConfig(chunk=256))
    assert lut_gemm.lut_path(torch.bfloat16, 4, 256, "w4sym") == "mma"
    y = lut_gemm.lut_qgemm(x, [plane], scales, table, **kw)
    want = lut_gemm.lut_qgemm_plain(x, [plane], scales, table, num_bits=4, chunk=256,
                                    layout="w4sym")
    assert rel_err(y, want) < TOL[torch.bfloat16]
    assert torch.equal(lut_gemm.lut_qgemm(x, [plane], scales, table, **kw).view(torch.int16),
                       y.view(torch.int16))
    for i in {0, m - 1}:
        row = lut_gemm.lut_qgemm(x[i:i + 1], [plane], scales, table, **kw)
        assert torch.equal(row.view(torch.int16), y[i:i + 1].view(torch.int16))


@pytest.mark.parametrize("softcap,window", [(50.0, None), (50.0, 4096), (50.0, 300),
                                            (None, None)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_k5_k6_at_gemma2_heads(dev, dtype, softcap, window):
    """K5 and K6 at Gemma-2-9B's heads (16/8, D = 256, rep 2, scale
    256 ** -0.5) with its softcap and windows: K5 at lengths up to 4160
    (17 spans: the merge kernel) and K6 at T = 64 over 4096 cached, against
    their plain versions; K5's repeat call gives the same bits."""
    kw = dict(scale=256.0**-0.5, softcap=softcap, window=window)
    lengths = [0, 1, 255, 257, 1000, 4096, 4160, 37]
    q, kp, vp, tables, lens = k5_case(dev, dtype, lengths, 8, 16, 256, 16, 12, seed=71)
    assert pa.decode_spans(tables.shape[1], 16) == 17
    got = pa.paged_decode_attention(q, kp, vp, tables, lens, **kw)
    want = pa.paged_gqa_reference(q, kp, vp, tables, lens, **kw)
    assert torch.equal(pa.paged_decode_attention(q, kp, vp, tables, lens, **kw).view(torch.int16),
                       got.view(torch.int16))
    assert not got[0].float().any()
    assert max_rel(got[1:], want[1:]) < TOL[torch.bfloat16]
    mb = 4160 // 16 + 2
    q, kp, vp, tables = paged_case(dev, dtype, 2, 16, 8, 256, 16, mb, 2 * mb, seed=72, t=64)
    lens = torch.tensor([4096, 0], dtype=torch.int32, device=dev)
    got = pa.paged_verify_attention(q, kp, vp, tables, lens, **kw)
    want = pa.paged_verify_reference(q, kp, vp, tables, lens, **kw)
    assert max_rel(got, want) < TOL[torch.bfloat16]


# ---------------------------------------------------------------------------
# Continuous batching and speculative decoding on the card
# ---------------------------------------------------------------------------

SPEC_PROMPTS = ([5, 9, 2, 14, 3, 8, 1, 6, 20, 21, 22], [11, 5, 3])
# requests of other lengths and budgets: (prompt length, budget)
QUEUED = ((5, 6), (13, 3), (2, 9), (17, 4), (7, 7), (3, 2), (9, 5))


def queued_requests(config, seed=2):
    rng = np.random.default_rng(seed)
    return [(rng.integers(1, config.vocab_size, n).tolist(), b) for n, b in QUEUED]


def counting(eng, attr, counts, key):
    fn = getattr(eng, attr)

    def wrapped(*a, **kw):
        counts[key] = counts.get(key, 0) + 1
        return fn(*a, **kw)

    setattr(eng, attr, wrapped)


@pytest.mark.parametrize("family", list(FAMILIES))
def test_continuous_graphed_step_is_the_eager_step(dev, family):
    _, config, qparams = tiny_model(dev, family)
    eng = ContinuousBatchingEngine(params=qparams, config=config, num_slots=3, max_len=64,
                                   device=dev)
    for p in SPEC_PROMPTS:
        eng.submit(p, max_new_tokens=6)
    eng.step()  # admits both; its decode step runs eagerly and captures
    assert eng._graph.captured
    for _ in range(2):
        graphed = eng._step_logits().clone()  # a replay; K/V written at the same slots
        eager = eng._decode_logits(eng._step_tokens, eng._step_pos)
        assert torch.equal(bits32(graphed), bits32(eager))
        eng.step()


@pytest.mark.parametrize("family", list(FAMILIES))
def test_continuous_graph_through_admissions_and_a_queue(dev, family):
    """Seven requests on three slots, chunked prefill and a sampled one: the
    graphed engine gives the eager engine's tokens and logprobs, with exact
    launches under replay."""
    _, config, qparams = tiny_model(dev, family)
    requests = queued_requests(config)
    outs = []
    for graphed in (True, False):
        eng = ContinuousBatchingEngine(params=qparams, config=config, num_slots=3, max_len=40,
                                       prefill_chunk=8, device=dev)
        if not graphed:
            eng._graph = None
        calls = {}
        counting(eng, "_decode", calls, "steps")
        counting(eng, "_run_chunk", calls, "chunks")
        reset_launches()
        rids = [eng.submit(p, max_new_tokens=b, **({"temperature": 0.8, "seed": 4} if i == 2
                                                   else {}))
                for i, (p, b) in enumerate(requests)]
        out = eng.run()
        outs.append([(out[r], eng.finished_logprobs[r]) for r in rids])
        # a bucket prefill for prompts of 8 or fewer tokens, else chunks
        bucketed = sum(1 for p, _ in requests if len(p) <= 8)
        forwards = calls["steps"] + calls.get("chunks", 0) + bucketed
        want = {k: 0 for k in lut_gemm.LAUNCHES}
        want["w4sym"] = forwards * config.num_layers * 4
        assert lut_gemm.LAUNCHES == want
    assert outs[0] == outs[1]
    assert [len(t) for t, _ in outs[0]] == [b for _, b in requests]


@pytest.mark.parametrize("family", list(FAMILIES))
def test_speculative_graphed_steps_are_the_eager_steps(dev, family):
    """The dense engine's draft replay (its third call) and verify replay
    (its second) against the eager steps on the same state, bit for bit;
    the graphed engine gives the eager engine's tokens."""
    _, config, qparams = tiny_model(dev, family)
    outs, held = [], []
    for graphed in (True, False):
        eng = SpeculativeEngine(qparams, config, qparams, config, k=3, max_len=64, batch_size=2,
                                device=dev)
        if not graphed:
            eng._draft_graph = eng._verify_graph = None
        calls = {}
        for attr, eager, at in (
                ("_draft_step", lambda e=eng: e.draft_logits(e._d_tok, e._d_pos_buf, e._offsets), 3),
                ("_verify_step", lambda e=eng: e.verify_logits(e._v_toks, e._t_pos, e._offsets),
                 2)):
            fn = getattr(eng, attr)

            def wrapped(fn=fn, attr=attr, eager=eager, at=at):
                r = fn()
                calls[attr] = calls.get(attr, 0) + 1
                if calls[attr] == at and graphed:
                    held.append(torch.equal(bits32(r.clone()), bits32(eager())))
                return r

            setattr(eng, attr, wrapped)
        outs.append(eng.generate(list(SPEC_PROMPTS), max_new_tokens=12))
        if graphed:
            assert eng._draft_graph.captured and eng._verify_graph.captured
    assert held == [True, True]
    assert outs[0] == outs[1]


@pytest.mark.parametrize("pool_prefill", [False, True])
@pytest.mark.parametrize("family", list(FAMILIES))
def test_paged_speculative_graphs_launches_and_blocks(dev, family, pool_prefill):
    """Seven requests on three slots and a pool that makes some wait: the
    graphed engine's draft and verify replays have the eager steps' bits,
    it gives the eager engine's tokens, its launches are exact (K6 once a
    layer per verify and per pool-prefill chunk) and every block comes
    back."""
    _, config, qparams = tiny_model(dev, family)
    requests = queued_requests(config)
    outs, held = [], []
    for graphed in (True, False):
        eng = PagedSpeculativeEngine(params=qparams, config=config, draft_params=qparams,
                                     draft_config=config, k=3, num_slots=3, block_size=8,
                                     num_blocks=12, max_len=40, pool_prefill=pool_prefill,
                                     device=dev)
        if not graphed:
            eng._draft_graph = eng._verify_graph = None
        calls = {}
        for attr, eager, at in (
                ("_draft_step", lambda e=eng: e._draft_logits(e._d_tok, e._d_pos_buf), 3),
                ("_verify_step", lambda e=eng: e._verify_logits(e._step_tables, e._step_lengths,
                                                                e._v_toks), 2)):
            fn = getattr(eng, attr)

            def wrapped(fn=fn, attr=attr, eager=eager, at=at):
                r = fn()
                calls[attr] = calls.get(attr, 0) + 1
                if calls[attr] == at and graphed:
                    with torch.inference_mode():
                        saved = [dict(c) for c in (lut_gemm.LAUNCHES, pa.LAUNCHES)]
                        held.append(torch.equal(bits32(r.clone()), bits32(eager())))
                        for c, b in zip((lut_gemm.LAUNCHES, pa.LAUNCHES), saved):
                            c.update(b)
                return r

            setattr(eng, attr, wrapped)
        reset_launches()
        rids = [eng.submit(p, max_new_tokens=b) for p, b in requests]
        waited = False
        while eng.step():
            waited |= bool(eng._queue)
        out = eng.run()
        outs.append([out[r] for r in rids])
        assert waited and eng.blocks_in_use == 0
        prefills = len(requests)  # one chunk (or dense call) per admission, one draft prefill
        per_forward = config.num_layers * 4
        want = {k: 0 for k in lut_gemm.LAUNCHES}
        want["w4sym"] = (calls["_verify_step"] + calls["_draft_step"] + 2 * prefills) * per_forward
        assert lut_gemm.LAUNCHES == want
        assert pa.LAUNCHES == {"paged_decode": 0, "paged_verify": (
            calls["_verify_step"] + (prefills if pool_prefill else 0)) * config.num_layers}
    assert held == [True, True]
    assert outs[0] == outs[1]
    assert [len(o) for o in outs[0]] == [b for _, b in requests]


@pytest.mark.parametrize("family", list(FAMILIES))
def test_paged_speculative_sampling_on_the_card(dev, family):
    """Sampled slots on the card, graphed: a request's tokens depend on its
    seed alone (the same with other neighbours), a top-k 1 request is the
    greedy stream of the same prompt beside it, and every block comes
    back; the dense engine's top-k 1 stream is its greedy stream."""
    _, config, qparams = tiny_model(dev, family)
    sampled = dict(temperature=0.9, top_k=40, top_p=0.95, seed=123)
    prompt = list(SPEC_PROMPTS[0])
    outs = []
    for others in queued_requests(config, seed=3)[:2], queued_requests(config, seed=4)[:2]:
        eng = PagedSpeculativeEngine(params=qparams, config=config, draft_params=qparams,
                                     draft_config=config, k=3, num_slots=4, block_size=8,
                                     num_blocks=24, max_len=48, device=dev)
        rids = [eng.submit(prompt, max_new_tokens=12, **sampled),
                eng.submit(prompt, max_new_tokens=12),
                eng.submit(prompt, max_new_tokens=12, temperature=1.0, top_k=1, seed=5)]
        rids += [eng.submit(p, max_new_tokens=b) for p, b in others]
        out = eng.run()
        outs.append([out[r] for r in rids])
        assert eng._draft_graph.captured and eng._verify_graph.captured
        assert eng.blocks_in_use == 0
    assert outs[0][0] == outs[1][0] and len(outs[0][0]) == 12
    assert outs[0][2] == outs[0][1] and outs[1][2] == outs[1][1]
    greedy, top1 = (SpeculativeEngine(qparams, config, qparams, config, k=3, max_len=64,
                                      batch_size=2, device=dev).generate(
        list(SPEC_PROMPTS), max_new_tokens=10, sampling=s)
        for s in (None, SamplingParams(temperature=1.0, top_k=1, seed=3)))
    assert top1 == greedy


@pytest.mark.parametrize("n,k", [(6144, 4096), (4096, 4096), (28672, 4096), (4096, 14336)])
@pytest.mark.parametrize("layout,bits", [("w4sym", 4), ("plane", 2)])
def test_verify_rows_at_m40_have_the_bits_of_m8(dev, layout, bits, n, k):
    """A verify of k+1 = 5 tokens for 8 slots multiplies M = 40 rows: at the
    Llama-3.1-8B projection shapes, on K1 (the w4sym target) and K2 at 2
    bits (the W2 draft), every fifth row has the bits of the M = 8 call on
    those rows (the loop's split does not follow M). Random planes: any
    bits are valid codes."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(n + k)
    planes = [torch.randint(-2**31, 2**31 - 1, (k * bits // 32, n), generator=gen, device=dev,
                            dtype=torch.int32)]
    scales = (torch.rand((k // G, n), generator=gen, device=dev) + 0.5).bfloat16()
    table = torch.randn(2**bits, generator=gen, device=dev)
    if layout == "w4sym":
        mags = table[:8].abs().sort().values
        table = torch.cat([mags, -mags])
    x = torch.randn((40, k), generator=gen, device=dev).bfloat16()
    kw = dict(num_bits=bits, layout=layout, config=KernelConfig(chunk=256))
    y = lut_gemm.lut_qgemm(x, planes, scales, table, **kw)
    y8 = lut_gemm.lut_qgemm(x[::5], planes, scales, table, **kw)
    assert torch.equal(y[::5].view(torch.int16), y8.view(torch.int16))
    assert lut_gemm.lut_path(torch.bfloat16, bits, 256, layout) == "mma"


# the quantized heads: Llama-3.1-8B's [128256 -> 129024, 4096] and
# Gemma-2-9B's tied [256000, 3584]
HEAD_SHAPES = [(129024, 4096), (256000, 3584)]


@pytest.mark.parametrize("m", [1, 8])
@pytest.mark.parametrize("n,k", HEAD_SHAPES)
def test_k1_at_head_shapes(dev, n, k, m):
    """K1 (w4sym, bf16, on the loop) at the quantized heads' shapes against
    the plain version; rows 0 and M-1 have the bits of the one-row call.
    Random planes: any bits are valid w4sym codes."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(n + m)
    planes = [torch.randint(-2**31, 2**31 - 1, (k // 8, n), generator=gen, device=dev,
                            dtype=torch.int32)]
    scales = (torch.rand((k // G, n), generator=gen, device=dev) + 0.5).bfloat16()
    mags = torch.randn(8, generator=gen, device=dev).abs().sort().values
    table = torch.cat([mags, -mags])
    x = torch.randn((m, k), generator=gen, device=dev).bfloat16()
    kw = dict(num_bits=4, layout="w4sym", config=KernelConfig(chunk=256))
    y = lut_gemm.lut_qgemm(x, planes, scales, table, **kw)
    want = lut_gemm.lut_qgemm_plain(x, planes, scales, table, num_bits=4, chunk=256,
                                    layout="w4sym")
    assert rel_err(y, want) < TOL[torch.bfloat16]
    for i in {0, m - 1}:
        row = lut_gemm.lut_qgemm(x[i:i + 1], planes, scales, table, **kw)
        assert torch.equal(row.view(torch.int16), y[i:i + 1].view(torch.int16))


@pytest.mark.parametrize("family", ["llama", "gemma2"])
def test_quantized_head_on_the_card(dev, family):
    """A tiny model with its head quantized, on the card: logits within the
    bf16 threshold of the same params' on the CPU (relative to the largest),
    the head one K1 launch per forward, sliced to the vocabulary."""
    mod, config = FAMILIES[family]
    params = mod.init_params(config, seed=0, device="cpu")
    cpu = mod.quantize_model(params, 4, 64, fuse=True, quantize_lm_head=True, device="cpu")
    card = move_params(cpu, dev)
    toks = torch.tensor([[1, 2, 3, 4]])
    outs = []
    for p, d in ((cpu, "cpu"), (card, dev)):
        cache = mod.init_cache(config, 1, 8, device=d)
        before = lut_gemm.LAUNCHES["w4sym"]
        with torch.inference_mode():
            outs.append(mod.forward(p, config, toks.to(d), cache, 0)[0].cpu())
        if d == dev:
            assert lut_gemm.LAUNCHES["w4sym"] - before == config.num_layers * 4 + 1
    assert outs[1].shape == (1, 4, config.vocab_size)
    assert float((outs[1] - outs[0]).abs().max() / outs[0].abs().max()) < TOL[torch.bfloat16]


def test_server_on_the_card(dev):
    """The HTTP server over a ContinuousBatchingEngine on the card, whose
    decode graph is captured in the server's device thread: concurrent
    greedy answers, a streamed one and an n = 2 sampled one equal the same
    engine's direct submissions, and the metrics count them."""
    import json
    import threading
    import urllib.request

    from flute_tpu_torch.serving.server import serve

    config = llama.LlamaConfig.tiny()
    qparams = llama.quantize_model(llama.init_params(config, seed=0, device=dev), 4, 64,
                                   fuse=True, quantize_lm_head=True, device=dev)
    eng = ContinuousBatchingEngine(params=qparams, config=config, num_slots=4, max_len=64,
                                   device=dev)
    prompts = [[1, 5, 9], [2, 6, 10, 14], [3], [7, 8, 9, 10, 11]]
    sampled = dict(temperature=0.8, top_k=50, seed=9)
    srv = serve(eng, port=0)
    try:
        port = srv.server_address[1]

        def post(payload):
            req = urllib.request.Request(f"http://127.0.0.1:{port}/v1/completions",
                                         data=json.dumps(payload).encode(),
                                         headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=120) as r:
                return [json.loads(ln) for ln in r if ln.strip()]

        got = {}
        threads = [threading.Thread(target=lambda i=i: got.__setitem__(i, post(
            {"prompt": prompts[i], "max_tokens": 8})[0]["tokens"])) for i in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        streamed = [r["token"] for r in post({"prompt": prompts[0], "max_tokens": 8,
                                              "stream": True}) if "token" in r]
        choices = post({"prompt": prompts[1], "max_tokens": 8, "model": "m", "n": 2,
                        **sampled})[0]["choices"]
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics", timeout=30) as r:
            text = r.read().decode()
    finally:
        srv.shutdown()
        srv.server_close()
        srv.loop.shutdown()
    assert eng._graph.captured
    rids = [eng.submit(p, max_new_tokens=8) for p in prompts]
    rids += [eng.submit(prompts[1], max_new_tokens=8, seed=9 + i,
                        **{k: v for k, v in sampled.items() if k != "seed"}) for i in range(2)]
    out = eng.run()
    assert [got[i] for i in range(4)] == [out[r] for r in rids[:4]]
    assert streamed == got[0]
    assert [c["token_ids"] for c in choices] == [out[r] for r in rids[4:]]
    assert "flute_requests_total 7" in text and "flute_tokens_generated_total 56" in text


def test_perplexity_on_the_card(dev):
    """Perplexity of a tiny quantized model with its head quantized, on the
    card and on the CPU from the same params: within 1e-3."""
    from flute_tpu_torch import eval as teval

    config = llama.LlamaConfig.tiny()
    params = llama.init_params(config, seed=0, device="cpu")
    q = llama.quantize_model(params, 4, 64, fuse=True, quantize_lm_head=True, device="cpu")
    toks = np.random.default_rng(0).integers(0, config.vocab_size, 4 * 32)
    cpu = teval.perplexity(q, config, toks, seq_len=32, device="cpu")
    card = teval.perplexity(move_params(q, dev), config, toks, seq_len=32, batch_size=2,
                            device=dev)
    assert abs(card - cpu) / cpu < 1e-3


# -- the launch tuner and NFL (queue 1 items 15 and 13) ----------------------


@pytest.mark.parametrize("m", [8, 40])
@pytest.mark.parametrize("layout,bits,dtype", [("w4sym", 4, torch.bfloat16),
                                               ("auto", 3, torch.float16),
                                               ("plane", 2, torch.bfloat16),
                                               ("pair", 4, torch.bfloat16),
                                               ("w4sym", 4, torch.float32)])
def test_tuned_launches_have_the_planners_bits(dev, layout, bits, dtype, m):
    """Every candidate launch the tuner may take launches and passes its
    checks, among them the planner's bits; the winner is one of them; a
    layer tuned with ``tune_linear`` keeps its key and its output bits at
    M = 8 and 40."""
    from flute_tpu_torch import nn as tnn
    from flute_tpu_torch import tune
    from flute_tpu_torch.ops.kernel_config import get_candidate_configs, kernel_layout

    report = []
    best = tune.tune_config(m, 1024, 2048, bits, G, dtype, layout=layout, device=dev,
                            use_memo=False, report=report)
    candidates = get_candidate_configs(m, 1024, 2048, bits, G, dtype, kernel_layout(bits, layout))
    assert [r["launch"] for r in report] == [tune.launch_name(c) for c in candidates]
    assert all(r["passed"] and r["same_bits_as_planner"] for r in report)
    assert sum(r["chosen"] for r in report) == 1 and report[0]["planner"]
    assert (best.m_tiles or best.simt_block_m) in [r["m_tiles"] or r["simt_block_m"]
                                                   for r in report]
    if layout == "pair":
        return
    w = torch.randn((1024, 2048), device=dev)
    layer = tnn.quantize_linear(w, bits, G, dtype=dtype,
                                symmetric=None if layout == "w4sym" else False)
    tuned = tune.tune_linear(layer, m, use_memo=False)
    assert tuned.config_key == layer.config_key
    for rows in (1, m, 129):
        x = torch.randn((rows, 2048), device=dev).to(dtype)
        assert torch.equal(tuned(x), layer(x))


def test_nfl_gradient_on_the_card(dev):
    """``clm_loss`` backpropagates on the card (the dense head's product
    takes the f32 upcast while autograd needs it): in f32 its scale
    gradients are the CPU's, in bf16 they are finite and its loss is the
    inference forward's within the bf16 threshold."""
    import dataclasses

    from flute_tpu_torch.quantize import learnable

    base = llama.LlamaConfig.tiny()
    tokens = torch.randint(0, base.vocab_size, (2, 17), generator=torch.Generator().manual_seed(0))
    grads = {}
    for name, where, dtype in (("cpu", "cpu", torch.float32), ("card", dev, torch.float32),
                               ("bf16", dev, torch.bfloat16)):
        config = dataclasses.replace(base, dtype=dtype)
        params = llama.init_params(config, seed=0, device="cpu")
        params = move_params(params, where)
        lp = learnable.make_model_learnable(params, 4, 64)
        loss = learnable.clm_loss(lp, config, tokens.to(where), llama.forward)
        loss.backward()
        scales, _ = learnable.split_scales(lp)
        grads[name] = ({k: s.grad.cpu() for k, s in scales.items()}, loss.item())
        if name == "bf16":
            with torch.no_grad():
                ref = learnable.clm_loss(lp, config, tokens.to(where), llama.forward).item()
            assert abs(loss.item() - ref) <= TOL[torch.bfloat16] * abs(ref)
    for key, g in grads["cpu"][0].items():
        assert rel_err(grads["card"][0][key], g) < 1e-5, key
        assert torch.isfinite(grads["bf16"][0][key]).all() and grads["bf16"][0][key].abs().max() > 0


def test_bench_op_jax_form_times_k1(dev):
    """The JAX-form ``bench_op`` times K1 on the same inputs every call: one
    warm-up launch and ``iters`` captured ones, none at the replays; with
    ``warmup=False`` only the captured ones. ``bench_cycled`` makes its
    first call on each set, then its graph's."""
    import math

    from flute_tpu_torch.utils.benchmark import bench_cycled, bench_op

    _, x, plane, scales, table = w4sym_case(dev, 8, torch.bfloat16, seed=3)
    kw = dict(num_bits=4, layout="w4sym", config=KernelConfig(chunk=256))

    def k1(x_):
        return lut_gemm.lut_qgemm(x_, [plane], scales, table, **kw)

    for call, launches in ((dict(iters=20), 21), (dict(iters=16, warmup=False), 16),
                           (dict(iters=8, min_window=0.0), 9)):
        before = lut_gemm.LAUNCHES["w4sym"]
        t = bench_op(k1, x, **call)
        assert lut_gemm.LAUNCHES["w4sym"] - before == launches, call
        assert math.isfinite(t) and t > 0
    sets = [(plane, scales), (plane.clone(), scales.clone())]
    before = lut_gemm.LAUNCHES["w4sym"]
    t = bench_cycled(lambda p, s: lut_gemm.lut_qgemm(x, [p], s, table, **kw), sets,
                     min_launches=8)
    assert lut_gemm.LAUNCHES["w4sym"] - before == 2 + 8
    assert math.isfinite(t) and t > 0
    assert bench_op(lambda a: a, torch.ones(4, device=dev), iters=10) > 0


def test_bench_op_refuses_to_build_in_its_capture(dev):
    """With ``warmup=False`` an op that would load a kernel library inside
    the capture raises, naming the cause; nothing is built there."""
    from flute_tpu_torch.ops import _build
    from flute_tpu_torch.utils.benchmark import bench_op

    def loads(a):
        _build.load("lut_gemm_w4sym.cu")
        return a + 1

    with pytest.raises(RuntimeError, match="must be built before") as info:
        bench_op(loads, torch.ones(4, device=dev), iters=2, warmup=False)
    assert "CUDA graph capture" in str(info.value.__cause__)


# ---------------------------------------------------------------------------
# The wide-M kernel (csrc/lut_gemm_wide_m.cuh): K1 and K2 at prefill M
# ---------------------------------------------------------------------------


# the plan's crossovers that force each route for any M: (MID_MIN_M,
# WIDE_MIN_M)
ROUTE_BOUNDS = {"loop": (1 << 30, 1 << 30), "mid": (1, 1 << 30), "wide": (1 << 30, 1)}


def route_fn(layout, bits, planes, s, t, chunk=256, g=G, route=None):
    """The wrapper of K1 (``layout="w4sym"``), K2 (``"plane"``), K3
    (``"w3wide"``) or K4 (``"pair"``, ``t`` the pair table) on ``route``
    ("loop", "mid" or "wide": the plan's crossovers moved past M or to one
    row for the call; None: the plan's)."""
    kw = dict(group_size=g, chunk=chunk)

    def call(x):
        saved = kernel_config.MID_MIN_M, kernel_config.WIDE_MIN_M
        if route is not None:
            kernel_config.MID_MIN_M, kernel_config.WIDE_MIN_M = ROUTE_BOUNDS[route]
        try:
            if layout == "w4sym":
                return lut_gemm.lut_qgemm_w4sym_cuda(x, planes[0], s, t, **kw)
            if layout == "w3wide":
                return lut_gemm.lut_qgemm_w3wide_cuda(x, planes[0], s, t, **kw)
            if layout == "pair":
                return lut_gemm.lut_qgemm_pair_cuda(x, planes, s, t, num_bits=bits, **kw)
            return lut_gemm.lut_qgemm_plane_cuda(x, planes, s, t, num_bits=bits, **kw)
        finally:
            kernel_config.MID_MIN_M, kernel_config.WIDE_MIN_M = saved

    return call


def same_bits(a, b):
    return torch.equal(a.view(torch.int16), b.view(torch.int16))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_wgmma_gives_mma_sync_bits(dev, dtype):
    """One k16 step on 512 x 128 x 128 outputs of spread exponents: wgmma
    with x as A and w as B from shared memory, and with w as A from
    registers and x as B (the wide-M kernel's orientation), give
    mma.sync.m16n8k16's bits (the decode loop's), each within f32 rounding
    of the exact sum."""
    out = lut_gemm.wgmma_probe(dev, dtype, trials=512)
    assert out["a_differs"] == 0 and out["b_differs"] == 0
    assert max(out[f"{k}_max_rel_err"] for k in ("mma_sync", "a", "b")) < 1e-6


@pytest.mark.parametrize("g", [32, 64, 128])
@pytest.mark.parametrize("chunk", [128, 256])
@pytest.mark.parametrize("m", [128, 130, 300])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("layout,bits", LOOP_LAYOUTS)
def test_wide_has_the_loops_bits(dev, layout, bits, dtype, m, chunk, g):
    """The wide-M kernel (the plan's route from WIDE_MIN_M rows; the mid
    route's below it, so at 128 and 130 rows the wide route is forced) gives
    the decode loop's bits at full and ragged row tiles, groups within and
    across fields and split-K (K = 2048), within the threshold of the plain
    version; a launch counts in LAUNCHES and WIDE_LAUNCHES."""
    _, x, planes, s, t = loop_case(dev, layout, bits, m, 264, 2048, dtype, seed=m + bits + g,
                                   chunk=chunk, g=g)
    plan = "wide" if m >= kernel_config.WIDE_MIN_M else "mid"
    assert lut_gemm.mma_route(m, bits, chunk, layout, g) == plan
    before, wide_before = lut_gemm.LAUNCHES[layout], lut_gemm.WIDE_LAUNCHES[f"{layout}_wide"]
    if plan == "wide":
        y = lut_gemm.lut_qgemm(x, planes, s, t, num_bits=bits, layout=layout,
                               config=KernelConfig(chunk=chunk))
    else:
        y = route_fn(layout, bits, planes, s, t, chunk, g, route="wide")(x)
    assert lut_gemm.LAUNCHES[layout] == before + 1
    assert lut_gemm.WIDE_LAUNCHES[f"{layout}_wide"] == wide_before + 1
    loop = route_fn(layout, bits, planes, s, t, chunk, g, route="loop")(x)
    assert same_bits(y, loop)
    y_plain = lut_gemm.lut_qgemm_plain(x, planes, s, t, num_bits=bits, chunk=chunk,
                                       layout=layout)
    torch.cuda.synchronize()
    assert rel_err(y, y_plain) < TOL[dtype]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("layout,bits", LOOP_LAYOUTS)
def test_wide_rows_at_m2047_have_the_one_row_bits(dev, layout, bits, dtype):
    """Rows 0 and M - 1 of a call at M = 2047 (the wide-M kernel) have the
    bits of the one-row call (the loop), and a repeat call the same bits."""
    _, x, planes, s, t = loop_case(dev, layout, bits, 2047, 384, 2048, dtype, seed=50 + bits,
                                   chunk=256)
    call = route_fn(layout, bits, planes, s, t)
    y = call(x)
    assert same_bits(call(x), y)
    for i in (0, 2046):
        assert same_bits(call(x[i:i + 1]), y[i:i + 1])
    assert rel_err(y, lut_gemm.lut_qgemm_plain(x, planes, s, t, num_bits=bits, chunk=256,
                                               layout=layout)) < TOL[dtype]


@pytest.mark.parametrize("m", [128, 300, 512])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("layout,bits", LOOP_LAYOUTS)
def test_wide_identity_bit_exact(dev, layout, bits, dtype, m):
    """Identity rows through the wide-M kernel give the oracle's bits (K1
    with a mixed-sign table)."""
    codes, _, planes, s, t = loop_case(dev, layout, bits, 1, 256, 512, dtype, seed=51, chunk=256,
                                       mixed_signs=True)
    eye = torch.eye(m, 512, dtype=dtype, device=dev)
    got = route_fn(layout, bits, planes, s, t, route="wide")(eye)
    want = lut_gemm.dequantize_codes(codes, s, t, dtype)[:m]
    assert same_bits(got, want)


@pytest.mark.parametrize("layout,bits", LOOP_LAYOUTS)
def test_wide_refuses_f32_and_does_not_fall_back(dev, layout, bits):
    """The wide-M C entry given f32 (no 16-bit tensor path) raises and
    counts no launch: nothing falls back to the loop or the plain version.
    Through the wrapper f32 takes the SIMT kernel at every M."""
    _, x, planes, s, t = loop_case(dev, layout, bits, 256, 256, 512, torch.float32, seed=52,
                                   chunk=256)
    launches, wide = dict(lut_gemm.LAUNCHES), dict(lut_gemm.WIDE_LAUNCHES)
    extra = () if layout == "w4sym" else (bits,)
    ptrs = [p.data_ptr() for p in planes] + [None] * (2 - len(planes) - (layout == "w4sym"))
    with pytest.raises(RuntimeError, match="wide-M kernel launch failed"):
        lut_gemm._launch_wide(layout, x, ptrs, s, t, group_size=G, chunk=256, extra=extra)
    assert lut_gemm.LAUNCHES == launches and lut_gemm.WIDE_LAUNCHES == wide
    assert lut_gemm.lut_path(torch.float32, bits, 256, layout) == "simt"
    y = route_fn(layout, bits, planes, s, t, route="wide")(x)
    assert lut_gemm.WIDE_LAUNCHES == wide
    assert rel_err(y, lut_gemm.lut_qgemm_plain(x, planes, s, t, num_bits=bits, chunk=256,
                                               layout=layout)) < TOL[torch.float32]


@pytest.mark.parametrize("n", [196, 198])
@pytest.mark.parametrize("layout,bits", LOOP_LAYOUTS)
def test_wide_stages_by_cp_async_where_tma_does_not_take_n(dev, layout, bits, n):
    """N not a multiple of 8 (196: 16-byte plane copies; 198: 4-byte ones)
    stages the plane words and scales by cp.async, with the loop's bits."""
    _, x, planes, s, t = loop_case(dev, layout, bits, 130, n, 1024, torch.bfloat16, seed=53,
                                   chunk=256)
    y = route_fn(layout, bits, planes, s, t, route="wide")(x)
    assert same_bits(y, route_fn(layout, bits, planes, s, t, route="loop")(x))
    assert rel_err(y, lut_gemm.lut_qgemm_plain(x, planes, s, t, num_bits=bits, chunk=256,
                                               layout=layout)) < TOL[torch.bfloat16]



# ---------------------------------------------------------------------------
# K3 (w3wide) and K4 (pair) on the wide-M kernel
# ---------------------------------------------------------------------------

# (layout, bits, chunk): K3 at both of its chunks, K4 at every bit width
K3_K4_WIDE = [("w3wide", 3, 256), ("w3wide", 3, 512), ("pair", 2, 256), ("pair", 3, 256),
              ("pair", 4, 256), ("pair", 4, 128)]


def wide_case(dev, layout, bits, m, n, k, dtype, seed, chunk, g=G):
    """codes, x, planes, scales, the table (K4: the pair table) and the
    oracle's dequantized weight for K3 or K4."""
    if layout == "pair":
        codes, x, planes, s, pv = mma_pair_case(dev, bits, m, n, k, dtype, seed, chunk, g)
        return codes, x, planes, s, pv, lut_gemm.dequantize_codes_pair(codes, s, pv, dtype)
    codes, x, planes, s, t = loop_case(dev, layout, bits, m, n, k, dtype, seed, chunk, g)
    return codes, x, planes, s, t, lut_gemm.dequantize_codes(codes, s, t, dtype)


def plain_of(layout, bits, x, planes, s, t, chunk):
    if layout == "pair":
        return lut_gemm.lut_qgemm_plain(x, planes, s, torch.zeros(2**bits, device=x.device),
                                        num_bits=bits, chunk=chunk, layout="plane",
                                        pair_values=t)
    return lut_gemm.lut_qgemm_plain(x, planes, s, t, num_bits=bits, chunk=chunk, layout=layout)


@pytest.mark.parametrize("g", [8, 64, 128])
@pytest.mark.parametrize("m", [128, 130, 512, 2047])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("layout,bits,chunk", K3_K4_WIDE)
def test_k3_k4_wide_has_the_loops_bits(dev, layout, bits, chunk, dtype, m, g):
    """K3 and K4 from WIDE_MIN_M rows take the wide-M kernel (forced at 128
    and 130 rows, the mid route's in the plan) and give the decode loop's
    bits at full and ragged row tiles (N = 264: a ragged column tile),
    split-K (K = 2048), groups within and across fields (K3: a chunk's
    scales once per field where g is a multiple of 2 kc, the per-field
    cache at g = 8 and at chunk 512 below that), within the threshold of
    the plain version; a repeat call has the same bits, and at M = 2047
    rows 0 and M - 1 the one-row call's."""
    _, x, planes, s, t, _ = wide_case(dev, layout, bits, m, 264, 2048, dtype,
                                      seed=m + bits + g + chunk, chunk=chunk, g=g)
    plan = "wide" if m >= kernel_config.WIDE_MIN_M else "mid"
    assert kernel_config.mma_route(m, bits, chunk, layout, g) == plan
    before, wide_before = lut_gemm.LAUNCHES[layout], lut_gemm.WIDE_LAUNCHES[f"{layout}_wide"]
    call = route_fn(layout, bits, planes, s, t, chunk, g, route=None if plan == "wide" else "wide")
    y = call(x)
    assert lut_gemm.LAUNCHES[layout] == before + 1
    assert lut_gemm.WIDE_LAUNCHES[f"{layout}_wide"] == wide_before + 1
    assert same_bits(y, route_fn(layout, bits, planes, s, t, chunk, g, route="loop")(x))
    assert same_bits(call(x), y)
    if m == 2047:
        for i in (0, m - 1):
            assert same_bits(call(x[i:i + 1]), y[i:i + 1])
    y_plain = plain_of(layout, bits, x, planes, s, t, chunk)
    torch.cuda.synchronize()
    assert rel_err(y, y_plain) < TOL[dtype]


@pytest.mark.parametrize("m", [128, 300])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("layout,bits,chunk", K3_K4_WIDE)
def test_k3_k4_wide_identity_bit_exact(dev, layout, bits, chunk, dtype, m):
    """Identity rows through the wide-M kernel give the oracle's bits."""
    _, _, planes, s, t, deq = wide_case(dev, layout, bits, 1, 256, 512, dtype, seed=61,
                                        chunk=chunk)
    eye = torch.eye(m, 512, dtype=dtype, device=dev)
    got = route_fn(layout, bits, planes, s, t, chunk, route="wide")(eye)
    assert same_bits(got, deq[:m])


@pytest.mark.parametrize("n", [196, 198])
@pytest.mark.parametrize("layout,bits,chunk", K3_K4_WIDE)
def test_k3_k4_wide_stages_by_cp_async_where_tma_does_not_take_n(dev, layout, bits, chunk, n):
    """N not a multiple of 8 (196: 16-byte plane copies; 198: 4-byte ones)
    stages the plane words and scales by cp.async, with the loop's bits."""
    _, x, planes, s, t, _ = wide_case(dev, layout, bits, 130, n, 1024, torch.bfloat16, seed=62,
                                      chunk=chunk)
    y = route_fn(layout, bits, planes, s, t, chunk, route="wide")(x)
    assert same_bits(y, route_fn(layout, bits, planes, s, t, chunk, route="loop")(x))
    assert rel_err(y, plain_of(layout, bits, x, planes, s, t, chunk)) < TOL[torch.bfloat16]


@pytest.mark.parametrize("layout,bits,chunk", K3_K4_WIDE)
def test_k3_k4_wide_refuses_f32_and_does_not_fall_back(dev, layout, bits, chunk):
    """The wide-M C entry given f32 raises and counts no launch: nothing
    falls back to the loop or the plain version. Through the wrapper K4
    refuses f32 (as JAX's pair_lut mode does) and K3 takes its SIMT kernel
    at every M."""
    _, x, planes, s, t, _ = wide_case(dev, layout, bits, 256, 256, 512, torch.float32, seed=63,
                                      chunk=chunk)
    launches, wide = dict(lut_gemm.LAUNCHES), dict(lut_gemm.WIDE_LAUNCHES)
    extra = (bits,) if layout == "pair" else ()
    ptrs = [p.data_ptr() for p in planes] + [None] * (2 - len(planes) - (layout == "w3wide"))
    with pytest.raises(RuntimeError, match="wide-M kernel launch failed"):
        lut_gemm._launch_wide(layout, x, ptrs, s, t, group_size=G, chunk=chunk, extra=extra)
    assert lut_gemm.LAUNCHES == launches and lut_gemm.WIDE_LAUNCHES == wide
    if layout == "pair":
        with pytest.raises(NotImplementedError, match="16-bit"):
            route_fn(layout, bits, planes, s, t, chunk, route="wide")(x)
        assert lut_gemm.LAUNCHES == launches
        return
    assert lut_gemm.lut_path(torch.float32, bits, chunk, layout) == "simt"
    y = route_fn(layout, bits, planes, s, t, chunk, route="wide")(x)
    assert lut_gemm.WIDE_LAUNCHES == wide
    assert rel_err(y, plain_of(layout, bits, x, planes, s, t, chunk)) < TOL[torch.float32]


@pytest.mark.parametrize("layout,bits,chunk", [("w3wide", 3, 128), ("pair", 2, 64),
                                               ("pair", 4, 32)])
def test_k3_k4_wide_refused_launch_raises(dev, layout, bits, chunk):
    """A launch the wide-M kernel does not take (K3 at a chunk that is not a
    multiple of 256; K4 at a chunk whose stage holds one item of 4 or 8
    fields, so its units do not pair up) raises, counts nothing and runs
    nothing else; the plan never routes such a layer there."""
    _, x, planes, s, t, _ = wide_case(dev, layout, bits, 256, 256, 512, torch.bfloat16, seed=64,
                                      chunk=256 if layout == "w3wide" else chunk)
    assert kernel_config.mma_route(256, bits, chunk, layout, G) == "loop"
    launches, wide = dict(lut_gemm.LAUNCHES), dict(lut_gemm.WIDE_LAUNCHES)
    extra = (bits,) if layout == "pair" else ()
    ptrs = [p.data_ptr() for p in planes] + [None] * (2 - len(planes) - (layout == "w3wide"))
    with pytest.raises(RuntimeError, match="wide-M kernel launch failed"):
        lut_gemm._launch_wide(layout, x, ptrs, s, t, group_size=G, chunk=chunk, extra=extra)
    assert lut_gemm.LAUNCHES == launches and lut_gemm.WIDE_LAUNCHES == wide


# ---------------------------------------------------------------------------
# The wide-M kernel's mid route: K1 and K2 at 16-127 rows
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("g", [32, 128])
@pytest.mark.parametrize("chunk", [128, 256])
@pytest.mark.parametrize("m", [16, 40, 48, 64, 100])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("layout,bits", LOOP_LAYOUTS)
def test_k1_k2_mid_has_the_loops_bits(dev, layout, bits, dtype, m, chunk, g):
    """The mid route (row tiles of 16-64 rows, one split of K a block, the
    workspace and the loop's reduction) gives the decode loop's bits at
    full and ragged row and column tiles (N = 264), groups within and
    across fields and split-K (K = 2048), within the threshold of the plain
    version; a launch counts in LAUNCHES and MID_LAUNCHES."""
    _, x, planes, s, t = loop_case(dev, layout, bits, m, 264, 2048, dtype, seed=m + bits + g,
                                   chunk=chunk, g=g)
    assert kernel_config.mid_takes_chunk(bits, chunk, g, layout)
    assert lut_gemm.mid_plan(m, 264, 2048, chunk).splits > 1
    before, mid_before = lut_gemm.LAUNCHES[layout], lut_gemm.MID_LAUNCHES[f"{layout}_mid"]
    y = route_fn(layout, bits, planes, s, t, chunk, g, route="mid")(x)
    assert lut_gemm.LAUNCHES[layout] == before + 1
    assert lut_gemm.MID_LAUNCHES[f"{layout}_mid"] == mid_before + 1
    assert same_bits(y, route_fn(layout, bits, planes, s, t, chunk, g, route="loop")(x))
    y_plain = lut_gemm.lut_qgemm_plain(x, planes, s, t, num_bits=bits, chunk=chunk,
                                       layout=layout)
    torch.cuda.synchronize()
    assert rel_err(y, y_plain) < TOL[dtype]


@pytest.mark.parametrize("m", [17, 40, 100])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("layout,bits", LOOP_LAYOUTS)
def test_k1_k2_mid_rows_and_one_split(dev, layout, bits, dtype, m):
    """The plan's route at M (the mid route from MID_MIN_M rows): rows 0
    and M - 1 have the one-row call's bits and a repeat call the same
    bits; with one split (K one chunk) the blocks write y themselves, with
    the loop's bits."""
    _, x, planes, s, t = loop_case(dev, layout, bits, m, 384, 4096, dtype, seed=70 + bits,
                                   chunk=256)
    assert kernel_config.mma_route(m, bits, 256, layout) == "mid"
    call = route_fn(layout, bits, planes, s, t)
    y = call(x)
    assert same_bits(call(x), y)
    for i in (0, m - 1):
        assert same_bits(call(x[i:i + 1]), y[i:i + 1])
    _, x1, planes1, s1, t1 = loop_case(dev, layout, bits, m, 384, 256, dtype, seed=71 + bits,
                                       chunk=256)
    assert lut_gemm.mid_plan(m, 384, 256, 256).splits == 1
    y1 = route_fn(layout, bits, planes1, s1, t1, route="mid")(x1)
    assert same_bits(y1, route_fn(layout, bits, planes1, s1, t1, route="loop")(x1))


@pytest.mark.parametrize("m", [16, 40, 100])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("layout,bits", LOOP_LAYOUTS)
def test_k1_k2_mid_identity_bit_exact(dev, layout, bits, dtype, m):
    """Identity rows through the mid route give the oracle's bits (K1 with
    a mixed-sign table)."""
    codes, _, planes, s, t = loop_case(dev, layout, bits, 1, 256, 512, dtype, seed=72, chunk=256,
                                       mixed_signs=True)
    eye = torch.eye(m, 512, dtype=dtype, device=dev)
    got = route_fn(layout, bits, planes, s, t, route="mid")(eye)
    assert same_bits(got, lut_gemm.dequantize_codes(codes, s, t, dtype)[:m])


@pytest.mark.parametrize("n", [196, 198])
@pytest.mark.parametrize("layout,bits", LOOP_LAYOUTS)
def test_k1_k2_mid_stages_by_cp_async_where_tma_does_not_take_n(dev, layout, bits, n):
    """N not a multiple of 8 (196: 16-byte plane copies; 198: 4-byte ones)
    stages the plane words and scales by cp.async, with the loop's bits."""
    _, x, planes, s, t = loop_case(dev, layout, bits, 40, n, 1024, torch.bfloat16, seed=73,
                                   chunk=256)
    y = route_fn(layout, bits, planes, s, t, route="mid")(x)
    assert same_bits(y, route_fn(layout, bits, planes, s, t, route="loop")(x))
    assert rel_err(y, lut_gemm.lut_qgemm_plain(x, planes, s, t, num_bits=bits, chunk=256,
                                               layout=layout)) < TOL[torch.bfloat16]


def mid_ptrs(layout, planes):
    """A mid C entry's plane pointers (null for a plane the layout lacks)."""
    return [p.data_ptr() for p in planes] + [None] * (2 - len(planes)
                                                      - (layout in ("w4sym", "w3wide")))


@pytest.mark.parametrize("layout,bits", LOOP_LAYOUTS)
def test_k1_k2_mid_refuses_f32_and_does_not_fall_back(dev, layout, bits):
    """The mid C entry given f32 raises and counts no launch: nothing falls
    back to the loop or the plain version. Through the wrapper f32 takes
    the SIMT kernel at every M."""
    _, x, planes, s, t = loop_case(dev, layout, bits, 40, 256, 512, torch.float32, seed=74,
                                   chunk=256)
    launches, mid = dict(lut_gemm.LAUNCHES), dict(lut_gemm.MID_LAUNCHES)
    extra = () if layout == "w4sym" else (bits,)
    with pytest.raises(RuntimeError, match="mid-M kernel launch failed"):
        lut_gemm._launch_mid(layout, x, mid_ptrs(layout, planes), s, t, group_size=G, chunk=256,
                             extra=extra)
    assert lut_gemm.LAUNCHES == launches and lut_gemm.MID_LAUNCHES == mid
    y = route_fn(layout, bits, planes, s, t, route="mid")(x)
    assert lut_gemm.MID_LAUNCHES == mid
    assert rel_err(y, lut_gemm.lut_qgemm_plain(x, planes, s, t, num_bits=bits, chunk=256,
                                               layout=layout)) < TOL[torch.float32]


@pytest.mark.parametrize("layout,bits", LOOP_LAYOUTS)
def test_k1_k2_mid_refused_launch_raises(dev, layout, bits, monkeypatch):
    """A launch the mid route does not take raises and counts nothing: a
    row tile it is not built for, and several splits without a
    workspace."""
    _, x, planes, s, t = loop_case(dev, layout, bits, 40, 256, 2048, torch.bfloat16, seed=75,
                                   chunk=256)
    extra = () if layout == "w4sym" else (bits,)
    launches, mid = dict(lut_gemm.LAUNCHES), dict(lut_gemm.MID_LAUNCHES)
    plan = kernel_config.mid_plan(40, 256, 2048, 256)
    assert plan.splits > 1
    monkeypatch.setattr(lut_gemm, "mid_plan", lambda *a: kernel_config.MidPlan(
        rows=24, splits=plan.splits, grid=plan.grid))
    with pytest.raises(RuntimeError, match="mid-M kernel launch failed"):
        lut_gemm._launch_mid(layout, x, mid_ptrs(layout, planes), s, t, group_size=G, chunk=256,
                             extra=extra)
    fn, _ = lut_gemm._entry(*lut_gemm._MID[layout])
    y = torch.empty((40, 256), dtype=torch.bfloat16, device=dev)
    args = (x.data_ptr(), *mid_ptrs(layout, planes), s.data_ptr(), t.data_ptr(), y.data_ptr(),
            None, 40, 256, 2048, G, 256, *extra, lut_gemm._DTYPE_TAG[torch.bfloat16],
            plan.rows, plan.splits, 1, torch.cuda.current_stream(dev).cuda_stream)
    assert fn(*args) != 0
    assert lut_gemm.LAUNCHES == launches and lut_gemm.MID_LAUNCHES == mid


# ---------------------------------------------------------------------------
# The wide-M kernel's mid route: K3 (w3wide) and K4 (pair) at 17-127 rows
# ---------------------------------------------------------------------------

# (layout, bits, chunk): K3 at both of its chunks, K4 at every bit width
K3_K4_MID = K3_K4_WIDE


@pytest.mark.parametrize("g", [8, 16, 64, 128])
@pytest.mark.parametrize("m", [16, 40, 48, 64, 100])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("layout,bits,chunk", K3_K4_MID)
def test_k3_k4_mid_has_the_loops_bits(dev, layout, bits, chunk, dtype, m, g):
    """K3 and K4 on the mid route (row tiles of 16-64 rows, one split of K a
    block, the workspace and the loop's reduction) give the decode loop's
    bits at full and ragged row and column tiles (N = 264), split-K (K =
    2048), groups within and across fields (K3: a chunk's scales once per
    field, two blocks an SM, where g is a multiple of 2 kc; the per-field
    cache, one block an SM, at g = 8 and at chunk 512 at g = 16), within
    the threshold of the plain version; a repeat call has the same bits; a
    launch counts in LAUNCHES and MID_LAUNCHES."""
    _, x, planes, s, t, _ = wide_case(dev, layout, bits, m, 264, 2048, dtype,
                                      seed=m + bits + g + chunk + 5, chunk=chunk, g=g)
    assert kernel_config.mid_takes_chunk(bits, chunk, g, layout)
    assert kernel_config.mid_plan(m, 264, 2048, chunk).splits > 1
    before, mid_before = lut_gemm.LAUNCHES[layout], lut_gemm.MID_LAUNCHES[f"{layout}_mid"]
    call = route_fn(layout, bits, planes, s, t, chunk, g, route="mid")
    y = call(x)
    assert lut_gemm.LAUNCHES[layout] == before + 1
    assert lut_gemm.MID_LAUNCHES[f"{layout}_mid"] == mid_before + 1
    assert same_bits(y, route_fn(layout, bits, planes, s, t, chunk, g, route="loop")(x))
    assert same_bits(call(x), y)
    y_plain = plain_of(layout, bits, x, planes, s, t, chunk)
    torch.cuda.synchronize()
    assert rel_err(y, y_plain) < TOL[dtype]


@pytest.mark.parametrize("m", [17, 40, 100])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("layout,bits,chunk", K3_K4_MID)
def test_k3_k4_mid_rows_and_one_split(dev, layout, bits, chunk, dtype, m):
    """The plan's route at M (the mid route from MID_MIN_M rows):
    rows 0 and M - 1 have the one-row call's bits and a repeat call the
    same bits; with one split (K one chunk) the blocks write y themselves,
    with the loop's bits."""
    _, x, planes, s, t, _ = wide_case(dev, layout, bits, m, 384, 4096, dtype, seed=80 + bits,
                                      chunk=chunk)
    assert kernel_config.mma_route(m, bits, chunk, layout) == "mid"
    call = route_fn(layout, bits, planes, s, t, chunk)
    y = call(x)
    assert same_bits(call(x), y)
    for i in (0, m - 1):
        assert same_bits(call(x[i:i + 1]), y[i:i + 1])
    _, x1, planes1, s1, t1, _ = wide_case(dev, layout, bits, m, 384, chunk, dtype,
                                          seed=81 + bits, chunk=chunk)
    assert lut_gemm.mid_plan(m, 384, chunk, chunk).splits == 1
    y1 = route_fn(layout, bits, planes1, s1, t1, chunk, route="mid")(x1)
    assert same_bits(y1, route_fn(layout, bits, planes1, s1, t1, chunk, route="loop")(x1))


@pytest.mark.parametrize("m", [16, 40, 100])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("layout,bits,chunk", K3_K4_MID)
def test_k3_k4_mid_identity_bit_exact(dev, layout, bits, chunk, dtype, m):
    """Identity rows through the mid route give the oracle's bits, with a
    chunk's scales and (K3, g = 8) with the per-field cache."""
    for g in (G, 8):
        _, _, planes, s, t, deq = wide_case(dev, layout, bits, 1, 256, 512, dtype, seed=82 + g,
                                            chunk=chunk, g=g)
        eye = torch.eye(m, 512, dtype=dtype, device=dev)
        got = route_fn(layout, bits, planes, s, t, chunk, g, route="mid")(eye)
        assert same_bits(got, deq[:m])


@pytest.mark.parametrize("n", [196, 198])
@pytest.mark.parametrize("layout,bits,chunk", K3_K4_MID)
def test_k3_k4_mid_stages_by_cp_async_where_tma_does_not_take_n(dev, layout, bits, chunk, n):
    """N not a multiple of 8 (196: 16-byte plane copies; 198: 4-byte ones)
    stages the plane words and scales by cp.async, with the loop's bits."""
    _, x, planes, s, t, _ = wide_case(dev, layout, bits, 40, n, 1024, torch.bfloat16, seed=83,
                                      chunk=chunk)
    y = route_fn(layout, bits, planes, s, t, chunk, route="mid")(x)
    assert same_bits(y, route_fn(layout, bits, planes, s, t, chunk, route="loop")(x))
    assert rel_err(y, plain_of(layout, bits, x, planes, s, t, chunk)) < TOL[torch.bfloat16]


@pytest.mark.parametrize("layout,bits,chunk", K3_K4_MID)
def test_k3_k4_mid_refuses_f32_and_does_not_fall_back(dev, layout, bits, chunk):
    """The mid C entry given f32 raises and counts no launch: nothing falls
    back to the loop or the plain version. Through the wrapper K4 refuses
    f32 (as JAX's pair_lut mode does) and K3 takes its SIMT kernel at every
    M."""
    _, x, planes, s, t, _ = wide_case(dev, layout, bits, 40, 256, 512, torch.float32, seed=84,
                                      chunk=chunk)
    launches, mid = dict(lut_gemm.LAUNCHES), dict(lut_gemm.MID_LAUNCHES)
    extra = (bits,) if layout == "pair" else ()
    with pytest.raises(RuntimeError, match="mid-M kernel launch failed"):
        lut_gemm._launch_mid(layout, x, mid_ptrs(layout, planes), s, t, group_size=G,
                             chunk=chunk, extra=extra)
    assert lut_gemm.LAUNCHES == launches and lut_gemm.MID_LAUNCHES == mid
    if layout == "pair":
        with pytest.raises(NotImplementedError, match="16-bit"):
            route_fn(layout, bits, planes, s, t, chunk, route="mid")(x)
        assert lut_gemm.LAUNCHES == launches
        return
    assert lut_gemm.lut_path(torch.float32, bits, chunk, layout) == "simt"
    y = route_fn(layout, bits, planes, s, t, chunk, route="mid")(x)
    assert lut_gemm.MID_LAUNCHES == mid
    assert rel_err(y, plain_of(layout, bits, x, planes, s, t, chunk)) < TOL[torch.float32]


@pytest.mark.parametrize("layout,bits,chunk", K3_K4_MID)
def test_k3_k4_mid_refused_launch_raises(dev, layout, bits, chunk, monkeypatch):
    """A launch the mid route does not take raises and counts nothing: a
    row tile it is not built for, several splits without a workspace, and
    K3 at a chunk that is not a multiple of 256 (the plan never routes such
    a layer there)."""
    _, x, planes, s, t, _ = wide_case(dev, layout, bits, 40, 256, 2048, torch.bfloat16, seed=85,
                                      chunk=chunk)
    extra = (bits,) if layout == "pair" else ()
    launches, mid = dict(lut_gemm.LAUNCHES), dict(lut_gemm.MID_LAUNCHES)
    plan = kernel_config.mid_plan(40, 256, 2048, chunk)
    assert plan.splits > 1
    with monkeypatch.context() as patch:
        patch.setattr(lut_gemm, "mid_plan", lambda *a: kernel_config.MidPlan(
            rows=24, splits=plan.splits, grid=plan.grid))
        with pytest.raises(RuntimeError, match="mid-M kernel launch failed"):
            lut_gemm._launch_mid(layout, x, mid_ptrs(layout, planes), s, t, group_size=G,
                                 chunk=chunk, extra=extra)
    fn, _ = lut_gemm._entry(*lut_gemm._MID[layout])
    y = torch.empty((40, 256), dtype=torch.bfloat16, device=dev)

    def entry(work, chunk_arg):
        return fn(x.data_ptr(), *mid_ptrs(layout, planes), s.data_ptr(), t.data_ptr(),
                  y.data_ptr(), work, 40, 256, 2048, G, chunk_arg, *extra,
                  lut_gemm._DTYPE_TAG[torch.bfloat16], plan.rows, plan.splits, 1,
                  torch.cuda.current_stream(dev).cuda_stream)

    assert entry(None, chunk) != 0
    if layout == "w3wide":
        work = torch.empty((plan.splits, 40, 256), dtype=torch.float32, device=dev)
        assert kernel_config.mma_route(40, bits, 128, layout, G) == "loop"
        assert entry(work.data_ptr(), 128) != 0
    assert lut_gemm.LAUNCHES == launches and lut_gemm.MID_LAUNCHES == mid
