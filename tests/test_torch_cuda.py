"""Card-only checks of the port: the w4sym kernel against its plain version
on the same CUDA tensors, and the model and engine through the kernel.

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
from flute_tpu_torch.models import llama
from flute_tpu_torch.ops import lut_gemm
from flute_tpu_torch.ops.kernel_config import KernelConfig
from flute_tpu_torch.serving import Engine

pytestmark = pytest.mark.cuda

TOL = {torch.bfloat16: 1.1e-2, torch.float16: 2.0e-3, torch.float32: 1e-5}
DTYPES = list(TOL)
N, K, G = 384, 512, 64


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the w4sym kernel has no CPU mode")
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


@pytest.mark.parametrize("chunk", [128, 256])
@pytest.mark.parametrize("m", [1, 3, 8, 9, 40])
@pytest.mark.parametrize("dtype", DTYPES)
def test_kernel_vs_plain(dev, dtype, m, chunk):
    _, x, plane, s, t = w4sym_case(dev, m, dtype, seed=m, chunk=chunk)
    cfg = KernelConfig(chunk=chunk)
    before = lut_gemm.LAUNCHES
    y = lut_gemm.lut_qgemm(x, plane, s, t, num_bits=4, layout="w4sym", config=cfg)
    assert lut_gemm.LAUNCHES == before + 1
    y_plain = lut_gemm.lut_qgemm_plain(x, [plane], s, t, num_bits=4, chunk=chunk, layout="w4sym")
    torch.cuda.synchronize()
    assert y.dtype == dtype and tuple(y.shape) == (m, N)
    assert rel_err(y, y_plain) < TOL[dtype]


@pytest.mark.parametrize("mixed_signs", [False, True])
@pytest.mark.parametrize("dtype", DTYPES)
def test_identity_bit_exact(dev, dtype, mixed_signs):
    codes, _, plane, s, t = w4sym_case(dev, 1, dtype, seed=11, mixed_signs=mixed_signs)
    eye = torch.eye(K, dtype=dtype, device=dev)
    got = lut_gemm.qgemm(eye, plane, s, t, 4, G, layout="w4sym")
    want = lut_gemm.dequantize_codes(codes, s, t, dtype)
    assert torch.equal(got.float(), want.float())


@pytest.mark.parametrize("chunk", [128, 256])
def test_unpack_via_kernel_and_reconstruct(dev, chunk):
    codes, _, plane, s, t = w4sym_case(dev, 1, torch.bfloat16, seed=12, chunk=chunk)
    back = packing.unpack_via_kernel([plane], 4, N, K, chunk=chunk, layout="w4sym")
    assert torch.equal(back, codes)
    with_kernel = packing.reconstruct([plane], s, t, 4, chunk=chunk, layout="w4sym")
    without = packing.reconstruct([plane], s, t, 4, chunk=chunk, use_kernel=False,
                                  layout="w4sym")
    assert torch.equal(with_kernel.float(), without.float())


def test_other_layouts_raise_on_cuda(dev):
    codes, x, _, s, t = w4sym_case(dev, 2, torch.bfloat16, seed=13)
    c = codes.cpu().numpy()
    plane4 = [torch.from_numpy(p).to(dev) for p in packing.pack_np(c, 4)]
    wide = [torch.from_numpy(p).to(dev) for p in packing.pack_w3_wide_np(c % 8)]
    with pytest.raises(NotImplementedError, match="K2"):
        lut_gemm.lut_qgemm(x, plane4, s, t, num_bits=4)
    with pytest.raises(NotImplementedError):
        lut_gemm.lut_qgemm(x, wide, s, t[:8], num_bits=3)
    with pytest.raises(NotImplementedError):
        lut_gemm.lut_qgemm(x, plane4, s, t, num_bits=4, pair_values=torch.ones(16, 16, 2,
                                                                            device=dev))


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


def test_model_and_engine_through_the_kernel(dev):
    config = llama.LlamaConfig.tiny()
    params = llama.init_params(config, seed=0, device=dev)
    qparams = llama.quantize_model(params, num_bits=4, group_size=G, fuse=True, device=dev)
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
    before = lut_gemm.LAUNCHES
    out = eng.generate(prompts, max_new_tokens=5)
    # one prefill and four decode steps, four projections in each of 2 layers
    assert lut_gemm.LAUNCHES - before == 5 * config.num_layers * 4
    assert [len(o) for o in out] == [5, 5, 5]
