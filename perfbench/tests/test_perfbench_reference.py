"""The plain reference against the port at toy sizes on the CPU: the
formats' dequantization, the rotation, and the whole model's logits."""

import numpy as np
import pytest
import torch

import tiny
from harness.system import build_params, llama_config
from harness.weights import Inputs
from reference import model as ref
from reference import quant


def test_nf4_grid_is_the_ports():
    from flute_tpu_torch.quantize import nf

    assert np.array_equal(np.asarray(quant.NF4_SYM, np.float32),
                          nf.nf_values_symmetric_exact(4))


def test_w4sym_dequantization_matches_the_port():
    from flute_tpu_torch.nn import quantize_linear

    w = (torch.randn(512, 384, generator=torch.Generator().manual_seed(1)) * 0.02
         ).to(torch.bfloat16)
    mine = quant.nf4_sym_dequantized(w, 64)
    layer = quantize_linear(w.T, 4, 64, device="cpu")
    assert layer.layout == "w4sym"
    port = layer.dequantize(torch.float32)
    # the port rounds table value and product to bf16 as the kernel does
    assert torch.allclose(mine, port, rtol=2 ** -7, atol=0)


def test_higgs_dequantization_matches_the_port():
    from flute_tpu_torch.quantize import higgs

    g = torch.Generator().manual_seed(2)
    codes = torch.randint(0, 256, (256, 384), generator=g, dtype=torch.uint8)
    grid = torch.randn(256, 2, generator=g)
    scales = (0.015 + 0.01 * torch.rand(512 // 64, 384, generator=g)).to(torch.bfloat16)
    mine = quant.higgs_dequantized(codes, grid, scales, 64)
    layer = higgs.from_higgs(codes, grid.numpy(), scales, num_bits=4, group_size=64,
                             hadamard_size=256, device="cpu")
    port = layer.dequantize(torch.float32)
    assert torch.allclose(mine, port, rtol=2 ** -7, atol=0)


@pytest.mark.parametrize("size", [64, 256, 512])
def test_rotation_matches_the_port(size):
    from flute_tpu_torch.ops.hadamard import grouped_hadamard_transform

    x = torch.randn(5, 1024, generator=torch.Generator().manual_seed(size))
    assert torch.allclose(quant.rotate(x, size), grouped_hadamard_transform(x, size),
                          atol=1e-5)


@pytest.mark.parametrize("cfg", ["tiny.w4sym", "tiny.higgs"])
def test_model_logits_match_the_port(cfg):
    """The port's forward (bf16 activations, the plain LUT-GEMM) and the
    float32 reference over the same inputs agree to bf16 rounding."""
    from flute_tpu_torch.models import llama

    model = tiny.CONFIGS[cfg]
    inputs = Inputs(model, 2**31 + 3, "cpu")
    params = build_params(model, inputs, 4)
    toks = torch.randint(0, model["vocab_size"], (1, 40),
                         generator=torch.Generator().manual_seed(4))
    config = llama_config(model)
    with torch.inference_mode():
        cache = llama.init_cache(config, 1, 64, device="cpu")
        port, _ = llama.forward(params, config, toks, cache, 0)
    mine = ref.logits(model, inputs, [toks[0].tolist()], [0])[0]
    err = (port[0] - mine).abs().max() / mine.abs().max()
    assert err < 3e-2
    # and the greedy choices agree wherever the reference is not near a tie
    top2 = mine.topk(2, dim=-1).values
    clear = (top2[:, 0] - top2[:, 1]) > 0.1 * mine.abs().max()
    assert torch.equal(port[0].argmax(-1)[clear], mine.argmax(-1)[clear])


def test_fp8_control_is_coarser():
    model = tiny.CONFIGS["tiny.w4sym"]
    inputs = Inputs(model, 7, "cpu")
    seq = list(range(1, 30))
    full = ref.logits(model, inputs, [seq], [0])[0]
    low = ref.logits(model, inputs, [seq], [0], fp8=True)[0]
    err = (full - low).abs().max() / full.abs().max()
    assert 1e-3 < err < 0.5
