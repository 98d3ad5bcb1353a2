"""NFL (learned-scale calibration) in the port against the JAX package on
the same seeded inputs: the fake-quantized weight (f32, to 1e-6), the
gradient of the calibration loss with respect to every scale (to 1e-5 of
the largest), three Adam steps of ``learn_scales`` on tiny Llama in f32
(losses and scales to 1e-5, at the CLI's default learning rate 1e-4), and
the finalized planes, scales and tables bit for bit.

The straight-through estimator picks codes with a hard threshold, so two
runs whose scales differ by an ulp can put a weight on either side of a
pivot; at the default learning rate no code moves in these three steps."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_llama import to_numpy_tree

from flute_tpu.models import gemma2 as jgemma2
from flute_tpu.models import llama as jllama
from flute_tpu.quantize import learnable as jlearn
from flute_tpu_torch import interop
from flute_tpu_torch.models import gemma2, llama
from flute_tpu_torch.nn import QuantizedLinear
from flute_tpu_torch.quantize import learnable

TOL = 1e-5


def rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def pair(seed, symmetric):
    w = np.random.default_rng(seed).standard_normal((256, 128)).astype(np.float32)  # [in, out]
    return (jlearn.make_learnable(jnp.asarray(w), 4, 64, symmetric=symmetric),
            learnable.make_learnable(torch.from_numpy(w), 4, 64, symmetric=symmetric))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("symmetric", [False, True])
def test_fake_quantized_weight_matches(symmetric, dtype):
    jl, tl = pair(7, symmetric)
    np.testing.assert_array_equal(tl.scales.detach().numpy(), np.asarray(jl.scales))
    np.testing.assert_array_equal(tl.table.numpy(), np.asarray(jl.table))
    want = np.asarray(jl.fake_quantized_weight(getattr(jnp, dtype)), np.float32)
    got = tl.fake_quantized_weight(getattr(torch, dtype)).float().detach().numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    x = np.random.default_rng(1).standard_normal((4, 256)).astype(np.float32)
    np.testing.assert_allclose(tl(torch.from_numpy(x)).detach().numpy(),
                               np.asarray(jl(jnp.asarray(x))), rtol=1e-5, atol=1e-5)


def test_layer_gradient_matches():
    jl, tl = pair(9, None)
    x = np.random.default_rng(2).standard_normal((4, 256)).astype(np.float32)
    g = jax.grad(lambda s: jnp.sum(dataclasses.replace(jl, scales=s)(jnp.asarray(x)) ** 2))(
        jl.scales)
    (tl(torch.from_numpy(x)) ** 2).sum().backward()
    assert np.abs(np.asarray(g)).max() > 0
    assert rel(tl.scales.grad.numpy(), g) < TOL


def tiny_f32(family="llama"):
    if family == "gemma2":
        jc = dataclasses.replace(jgemma2.Gemma2Config.tiny(), dtype=jnp.float32)
        tc = dataclasses.replace(gemma2.Gemma2Config.tiny(), dtype=torch.float32)
        jp = jgemma2.init_params(jc, rng=4)
        return jc, tc, jp, interop.params_from_numpy(to_numpy_tree(jp), device="cpu"), \
            jgemma2.forward, gemma2.forward
    jc = dataclasses.replace(jllama.LlamaConfig.tiny(), dtype=jnp.float32)
    tc = dataclasses.replace(llama.LlamaConfig.tiny(), dtype=torch.float32)
    jp = jllama.init_params(jc, rng=0)
    return jc, tc, jp, interop.params_from_numpy(to_numpy_tree(jp), device="cpu"), \
        jllama.forward, llama.forward


@pytest.mark.parametrize("family", ["llama", "gemma2"])
def test_loss_gradient_matches(family):
    """d loss / d scales through the whole model, the cache written in
    place under autograd (the port's forward writes its cache in place)."""
    jc, tc, jp, tp, jfwd, tfwd = tiny_f32(family)
    tokens = np.random.default_rng(3).integers(0, jc.vocab_size, (2, 17)).astype(np.int32)
    s, rest = jlearn.split_scales(jlearn.make_model_learnable(jp, 4, 64))
    jloss, g = jax.value_and_grad(
        lambda s: jlearn.clm_loss(jlearn.merge_scales(s, rest), jc, jnp.asarray(tokens), jfwd))(s)
    lp = learnable.make_model_learnable(tp, 4, 64)
    loss = learnable.clm_loss(lp, tc, torch.from_numpy(tokens).long(), tfwd)
    loss.backward()
    assert rel(loss.item(), float(jloss)) < TOL
    ts, _ = learnable.split_scales(lp)
    assert sorted(ts) == sorted(g)
    for key in g:
        assert rel(ts[key].grad.numpy(), g[key]) < TOL, key


@pytest.fixture(scope="module")
def trained():
    """Three Adam steps of learn_scales in both packages, f32 tiny Llama."""
    jc, tc, jp, tp, _, _ = tiny_f32()
    rng = np.random.default_rng(0)
    batches = [rng.integers(0, jc.vocab_size, (2, 17)).astype(np.int32) for _ in range(3)]
    jlosses, tlosses = [], []
    jt = jlearn.learn_scales(jp, jc, batches, callback=lambda i, v: jlosses.append(v))
    tt = learnable.learn_scales(tp, tc, batches, callback=lambda i, v: tlosses.append(v))
    return jt, tt, jlosses, tlosses


def test_learn_scales_matches(trained):
    jt, tt, jlosses, tlosses = trained
    assert len(tlosses) == 3
    for a, b in zip(tlosses, jlosses):
        assert rel(a, b) < TOL
    for jl, tl in zip(jt["layers"], tt["layers"]):
        for key in learnable.PROJ_KEYS:
            assert rel(tl[key].scales.detach().numpy(), jl[key].scales) < TOL, key


def test_finalize_model_matches(trained):
    """Finalized from JAX's trained scales, the port's layers carry JAX's
    planes, scales and tables bit for bit (w4sym, the 4-bit default)."""
    jt, tt, _, _ = trained
    jfinal = jlearn.finalize_model(jt)
    # the port's trained tree with JAX's scales, so that the codes are JAX's
    for jl, tl in zip(jt["layers"], tt["layers"]):
        for key in learnable.PROJ_KEYS:
            with torch.no_grad():
                tl[key].scales.copy_(torch.from_numpy(np.array(jl[key].scales)))
    tfinal = learnable.finalize_model(tt)
    for jl, tl in zip(jfinal["layers"], tfinal["layers"]):
        for key in learnable.PROJ_KEYS:
            a, b = jl[key], tl[key]
            assert isinstance(b, QuantizedLinear) and b.layout == a.layout == "w4sym"
            for pa, pb in zip(a.planes, b.planes):
                np.testing.assert_array_equal(pb.numpy(), np.asarray(pa))
            np.testing.assert_array_equal(b.scales.float().numpy(),
                                          np.asarray(a.scales, np.float32))
            np.testing.assert_array_equal(b.table.numpy(), np.asarray(a.table))


@pytest.mark.parametrize("bits", [3, 4])
def test_finalize_matches(bits):
    w = np.random.default_rng(bits).standard_normal((512, 256)).astype(np.float32)
    jl = jlearn.make_learnable(jnp.asarray(w), bits, 64)
    tl = learnable.make_learnable(torch.from_numpy(w), bits, 64)
    s = np.asarray(jl.scales) * np.random.default_rng(11).uniform(0.9, 1.1, jl.scales.shape)
    jl = dataclasses.replace(jl, scales=jnp.asarray(s, jnp.float32))
    with torch.no_grad():
        tl.scales.copy_(torch.from_numpy(np.array(jl.scales)))
    a, b = jlearn.finalize(jl), learnable.finalize(tl)
    assert b.layout == a.layout == ("w4sym" if bits == 4 else "auto")
    assert len(b.planes) == len(a.planes)
    for pa, pb in zip(a.planes, b.planes):
        np.testing.assert_array_equal(pb.numpy(), np.asarray(pa))
    np.testing.assert_array_equal(b.scales.float().numpy(), np.asarray(a.scales, np.float32))
    # the finalized layer holds the learnable layer's fake-quantized values
    np.testing.assert_array_equal(b.dequantize(torch.bfloat16).float().numpy(),
                                  tl.fake_quantized_weight(torch.bfloat16).float()
                                  .detach().numpy())


def test_symmetric_default_lands_on_w4sym():
    _, tl = pair(9, None)
    assert learnable.finalize(tl).layout == "w4sym"
    _, tl = pair(9, False)
    assert learnable.finalize(tl).layout == "auto"


def test_learn_scales_lowers_the_loss_on_a_fixed_batch():
    """Eight steps over one fixed batch (as the chip check runs it) lower
    the loss, and the finalized tree serves."""
    _, tc, _, tp, _, _ = tiny_f32()
    batch = np.random.default_rng(8).integers(0, 100, (2, 16))
    losses = []
    out = learnable.learn_scales(tp, tc, [batch] * 8, learning_rate=3e-3,
                                 callback=lambda i, v: losses.append(v))
    assert losses[-1] < losses[0], losses
    final = learnable.finalize_model(out)
    cache = llama.init_cache(tc, 1, 8, device="cpu")
    logits, _ = llama.forward(final, tc, torch.tensor([[1, 2, 3]]), cache, 0)
    assert torch.isfinite(logits).all()
