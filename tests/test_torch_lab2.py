"""The second half of the port's kernel lab (``flute_tpu_torch.lab.ops2``,
``kernel_lab2``) against the JAX lab (``scripts/kernel_lab2.py``).

The same numpy inputs (``default_rng(0)`` in the JAX ``main``'s order, the
3-bit codes after x) go through the JAX lab's ``run_*`` functions, with
``pl.pallas_call`` in interpret mode, and through the port's plain versions
on the CPU, at M16 N256 K512 g64, bn 128, bk 256 and 512. Tolerance:
relative Frobenius error under 1.1e-2 (bf16).

L8, L9 and L12 index their gathers with raw fields (up to 255, 15 and 63)
that the v5e reads mod 8 (``flute_tpu/ops/lut_gemm.py:72-75``); the Pallas
interpreter clamps them instead. So every JAX run here has the loaded
module's ``_gather_sublane`` mask its index with ``& 7`` (the ``wrap``
fixture), and ``test_interpret_mode_without_the_wrap_is_not_the_reference``
pins how far the unpatched interpreter is from the reference. No file of
the JAX package changes.

L8 (``pfdirect``), L9 (``sep``), L10 (``int4``), L11 (``slabstream``) and
L12 (``w3wide``) share L6's tensor-core loop and its plan
(``test_torch_lab.py``); their paths per g, refusals and plain versions at
the loop's other group sizes are checked here. The kernels against these
plain versions on the card are in ``test_torch_cuda.py``.
"""

import functools
import importlib.util
import math
from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

import flute_tpu
from flute_tpu import packing as jpacking
from flute_tpu.ops import lut_gemm as jlut
from flute_tpu.quantize import nf as jnf
from flute_tpu_torch import packing
from flute_tpu_torch.lab import kernel_lab2, ops2
from flute_tpu_torch.lab import ops as lab

ROOT = Path(__file__).resolve().parent.parent
M, N, K, G, BN = 16, 256, 512, 64, 128
GEMMS = ("prod", "pfdirect", "sep", "sep1", "int4", "slabstream", "w3wide")


def rel_err(y, y_ref):
    y = np.asarray(y, dtype=np.float64)
    y_ref = np.asarray(y_ref, dtype=np.float64)
    return np.linalg.norm(y - y_ref) / np.linalg.norm(y_ref)


def bf16(a):
    return np.asarray(jnp.asarray(np.asarray(a, np.float32)).astype(jnp.bfloat16), np.float32)


@pytest.fixture(scope="module")
def jax_lab():
    """``scripts/kernel_lab2.py`` loaded as a module."""
    spec = importlib.util.spec_from_file_location("jax_kernel_lab2",
                                                  ROOT / "scripts" / "kernel_lab2.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def jax_inputs(mod, m):
    """The JAX ``main``'s inputs, drawn in its order (packed by the numpy
    reference packer, which the JAX tests hold the native one to)."""
    rng = np.random.default_rng(0)
    codes = rng.integers(0, 16, size=(K, N), dtype=np.int32)
    pack = functools.partial(jpacking.pack_np, use_native=False)
    planes = [jnp.asarray(p) for p in pack(codes, 4)]
    scales = jnp.asarray(rng.uniform(0.5, 1.5, (K // G, N)), jnp.bfloat16)
    x = jnp.asarray(rng.standard_normal((m, K)), jnp.bfloat16)
    codes3 = rng.integers(0, 8, size=(K, N), dtype=np.int32)
    return dict(codes=codes, planes=planes, scales=scales, x=x, codes3=codes3,
                table=jnf.nf_values(4), table3=jnf.nf_values(3),
                pa=[jnp.asarray(p) for p in pack(codes & 3, 2)],
                pb=[jnp.asarray(p) for p in pack(codes >> 2, 2)],
                p3=[jnp.asarray(p) for p in mod.pack_w3wide_np(codes3)])


@pytest.fixture(scope="module")
def inputs(jax_lab):
    """(JAX inputs, port inputs) at M=16 and, for the identity runs, 512."""
    return {m: (jax_inputs(jax_lab, m), kernel_lab2.make_inputs(m, N, K, device="cpu"))
            for m in (M, K)}


@pytest.fixture
def interpret(monkeypatch):
    """Every ``pl.pallas_call`` in interpret mode, as the JAX tests run them
    on the CPU."""
    monkeypatch.setattr(pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True))


@pytest.fixture
def wrap(jax_lab, monkeypatch):
    """The v5e's gather: the index read mod 8."""
    monkeypatch.setattr(jax_lab, "_gather_sublane",
                        lambda op, idx: jlut._gather_sublane(op, idx & 7))


@pytest.fixture(scope="module")
def wrapped_runs():
    """JAX results with the wrap modelled, kept for the tests that reuse
    them: (variant, bk) -> output."""
    return {}


def run_jax_wrapped(mod, runs, j, name, bk):
    """``run_jax`` at M=16 with the wrap modelled, once per (variant, bk)
    in the module."""
    if (name, bk) not in runs:
        runs[name, bk] = run_jax(mod, name, j, j["x"], M, bk)
    return runs[name, bk]


def run_jax(mod, name, j, x, bm, bk):
    """The JAX lab's function of GEMM variant ``name`` on inputs ``j``."""
    bn, g = BN, G
    if name == "prod":
        cfg = flute_tpu.KernelConfig(block_m=bm, block_n=bn, block_k=bk)
        y = jlut.lut_qgemm(x, j["planes"], j["scales"], j["table"], num_bits=4, config=cfg)
    elif name in ("sep", "sep1"):
        y = mod.run_sep(x, j["pa"], j["pb"], j["scales"], jnp.asarray(kernel_lab2.SEP_A),
                        jnp.asarray(kernel_lab2.SEP_B), bm, bn, bk, g, name == "sep1")
    elif name == "int4":
        y = mod.run_int4(x, j["planes"], j["scales"], bm, bn, bk, g, kernel_lab2.INT4_ZERO,
                         kernel_lab2.INT4_DELTA)
    elif name == "w3wide":
        y = mod.run_w3wide(x, j["p3"], j["scales"], j["table3"], bm, bn, bk, g)
    else:
        run = {"pfdirect": mod.run_pfdirect, "slabstream": mod.run_slabstream}[name]
        y = run(x, j["planes"], j["scales"], j["table"], bm, bn, bk, g)
    return np.asarray(y, np.float32)


def run_port(name, inp, x, bm, bk):
    inp = SimpleNamespace(**dict(vars(inp), x=x))
    y = kernel_lab2.run_variant(name, inp, kernel_lab2.operands(name, inp), bm, BN, bk)
    assert y.dtype == torch.bfloat16 and tuple(y.shape) == (x.shape[0], N)
    return y.float().numpy()


def test_make_inputs_match_jax(inputs):
    j, p = inputs[M]
    np.testing.assert_array_equal(p.codes, j["codes"])
    np.testing.assert_array_equal(p.codes3, j["codes3"])
    for tp, jp in ((p.planes, j["planes"]), (p.planes_a, j["pa"]), (p.planes_b, j["pb"]),
                   (p.planes3, j["p3"])):
        for a, b in zip(tp, jp, strict=True):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    np.testing.assert_array_equal(p.table.numpy(), np.asarray(j["table"]))
    np.testing.assert_array_equal(p.table3.numpy(), np.asarray(j["table3"]))
    for t, a in ((p.scales, j["scales"]), (p.x, j["x"])):
        assert t.dtype == torch.bfloat16
        np.testing.assert_array_equal(t.view(torch.int16).numpy(), np.asarray(a).view(np.int16))


@pytest.mark.parametrize("bk", [256, 512])
@pytest.mark.parametrize("name", GEMMS)
def test_lab2_case_vs_jax(jax_lab, inputs, interpret, wrap, wrapped_runs, name, bk):
    j, p = inputs[M]
    want = run_jax_wrapped(jax_lab, wrapped_runs, j, name, bk)
    got = run_port(name, p, p.x, M, bk)
    assert np.isfinite(want).all() and np.isfinite(got).all()
    assert rel_err(got, want) < 1.1e-2


def identity_model(name, p):
    """What each function gives for x the identity (K = M = 512), from its
    derivation: one product per output, every sum and product in f32."""
    codes = p.codes3 if name == "w3wide" else p.codes
    s = np.repeat(p.scales.float().numpy(), G, axis=0)
    if name == "int4":
        sd = (s * np.float32(kernel_lab2.INT4_DELTA)).astype(np.float32)
        sz = (s * np.float32(kernel_lab2.INT4_ZERO)).astype(np.float32)
        return bf16((codes * sd).astype(np.float32) + sz)
    if name in ("sep", "sep1"):
        w = bf16(kernel_lab2.SEP_A[codes & 3]) + bf16(kernel_lab2.SEP_B[codes >> 2])
        return bf16(bf16(w) * s if name == "sep1" else w * s)
    table = p.table3 if name == "w3wide" else p.table
    return bf16(bf16(table.numpy()[codes]) * s)


@pytest.mark.parametrize("name", GEMMS)
def test_lab2_identity_bit_exact(jax_lab, inputs, interpret, wrap, name):
    """x the identity: the port equals the JAX lab and the numpy model of
    the derivation bit for bit (the sign of zero aside: where T3[c] is -0,
    the TPU's sum gives +0)."""
    j, p = inputs[K]
    eye = np.eye(K, dtype=np.float32)
    want = run_jax(jax_lab, name, j, jnp.asarray(eye, jnp.bfloat16), K, 256)
    got = run_port(name, p, torch.from_numpy(eye).bfloat16(), K, 256)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, identity_model(name, p))


@pytest.mark.parametrize("nops", [2, 8])
def test_vmembw_bit_exact(jax_lab, interpret, nops):
    w = kernel_lab2.vmembw_block("cpu")
    rows, bn = kernel_lab2.VMEMBW_SHAPE
    want = pl.pallas_call(functools.partial(jax_lab.vmembw_kernel, nops=nops),
                          out_shape=jax.ShapeDtypeStruct((rows, bn), jnp.int32))(
        jnp.asarray(w.numpy()))
    got = ops2.vmembw(w, nops)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    v = w.numpy()
    for _ in range(nops):
        v = v ^ (v >> 1)
    np.testing.assert_array_equal(got.numpy(), v)


def test_pfdirect_equals_slabstream(jax_lab, inputs, interpret, wrap, wrapped_runs):
    """L8 and L11 build one operand in two orders: bit for bit equal, in the
    JAX lab and in the port."""
    j, p = inputs[M]
    a = run_jax_wrapped(jax_lab, wrapped_runs, j, "pfdirect", 512)
    b = run_jax_wrapped(jax_lab, wrapped_runs, j, "slabstream", 512)
    np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(run_port("pfdirect", p, p.x, M, 512),
                                  run_port("slabstream", p, p.x, M, 512))


@pytest.mark.parametrize("name", ["pfdirect", "sep", "w3wide"])
def test_interpret_mode_without_the_wrap_is_not_the_reference(jax_lab, inputs, interpret,
                                                               name):
    """The interpreter clamps the raw gather index where the v5e wraps it:
    without the wrap modelled, the lab's own rel is at least 0.5."""
    j, p = inputs[M]
    got = run_jax(jax_lab, name, j, j["x"], M, 256)
    want = kernel_lab2.oracle(name, p).numpy()
    assert np.abs(got - want).max() / np.abs(want).max() >= 0.5


def test_the_labs_w3wide_packer_is_the_ports(jax_lab, inputs):
    codes3 = inputs[M][1].codes3
    want = packing.pack_w3_wide_np(codes3)[0]
    np.testing.assert_array_equal(jax_lab.pack_w3wide_np(codes3)[0], want)
    np.testing.assert_array_equal(packing.pack_w3_wide(torch.from_numpy(codes3)).numpy(), want)


def test_cli_on_the_cpu(monkeypatch, capsys):
    """The entry point runs every variant once on the CPU at a small shape,
    times nothing there, and prints rel where the JAX lab does."""
    calls = []
    make_inputs = kernel_lab2.make_inputs
    monkeypatch.setattr(kernel_lab2, "make_inputs", lambda *a, **kw: calls.append(1) or
                        make_inputs(*a, **kw))
    rows = kernel_lab2.main(["--device", "cpu", "--m", "16", "--n", "256", "--k", "512",
                             "--bn", "128", "--bk", "256", "--variants",
                             ",".join(kernel_lab2.ORDER)])
    out = capsys.readouterr().out
    assert len(calls) == 1
    assert [r["name"] for r in rows] == list(kernel_lab2.ORDER)
    assert "not measured" in out and "rel=" in out
    gemm = [r for r in rows if r["name"] != "vmembw"]
    assert all(r["us"] is None for r in gemm)
    assert max(r["rel"] for r in gemm) < 1.1e-2
    with pytest.raises(SystemExit):
        kernel_lab2.main(["--device", "cpu", "--variants", "nonsense"])


BAD_CALLS = ("m_not_by_bm", "n_not_by_bn", "k_not_by_bk", "bk_not_by_chunk", "x_dtype",
             "table", "sep_plane", "w3_plane", "vmembw_dtype")


@pytest.mark.parametrize("case", BAD_CALLS)
def test_lab2_checks_like_the_grid(inputs, case):
    p = inputs[M][1]
    x, pl4, s = p.x, p.planes, p.scales
    calls = {
        "m_not_by_bm": lambda: ops2.pfdirect(x[:8], pl4, s, p.table, 16, BN, 256, G),
        "n_not_by_bn": lambda: ops2.slabstream(x, pl4, s, p.table, M, 96, 256, G),
        "k_not_by_bk": lambda: ops2.int4(x, pl4, s, M, BN, 384, G, -0.4, 0.05),
        "bk_not_by_chunk": lambda: ops2.w3wide(x, p.planes3, s, p.table3, M, BN, 128, G),
        "x_dtype": lambda: ops2.pfdirect(x.float(), pl4, s, p.table, M, BN, 256, G),
        "table": lambda: ops2.w3wide(x, p.planes3, s, p.table, M, BN, 256, G),
        "sep_plane": lambda: ops2.sep(x, pl4, p.planes_b, s, p.sep_a, p.sep_b, M, BN, 256, G,
                                      False),
        "w3_plane": lambda: ops2.w3wide(x, pl4, s, p.table3, M, BN, 256, G),
        "vmembw_dtype": lambda: ops2.vmembw(torch.zeros(8, 128), 2),
    }
    with pytest.raises(ValueError):
        calls[case]()


@pytest.mark.parametrize("g,path", [(2, "simt"), (16, "mma"), (32, "mma"), (64, "mma"),
                                    (512, "mma")])
@pytest.mark.parametrize("fn", ["pfdirect", "sep", "int4", "slabstream", "w3wide"])
def test_loop_path_and_splits(fn, g, path):
    """pfdirect, sep, int4, slabstream and w3wide are the second lab's
    functions on the tensor-core loop: the path comes from g alone, the
    split from L6's (splits at lcm(256, g), one on the SIMT path), and the C
    entry takes the workspace and the split."""
    assert ops2.MMA_FUNCTIONS == ("pfdirect", "sep", "int4", "slabstream", "w3wide")
    assert ops2.lab_splits is lab.lab_splits
    assert ops2.path_of is lab.path_of
    assert lab.lab_path(g) == path == lab.path_of(fn, g, ops2.MMA_FUNCTIONS)
    entry, argtypes = ops2._ENTRIES[fn]
    assert entry == f"flute_lab2_{fn}"
    assert argtypes.count(ops2._P) == {"sep": 8, "int4": 5}.get(fn, 6)
    assert argtypes[-1] is ops2._I
    splits = ops2.lab_splits(N, 2048, g)
    assert 2048 % (splits * (math.lcm(lab.CHUNK, g) if path == "mma" else 1)) == 0
    assert path == "mma" or splits == 1


# (g, bk) of loop calls refused before any launch, at K 512 (the C entries'
# own refusals are card tests)
LOOP_REFUSALS = {"odd_g": (3, 256), "zero_g": (0, 256), "bk_not_by_g": (512, 256),
                 "k_not_by_bk": (64, 768)}


def loop_call(name, x, codes, scales, bk, g):
    """``sep``/``sep1``, ``int4``, ``slabstream``, ``pfdirect`` or ``w3wide``
    on ``x`` with ``codes`` [K, N] packed by the port (``w3wide``: 3-bit
    codes in the wide layout), the lab's tables and ``scales``, at ``bk``
    and ``g``."""
    c = torch.from_numpy(codes)
    if name == "int4":
        return ops2.int4(x, packing.pack_plane(c, 4), scales, M, BN, bk, g,
                         kernel_lab2.INT4_ZERO, kernel_lab2.INT4_DELTA)
    if name in ("slabstream", "pfdirect"):
        return ops2.FUNCTIONS[name](x, packing.pack_plane(c, 4), scales,
                                    torch.from_numpy(np.array(jnf.nf_values(4))), M, BN, bk, g)
    if name == "w3wide":
        return ops2.w3wide(x, [packing.pack_w3_wide(c)], scales,
                           torch.from_numpy(np.array(jnf.nf_values(3))), M, BN, bk, g)
    return ops2.sep(x, packing.pack_plane(c & 3, 2), packing.pack_plane(c >> 2, 2), scales,
                    torch.from_numpy(kernel_lab2.SEP_A), torch.from_numpy(kernel_lab2.SEP_B),
                    M, BN, bk, g, name == "sep1")


@pytest.mark.parametrize("case", list(LOOP_REFUSALS))
@pytest.mark.parametrize("name", ["sep", "int4", "slabstream", "pfdirect", "w3wide"])
def test_loop_refuses_before_launch(name, case):
    g, bk = LOOP_REFUSALS[case]
    x = torch.zeros(M, 512, dtype=torch.bfloat16)
    codes = np.zeros((512, N), np.int32)
    scales = torch.ones(512 // max(g, 1), N, dtype=torch.bfloat16)
    launches, paths = dict(ops2.LAUNCHES), dict(ops2.LAST_PATH)
    with pytest.raises(ValueError):
        loop_call(name, x, codes, scales, bk, g)
    assert ops2.LAUNCHES == launches and ops2.LAST_PATH == paths


@pytest.mark.parametrize("name", ["sep", "sep1", "int4", "slabstream", "pfdirect", "w3wide"])
def test_cpu_calls_run_the_plain_version(inputs, name):
    """On the CPU a wrapper runs its plain version: no launch is counted and
    no path is recorded."""
    p = inputs[M][1]
    launches, paths = dict(ops2.LAUNCHES), dict(ops2.LAST_PATH)
    fn, args = kernel_lab2.lab_call(name, p, kernel_lab2.operands(name, p), M, BN, 256)
    assert torch.equal(ops2.FUNCTIONS[fn](*args), ops2.plain(fn, *args))
    assert ops2.LAUNCHES == launches and ops2.LAST_PATH == paths


@pytest.mark.parametrize("name,g", [("int4", 16), ("int4", 32), ("int4", 512), ("sep", 32),
                                    ("sep", 512), ("sep1", 32), ("sep1", 512),
                                    ("slabstream", 32), ("slabstream", 512), ("pfdirect", 16),
                                    ("pfdirect", 32), ("pfdirect", 512), ("w3wide", 16),
                                    ("w3wide", 32), ("w3wide", 512)])
def test_loop_other_group_sizes_vs_jax(jax_lab, interpret, wrap, name, g):
    """The loop's plain versions against the JAX lab at its other group
    sizes: one k16 step a group (16), two groups a field of a 4-bit plane
    (32; one field of a 2-bit plane spans 32 K rows, one of the wide 3-bit
    layout 16), a group wider than a chunk (512). sep's, slabstream's,
    pfdirect's and w3wide's raw fields index their gathers: the v5e's wrap
    is modelled."""
    rng = np.random.default_rng(g)
    codes = rng.integers(0, 8 if name == "w3wide" else 16, size=(K, N), dtype=np.int32)
    scales = rng.uniform(0.5, 1.5, (K // g, N)).astype(np.float32)
    x = rng.standard_normal((M, K)).astype(np.float32)
    pack = functools.partial(jpacking.pack_np, use_native=False)
    bk = max(256, g)
    jx, js = jnp.asarray(x, jnp.bfloat16), jnp.asarray(scales, jnp.bfloat16)
    if name == "int4":
        want = jax_lab.run_int4(jx, [jnp.asarray(q) for q in pack(codes, 4)], js, M, BN, bk, g,
                                kernel_lab2.INT4_ZERO, kernel_lab2.INT4_DELTA)
    elif name in ("slabstream", "pfdirect"):
        run = jax_lab.run_slabstream if name == "slabstream" else jax_lab.run_pfdirect
        want = run(jx, [jnp.asarray(q) for q in pack(codes, 4)], js, jnf.nf_values(4), M, BN,
                   bk, g)
    elif name == "w3wide":
        want = jax_lab.run_w3wide(jx, [jnp.asarray(q) for q in jax_lab.pack_w3wide_np(codes)],
                                  js, jnf.nf_values(3), M, BN, bk, g)
    else:
        want = jax_lab.run_sep(jx, [jnp.asarray(q) for q in pack(codes & 3, 2)],
                               [jnp.asarray(q) for q in pack(codes >> 2, 2)], js,
                               jnp.asarray(kernel_lab2.SEP_A), jnp.asarray(kernel_lab2.SEP_B),
                               M, BN, bk, g, name == "sep1")
    want = np.asarray(want, np.float32)
    got = loop_call(name, torch.from_numpy(x).bfloat16(), codes,
                    torch.from_numpy(scales).bfloat16(), bk, g).float().numpy()
    assert np.isfinite(want).all()
    assert rel_err(got, want) < 1.1e-2
