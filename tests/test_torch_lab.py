"""The port's kernel lab (``flute_tpu_torch.lab``) against the JAX lab
(``scripts/kernel_lab.py``).

The same numpy inputs (``make_inputs``, seed 0) go through the JAX lab's
``run_*`` functions, with ``pl.pallas_call`` in interpret mode, and through
the port's plain versions on the CPU, at M16 N256 K512 g64, bk 256 and,
where bk changes the result (``floor`` and the ``"repeat"`` scale modes),
bk 512 too. Tolerance: relative Frobenius error under 1.1e-2 (bf16).

* ``floor`` reads plane words as bf16 bit patterns, so real planes give
  non-finite outputs: both labs get the planes masked by ``0xBFFFBFFF``
  (``lab.finite_halves``: every half a finite bf16 below 2 in magnitude).
* ``unpack`` uses the codes as bf16 subnormals, which XLA on the CPU flushes
  in the product: its operand is compared bit for bit with one built from
  JAX's ``_unpack_pair_fields``, and its product with a float64 oracle.
* ``g8_wrap`` and ``g8_bare`` wrap the index mod 8 on the v5e, which the
  interpreter does not (it clamps): they are held to the interpret run with
  the mask (``wrap=False``) and to a numpy oracle on ``T[c & 7]``, and a
  separate test pins the interpreter's clamp.

The host side of the tensor-core loop of L1 and L3-L6 (``lab.path_of``,
``lab.lab_splits``: the path from the function and g, splits of K at
``lcm(256, g)``, floor's at the chunk, the refusals) is checked here, and
their plain versions against the JAX lab at the loop's other group sizes.
The kernels against these plain versions on the card are in
``test_torch_cuda.py``.
"""

import functools
import importlib.util
import math
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from flute_tpu.ops import lut_gemm as jlut
from flute_tpu_torch.lab import kernel_lab, ops as lab
from flute_tpu_torch.ops.kernel_config import MMA_TARGET_BLOCKS

ROOT = Path(__file__).resolve().parent.parent
M, N, K, G, BN = 16, 256, 512, 64, 128
# the twelve cases of L1-L6: lab variant -> the block sizes that are run
CASES = {name: ((256, 512) if name in ("floor", "g8_repeat", "g8_hoist") else (256,))
         for name in kernel_lab.VARIANTS}


def rel_err(y, y_ref):
    y = np.asarray(y, dtype=np.float64)
    y_ref = np.asarray(y_ref, dtype=np.float64)
    return np.linalg.norm(y - y_ref) / np.linalg.norm(y_ref)


def bf16(a):
    return np.asarray(jnp.asarray(np.asarray(a, np.float32)).astype(jnp.bfloat16), np.float32)


@pytest.fixture(scope="module")
def jax_lab():
    """``scripts/kernel_lab.py`` loaded as a module, with its inputs."""
    spec = importlib.util.spec_from_file_location("jax_kernel_lab",
                                                  ROOT / "scripts" / "kernel_lab.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod, mod.make_inputs(M, N, K, 4, G)


@pytest.fixture
def interpret(monkeypatch):
    """Every ``pl.pallas_call`` in interpret mode, as the JAX tests run them
    on the CPU."""
    monkeypatch.setattr(pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True))


@pytest.fixture(scope="module")
def port_inputs():
    return kernel_lab.make_inputs(M, N, K, 4, G, device="cpu")


def run_jax(jax_lab, name, bk, planes=None, **over):
    """The JAX lab's function of variant ``name`` (flags overridden by
    ``over``) at block size ``bk``."""
    mod, (_, jplanes, scales, table, x) = jax_lab
    fn, flags = kernel_lab.VARIANTS[name]
    flags = {**flags, **over}
    planes = jplanes if planes is None else planes
    run = {"floor": mod.run_floor, "unpack_only": mod.run_unpack}.get(fn)
    if run is not None:
        return np.asarray(run(x, planes, scales, M, BN, bk, G), np.float32)
    run = {"gather16": mod.run_gather16, "g8_ablate": mod.run_g8_ablate,
           "g8_rs": mod.run_g8_rs, "g8_hoist": mod.run_g8_hoist}[fn]
    if "scale_mode" in flags:
        return np.asarray(run(x, planes, scales, table, M, BN, bk, G, flags["scale_mode"]),
                          np.float32)
    return np.asarray(run(x, planes, scales, table, M, BN, bk, G, **flags), np.float32)


def run_port(name, bk, inputs, planes=None):
    _, tplanes, scales, table, x = inputs
    y = kernel_lab.run_variant(name, x, tplanes if planes is None else planes, scales, table,
                               M, BN, bk, G)
    assert y.dtype == torch.bfloat16 and tuple(y.shape) == (M, N)
    return y.float().numpy()


def test_make_inputs_match_jax(jax_lab, port_inputs):
    _, (codes, planes, scales, table, x) = jax_lab
    tcodes, tplanes, tscales, ttable, tx = port_inputs
    np.testing.assert_array_equal(tcodes, codes)
    for tp, p in zip(tplanes, planes, strict=True):
        np.testing.assert_array_equal(tp.numpy(), np.asarray(p))
    np.testing.assert_array_equal(ttable.numpy(), np.asarray(table))
    for t, j in ((tscales, scales), (tx, x)):
        assert t.dtype == torch.bfloat16
        np.testing.assert_array_equal(t.view(torch.int16).numpy(),
                                      np.asarray(j).view(np.int16))


@pytest.mark.parametrize("name,bk", [(c, bk) for c, bks in CASES.items() for bk in bks])
def test_lab_case_vs_jax(jax_lab, port_inputs, interpret, name, bk):
    if name == "unpack":
        check_unpack(jax_lab, port_inputs, bk)
        return
    plane = lab.finite_halves(port_inputs[1][0]).numpy() if name == "floor" else None
    over = dict(wrap=False) if name in ("g8_wrap", "g8_bare") else {}
    want = run_jax(jax_lab, name, bk, planes=None if plane is None else [jnp.asarray(plane)],
                   **over)
    got = run_port(name, bk, port_inputs,
                   planes=None if plane is None else [torch.from_numpy(plane)])
    assert np.isfinite(want).all() and np.isfinite(got).all()
    assert rel_err(got, want) < 1.1e-2
    if name in ("g8_wrap", "g8_bare"):
        codes, _, scales, table, x = port_inputs
        w = bf16(table.numpy()[codes & 7])
        if name == "g8_wrap":
            w = bf16(w * np.repeat(scales.float().numpy(), G, axis=0))
        oracle = bf16(x.float().numpy().astype(np.float64) @ w)
        assert rel_err(got, oracle) < 1.1e-2


def check_unpack(jax_lab, port_inputs, bk):
    """L2: the port's bf16 operand is JAX's payload ``ce | co << 16`` bitcast
    (int32 row i -> bf16 rows 2i, 2i+1), bit for bit, and its product agrees
    with x @ (codes as bf16 subnormals) in float64. The JAX run is finite
    (XLA on the CPU flushes the subnormal products)."""
    _, (codes, planes, _, _, _) = jax_lab
    ce, co = jlut._unpack_pair_fields([planes[0]], (4,), K, 256)
    payload = np.asarray(ce | (co << 16)).astype(np.uint32)
    want = np.stack([payload & 0xFFFF, payload >> 16], axis=1).reshape(K, N)
    _, tplanes, scales, table, x = port_inputs
    w = lab.unpack_weight(tplanes[0])
    np.testing.assert_array_equal(w.view(torch.int16).numpy().view(np.uint16), want)
    np.testing.assert_array_equal(want, codes)  # the payload is the codes
    assert np.isfinite(run_jax(jax_lab, "unpack", bk)).all()
    got = run_port("unpack", bk, port_inputs)
    exact = x.double().numpy() @ (codes.astype(np.float64) * 2.0**-133)
    assert np.abs(got).max() > 0
    assert rel_err(got, exact) < 1.1e-2


def test_interpret_mode_clamps_the_wrapped_index(jax_lab, port_inputs, interpret):
    """The Pallas interpreter does not wrap a gather index mod 8 as the v5e
    does: g8_wrap's interpret run equals the product with T[min(c, 7)] and
    differs from g8_nochain (ROADMAP queue 3)."""
    wrap = run_jax(jax_lab, "g8_wrap", 256)
    nochain = run_jax(jax_lab, "g8_nochain", 256)
    codes, _, scales, table, x = port_inputs
    w = bf16(bf16(table.numpy()[np.minimum(codes, 7)]) * np.repeat(scales.float().numpy(), G, 0))
    clamp = bf16(x.float().numpy().astype(np.float64) @ w)
    assert rel_err(wrap, clamp) < 1.1e-2
    assert np.abs(wrap - nochain).max() > 0.1 * np.abs(nochain).max()


@pytest.mark.parametrize("name", ["floor", "g8_repeat", "g8_hoist"])
def test_block_size_changes_the_result(port_inputs, name):
    """floor and the "repeat" modes tile per K block: bk 256 and bk 512
    differ, as they do on the TPU."""
    planes = [lab.finite_halves(port_inputs[1][0])] if name == "floor" else None
    a = run_port(name, 256, port_inputs, planes)
    b = run_port(name, 512, port_inputs, planes)
    assert rel_err(a, b) > 0.05


def test_cli_on_the_cpu(capsys):
    """The lab's entry point runs every variant on the CPU at a small shape,
    times nothing there, and prints rel where the JAX lab does."""
    rows = kernel_lab.main(["--device", "cpu", "--m", "16", "--n", "256", "--k", "512",
                            "--bn", "128", "--bk", "256", "--variants",
                            ",".join(kernel_lab.ORDER)])
    out = capsys.readouterr().out
    assert [r["name"] for r in rows] == list(kernel_lab.ORDER)
    assert all(r["us"] is None for r in rows) and "not measured" in out
    rel = {r["name"]: r["rel"] for r in rows if "rel" in r}
    assert set(rel) == set(kernel_lab.REL_PRINTED)
    for name in ("gather8", "gather16", "g8_groupacc", "g8_hoist_ga"):
        assert rel[name] < 1.1e-2
    assert rel["g8_repeat"] == rel["g8_hoist"] > 0.1  # the tiled scales
    with pytest.raises(SystemExit):
        kernel_lab.main(["--device", "cpu", "--variants", "nonsense"])


BAD_CALLS = ("m_not_by_bm", "n_not_by_bn", "k_not_by_bk", "bk_not_by_chunk", "scale_mode",
             "x_dtype", "table", "planes")


@pytest.mark.parametrize("case", BAD_CALLS)
def test_lab_checks_like_the_grid(port_inputs, case):
    _, planes, scales, table, x = port_inputs
    calls = {
        "m_not_by_bm": lambda: lab.floor(x[:8], planes, scales, 16, BN, 256, G),
        "n_not_by_bn": lambda: lab.gather16(x, planes, scales, table, M, 96, 256, G),
        "k_not_by_bk": lambda: lab.g8_rs(x, planes, scales, table, M, BN, 384, G, "repeat"),
        "bk_not_by_chunk": lambda: lab.unpack_only(x, planes, scales, M, BN, 128, G),
        "scale_mode": lambda: lab.g8_hoist(x, planes, scales, table, M, BN, 256, G, "tiled"),
        "x_dtype": lambda: lab.g8_ablate(x.float(), planes, scales, table, M, BN, 256, G,
                                         chain=True, scale=True, wrap=False),
        "table": lambda: lab.gather16(x, planes, scales, table[:8], M, BN, 256, G),
        "planes": lambda: lab.floor(x, planes * 2, scales, M, BN, 256, G),
    }
    with pytest.raises(ValueError):
        calls[case]()


# ---------------------------------------------------------------------------
# L1's and L3-L6's tensor-core loop: the host-side plan (the kernels are in
# test_torch_cuda.py)
# ---------------------------------------------------------------------------

# the lab variants on the loop (floor and unpack at every g, the others
# where 16 divides g): L1, L2, L4's four distinct flag sets (g8_wrap's flags
# select g8_nochain's entries), L6's and L5's two modes each, and L3
LOOP_VARIANTS = ("g8_full", "g8_nochain", "g8_noscale", "g8_bare", "g8_hoist", "g8_hoist_ga",
                 "g8_repeat", "g8_groupacc", "gather16", "floor", "unpack")
# those whose plain versions compare with the JAX lab's at other group
# sizes: XLA on the CPU flushes unpack's subnormal products (check_unpack
# holds it to JAX's operand instead), and its function takes no g
JAX_LOOP_VARIANTS = tuple(v for v in LOOP_VARIANTS if v != "unpack")


@pytest.mark.parametrize("g,path", [(2, "simt"), (6, "simt"), (16, "mma"), (32, "mma"),
                                    (64, "mma"), (512, "mma")])
@pytest.mark.parametrize("fn", ["gather16", "g8_ablate", "g8_rs", "g8_hoist", "floor",
                                "unpack_only"])
def test_lab_path_from_g(fn, g, path):
    """The loop takes a g that is a multiple of 16 (a k16 step inside one
    group); g = 2 goes to the SIMT kernel, with one split, chosen before any
    launch. floor and unpack_only read no scales: the loop takes them at
    every g. Each function on the loop passes the C entry its workspace and
    split (one more pointer and one more int than its SIMT arguments; floor
    and unpack_only take no g)."""
    want = "mma" if fn in lab.UNSCALED else path
    assert fn in lab.MMA_FUNCTIONS and lab.lab_path(g) == path and lab.path_of(fn, g) == want
    entry, n_ptr, n_int = lab._ENTRIES[fn]
    # x plane [scales table] y work; M N K bk [g, flags], splits
    assert entry == f"flute_lab_{fn}" and n_ptr == (4 if fn in lab.UNSCALED else 6)
    assert n_int == {"gather16": 6, "g8_ablate": 8, "g8_rs": 7, "g8_hoist": 7, "floor": 5,
                     "unpack_only": 5}[fn]
    if want == "simt":
        assert lab.lab_splits(256, 1536, g) == 1


@pytest.mark.parametrize("n,k", [(200, 1024), (2048, 8192), (28672, 8192), (256, 512)])
@pytest.mark.parametrize("g", [16, 32, 64, 512])
def test_lab_splits_at_lcm(n, k, g):
    """K splits only at multiples of lcm(256, g): a group never straddles two
    splits. The split is the fewest that gives the target blocks at one m16
    row, or every unit its own; above one split the loop gets an f32
    workspace [splits, M, N]."""
    splits = lab.lab_splits(n, k, g)
    unit = math.lcm(lab.CHUNK, g)
    assert k % (splits * unit) == 0
    units, cols = k // unit, -(-n // lab.MMA_BLOCK_N)
    assert cols * splits >= MMA_TARGET_BLOCKS or splits == units
    assert all(cols * s < MMA_TARGET_BLOCKS for s in range(1, splits) if units % s == 0)
    x = torch.zeros(40, k, dtype=torch.bfloat16)
    got, ws = lab.loop_operands(x, lab.lab_path(g), splits, n)
    assert got is x
    if splits == 1:
        assert ws is None
    else:
        assert ws.dtype == torch.float32 and tuple(ws.shape) == (splits, 40, n)


def test_lab_splits_at_the_lab_shape():
    """M16 N28672 K8192 g64: two splits, 448 blocks (one wave at four blocks
    an SM); g = 2 runs the SIMT kernel with one split."""
    assert lab.lab_splits(28672, 8192, 64) == 2
    assert lab.lab_splits(28672, 8192, 2) == 1


@pytest.mark.parametrize("n,k", [(28672, 8192), (200, 1024), (200, 3584), (2048, 4096)])
@pytest.mark.parametrize("g", [2, 6, 64, 512])
@pytest.mark.parametrize("fn", ["floor", "unpack_only"])
def test_floor_splits_at_chunks(fn, n, k, g):
    """floor and unpack_only run the loop at every g and plan their split
    from the chunk (``lab_splits`` with the chunk for g): two splits at the
    lab's shape (as the loop's other functions at g64), every split boundary
    a chunk boundary, so no split falls inside a chunk, and more than one
    split where K and N allow, even where g is 2 (one split for the
    functions that read scales) or wider than a chunk."""
    assert lab.path_of(fn, g) == "mma"
    splits = lab.launch_splits(fn, n, k, g)
    assert splits == lab.lab_splits(n, k, lab.CHUNK)
    assert k % (splits * lab.CHUNK) == 0 and splits > 1
    assert lab.lab_path(g) == "mma" or lab.lab_splits(n, k, g) == 1
    if (n, k) == (28672, 8192):
        assert splits == 2


def test_mma_probe_plain_version():
    """The probe's plain version on the CPU (the reference the card's
    ``mma.sync`` is held to): the identity gives back B's bf16 subnormals
    exactly, 2^-100 times values near 2^-40 gives f32 subnormals, rows of
    powers of two against subnormal columns give exact sums of 16 subnormal
    products, and operands of another shape, type or device are refused."""
    (eye, b), (tiny, small), _ = lab.probe_operands()
    d = lab.mma_probe(eye, b)
    assert d.dtype == torch.float32 and torch.equal(d, b.float())
    assert int((d.abs() < 2.0**-126).sum()) == 3 * len(lab.PROBE_SUBNORMALS)
    d = lab.mma_probe(tiny, small)
    assert bool(((d != 0) & (d.abs() < 2.0**-126)).all())
    # every output a sum of 16 subnormal products, exact in f32; most of the
    # sums subnormal too, some normal, some negative
    rows, sub = lab.probe_operands()[2]
    assert bool((sub.float().abs() < 2.0**-126).all())
    assert set(sub[:, :4].view(torch.int16).unique().tolist()) <= set(range(16))
    d = lab.mma_probe(rows, sub)
    assert torch.equal(d.double(), rows.double() @ sub.double())
    tiny_sums = (d != 0) & (d.abs() < 2.0**-126)
    assert 0.5 < float(tiny_sums.float().mean()) < 1 and bool((d < 0).any())
    with pytest.raises(ValueError):
        lab.mma_probe(eye.float(), b)
    with pytest.raises(ValueError):
        lab.mma_probe(eye[:8], b)


# (g, bk) of loop calls refused before any launch, at K 512 (the checks make
# K a multiple of lcm(256, g), which is all the loop's split needs; the C
# entries' own refusals are card tests)
LOOP_REFUSALS = {"odd_g": (3, 256), "zero_g": (0, 256), "bk_not_by_g": (512, 256),
                 "k_not_by_bk": (64, 768)}


@pytest.mark.parametrize("case", list(LOOP_REFUSALS))
@pytest.mark.parametrize("variant", ["g8_hoist_ga", "g8_full", "g8_bare", "g8_groupacc",
                                     "g8_repeat", "gather16", "floor", "unpack"])
def test_loop_refuses_before_launch(port_inputs, variant, case):
    _, planes, _, table, x = port_inputs
    g, bk = LOOP_REFUSALS[case]
    scales = torch.ones(K // max(g, 1), N, dtype=torch.bfloat16)
    launches, paths = dict(lab.LAUNCHES), dict(lab.LAST_PATH)
    with pytest.raises(ValueError):
        kernel_lab.run_variant(variant, x, planes, scales, table, M, BN, bk, g)
    assert lab.LAUNCHES == launches and lab.LAST_PATH == paths


@pytest.mark.parametrize("variant", LOOP_VARIANTS)
def test_cpu_calls_run_the_plain_version(port_inputs, variant):
    """On the CPU a wrapper runs its plain version: no launch is counted and
    no path is recorded (floor on planes masked to finite halves, so that
    its outputs compare)."""
    _, planes, scales, table, x = port_inputs
    fn, flags = kernel_lab.VARIANTS[variant]
    if fn == "floor":
        planes = [lab.finite_halves(planes[0])]
    launches, paths = dict(lab.LAUNCHES), dict(lab.LAST_PATH)
    y = lab.run(fn, x, planes, scales, table, M, BN, 256, G, **flags)
    assert torch.equal(y, lab.plain(fn, x, planes, scales, table, M, BN, 256, G, **flags))
    assert lab.LAUNCHES == launches and lab.LAST_PATH == paths


@pytest.mark.parametrize("g,bk", [(32, 256), (512, 512)])
@pytest.mark.parametrize("variant", JAX_LOOP_VARIANTS)
def test_loop_other_group_sizes_vs_jax(jax_lab, interpret, variant, g, bk):
    """The loop's plain versions against the JAX lab at its other group
    sizes: a group within a field (32) and one wider than a chunk (512).
    g8_bare wraps its index on the v5e, which the interpreter clamps: the
    JAX run takes the mask (wrap=False), the same entries. floor takes no
    g but bk, and both labs get its planes masked to finite halves."""
    mod = jax_lab[0]
    _, jplanes, jscales, jtable, jx = mod.make_inputs(M, N, K, 4, g)
    _, planes, scales, table, x = kernel_lab.make_inputs(M, N, K, 4, g, device="cpu")
    fn, flags = kernel_lab.VARIANTS[variant]
    if fn == "floor":
        planes = [lab.finite_halves(planes[0])]
        jplanes = [jnp.asarray(planes[0].numpy())]
    run = {"gather16": mod.run_gather16, "g8_ablate": mod.run_g8_ablate,
           "g8_rs": mod.run_g8_rs, "g8_hoist": mod.run_g8_hoist, "floor": mod.run_floor}[fn]
    if fn in ("g8_rs", "g8_hoist"):
        want = run(jx, jplanes, jscales, jtable, M, BN, bk, g, flags["scale_mode"])
    elif fn == "gather16":
        want = run(jx, jplanes, jscales, jtable, M, BN, bk, g)
    elif fn == "floor":
        want = run(jx, jplanes, jscales, M, BN, bk, g)
    else:
        want = run(jx, jplanes, jscales, jtable, M, BN, bk, g, **{**flags, "wrap": False})
    want = np.asarray(want, np.float32)
    got = kernel_lab.run_variant(variant, x, planes, scales, table, M, BN, bk, g)
    assert np.isfinite(want).all()
    assert rel_err(got.float().numpy(), want) < 1.1e-2

