"""Every public function, class and method of the JAX package takes the same
call forms in the port (queue 3 items 51 and 52).

The walk pairs each public top-level function and class that a module of
``flute_tpu`` defines (found by its file, as ``tests/test_torch_exports.py``
finds them, the JAX- or TPU-only names of its ``JAX_ONLY`` left out) with the
port's counterpart, and each class's public methods (the functions in its
body) and its constructor with the port's. For each pair:

  (a) every JAX parameter is in the port's signature;
  (b) JAX's positional parameters are the port's first positional
      parameters, in the same order;
  (c) where JAX's default is a plain value (None, bool, int, float, str or a
      tuple of these) the port's default is equal; a ``jnp`` dtype default
      maps to the ``torch`` dtype of the same name.

The intended differences are :data:`EXCEPTIONS`, each with its queue 3 item:
``"name(param)"`` excuses one parameter of a pair, ``"name"`` a pair whose
port counterpart is not a function. Each entry must still differ.
"""

import importlib
import inspect

import numpy as np
import pytest
import torch

from test_torch_exports import JAX_ONLY, MODULES

ITEM_10 = "the port's sampling draws from a torch.Generator (generator=), not a jax.Array key"
ITEM_37 = "the port's mesh: ranks= for devices=, the tp group as group= for axis_name="
EXCEPTIONS = {
    "serving.engine.sample_logits(rng)": (10, ITEM_10),
    "serving.engine.Engine.generate(rng)": (10, ITEM_10),
    "ops.lut_gemm.lut_qgemm(interpret)": (53, "Pallas's interpreter: the port has no such mode"),
    "parallel.tp.make_mesh(devices)": (37, ITEM_37),
    "models.llama.forward(axis_name)": (37, ITEM_37),
    "models.gemma2.forward(axis_name)": (37, ITEM_37),
    "serving.engine.Engine.forward(axis_name)": (37, ITEM_37),
    **{f"serving.{mod}.{cls}.{fn}": (
        53, "None: the config's model family's function (Llama's or Gemma-2's); JAX's is Llama's")
       for mod, cls in (("continuous", "ContinuousBatchingEngine"),
                        ("speculative", "SpeculativeEngine"))
       for fn in ("forward", "init_cache")},
    **{f"tune.{fn}(dtype)": (
        53, "None: the layer's scales dtype, the one it serves in; JAX's is bf16")
       for fn in ("tune_linear", "metadata_for", "maybe_retune")},
}
POSITIONAL = (inspect.Parameter.POSITIONAL_ONLY, inspect.Parameter.POSITIONAL_OR_KEYWORD)
VARIADIC = (inspect.Parameter.VAR_POSITIONAL, inspect.Parameter.VAR_KEYWORD)


def public_pairs() -> dict:
    """qualified name (module without ``flute_tpu.``, then the name) ->
    (JAX object, port object or None)."""
    pairs = {}
    for name in MODULES:
        jax_mod = importlib.import_module(name)
        port = importlib.import_module("flute_tpu_torch" + name.removeprefix("flute_tpu"))
        prefix = name.removeprefix("flute_tpu").lstrip(".")
        for n, v in vars(jax_mod).items():
            if (n.startswith("_") or n in JAX_ONLY.get(name, ())
                    or not (inspect.isfunction(v) or inspect.isclass(v))
                    or v.__module__ != name):
                continue
            qn = f"{prefix}.{n}" if prefix else n
            mine = getattr(port, n)
            pairs[qn] = (v, mine)
            if not inspect.isclass(v):
                continue
            for m, f in vars(v).items():
                if isinstance(f, (staticmethod, classmethod)):
                    f = f.__func__
                if not m.startswith("_") and inspect.isfunction(f):
                    g = inspect.getattr_static(mine, m, None)
                    if isinstance(g, (staticmethod, classmethod)):
                        g = g.__func__
                    pairs[f"{qn}.{m}"] = (f, g)
    return pairs


PAIRS = public_pairs()


def plain(value) -> bool:
    if value is None or isinstance(value, (bool, int, float, str)):
        return True
    return isinstance(value, tuple) and all(plain(v) for v in value)


def port_default(value):
    """What the port's default for JAX's ``value`` must equal, or ``...``
    where it is not compared."""
    if plain(value):
        return value
    try:
        dtype = np.dtype(value)
    except TypeError:
        return ...
    return getattr(torch, dtype.name)


def differences(qn: str, excused=frozenset()) -> list:
    """The ways the port's counterpart of ``qn`` breaks (a), (b) or (c),
    leaving out the parameters in ``excused``."""
    jax_obj, port_obj = PAIRS[qn]
    if not callable(port_obj):
        return [f"the port's {qn} is {port_obj!r}"]
    jsig, psig = inspect.signature(jax_obj), inspect.signature(port_obj)
    jparams = {n: p for n, p in jsig.parameters.items()
               if n not in excused and p.kind not in VARIADIC}
    out = [f"missing {n}" for n in jparams if n not in psig.parameters]
    jpos = [n for n, p in jparams.items() if p.kind in POSITIONAL]
    ppos = [n for n, p in psig.parameters.items() if p.kind in POSITIONAL]
    if ppos[:len(jpos)] != jpos:
        out.append(f"positional {jpos}, the port's {ppos}")
    for n, p in jparams.items():
        if p.default is inspect.Parameter.empty or n not in psig.parameters:
            continue
        want, got = port_default(p.default), psig.parameters[n].default
        if want is not ... and (got != want or isinstance(got, bool) != isinstance(want, bool)):
            out.append(f"default {n}={got!r}, JAX's {p.default!r}")
    return out


def excused_params(qn: str) -> frozenset:
    return frozenset(k[len(qn) + 1:-1] for k in EXCEPTIONS if k.startswith(qn + "("))


def test_walk_covers_the_package():
    assert len(PAIRS) >= 200
    for qn in ("nn.QuantizedLinear", "quantize.learnable.LearnableQuantizedLinear",
               "serving.engine.Engine", "serving.paged_spec.PagedSpeculativeEngine",
               "models.llama.init_params", "models.gemma2.init_params",
               "utils.benchmark.bench_op", "serving.engine.Engine.generate"):
        assert qn in PAIRS


@pytest.mark.parametrize("qn", [qn for qn in PAIRS if qn not in EXCEPTIONS])
def test_port_takes_the_jax_call_form(qn):
    assert differences(qn, excused_params(qn)) == []


@pytest.mark.parametrize("entry", list(EXCEPTIONS))
def test_each_exception_still_differs(entry):
    """An entry names a pair of the walk and a difference that is still
    there: without the excuse, the pair fails on that parameter."""
    item, reason = EXCEPTIONS[entry]
    assert isinstance(item, int) and reason
    qn, _, param = entry.partition("(")
    assert qn in PAIRS
    if not param:
        assert differences(qn) != []
        return
    param = param.removesuffix(")")
    assert param in inspect.signature(PAIRS[qn][0]).parameters
    rest = excused_params(qn) - {param}
    assert any(param in d for d in differences(qn, rest)), differences(qn, rest)
    assert differences(qn, rest | {param}) == []
