"""The port's GEMM shape registry is the JAX package's: the same shapes in
the same order, for every model and TP selection."""

import dataclasses

import pytest

from flute_tpu import shapes as jshapes
from flute_tpu_torch import shapes


@pytest.mark.parametrize("models,tps", [(None, None), (["llama3-70b"], [2, 4]),
                                        (["gemma2-9b", "llama3-8b"], None), (None, [8])])
def test_shapes_match(models, tps):
    got = [dataclasses.astuple(s) for s in shapes.iter_shapes(models, tps)]
    want = [dataclasses.astuple(s) for s in jshapes.iter_shapes(models, tps)]
    assert got == want and got
    assert shapes.unique_nk(models, tps) == jshapes.unique_nk(models, tps)
    assert shapes.MODELS == jshapes.MODELS and shapes.MODEL_TP == jshapes.MODEL_TP
