"""The check that decides ``correct``, driven through the rest of a run at
toy sizes on the CPU (no look for a chip), with the timed path broken
underneath: each fault a served cell can have turns ``correct`` false; the
sound run stays true.

Faults of other kinds of cell have no place here: a served model has no
mean over a batch, and one chip no exchange between chips."""

import pytest

import tiny
from harness.manifest import Manifest
from harness.runner import run_cell

SEED = 2**31 + 1001


@pytest.fixture(scope="module")
def manifest(tmp_path_factory):
    root = tiny.make_root(tmp_path_factory.mktemp("bench"), tiny.real_manifest())
    return Manifest(root, root / "perfbench")


def altered_token(monkeypatch):
    """A token altered where it is produced: every decode step's tokens
    shifted by one."""
    from flute_tpu_torch.serving import continuous

    real = continuous.sample_step

    def shifted(*a, **kw):
        nxt, lp = real(*a, **kw)
        return (nxt + 1) % tiny.TINY_MODEL["vocab_size"], lp

    monkeypatch.setattr(continuous, "sample_step", shifted)


def state_unchanged(monkeypatch):
    """A step that returns its state unchanged: every decode step hands on
    the logits of the engine's first decode step."""
    from flute_tpu_torch.serving import continuous

    real = continuous.ContinuousBatchingEngine._step_logits
    first = {}

    def stale(self):
        out = real(self)
        return first.setdefault(id(self), out.clone())

    monkeypatch.setattr(continuous.ContinuousBatchingEngine, "_step_logits", stale)


def run(manifest, cell="tiny-w4sym.chat"):
    return run_cell(manifest, cell, SEED, 3.0, False, device="cpu", t_start=0.0,
                    log=lambda s: None)


@pytest.mark.parametrize("cell", ["tiny-w4sym.chat", "tiny-w4sym.batch"])
def test_sound_run_is_correct(manifest, cell):
    result, checks = run(manifest, cell)
    assert result["correct"], checks
    assert checks["max_logit_gap"][0] < tiny.TINY_LIMIT


@pytest.mark.parametrize("fault", [altered_token, state_unchanged])
def test_fault_is_caught(manifest, monkeypatch, fault):
    fault(monkeypatch)
    result, checks = run(manifest)
    assert not result["correct"], checks
    assert checks["max_logit_gap"][0] > tiny.TINY_LIMIT
