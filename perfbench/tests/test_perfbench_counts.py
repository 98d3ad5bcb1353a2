"""The yardstick's counts of K1 (w4sym) and K4 (HIGGS) calls at the
configurations' shapes, and the engines' prefill calls, against hand
counts."""

import pytest

import tiny  # noqa: F401
from harness import counts
from harness.manifest import Manifest


@pytest.fixture(scope="module")
def models():
    m = Manifest()
    return {c["name"]: m.config(c["name"]) for c in m.data["configs"]}


def test_projection_shapes(models):
    mistral = counts.projections(models["mistral-7b-v0.3.w4sym"])
    assert mistral == {"qkv": (4096, 6144), "o": (4096, 4096), "gate_up": (4096, 28672),
                       "down": (14336, 4096)}
    nemo = counts.projections(models["mistral-nemo-12b.higgs-w4"])
    assert nemo == {"qkv": (5120, 6144), "o": (4096, 5120), "gate_up": (5120, 28672),
                    "down": (14336, 5120)}


@pytest.mark.parametrize("m,n,k,fmt", [
    (16, 6144, 4096, "w4sym"), (512, 28672, 4096, "w4sym"), (16, 5120, 4096, "higgs"),
    (256, 5120, 14336, "higgs"), (1, 131072 // 64, 5120, "higgs")])
def test_lut_call_bytes_and_flops(m, n, k, fmt):
    table = 64 if fmt == "w4sym" else 2048
    want = k * n // 2 + (k // 64) * n * 2 + table + 2 * m * k + 2 * m * n
    assert counts.lut_bytes(m, n, k, fmt, 64) == want
    assert counts.lut_flops(m, n, k) == 2 * m * n * k
    least = counts.lut_least_s(m, n, k, fmt, 64)
    assert least == max(2 * m * n * k / 989e12, want / 3.35e12)


def test_decode_is_bytes_bound_and_prefill_operations_bound():
    # Mistral-7B's gate_up: at 16 rows the bytes bound, at 512 the operations
    assert counts.lut_least_s(16, 28672, 4096, "w4sym", 64) == pytest.approx(
        counts.lut_bytes(16, 28672, 4096, "w4sym", 64) / 3.35e12)
    assert counts.lut_least_s(512, 28672, 4096, "w4sym", 64) == pytest.approx(
        2 * 512 * 28672 * 4096 / 989e12)


def test_prefill_rows_follow_the_engines():
    from flute_tpu_torch.serving.continuous import _bucket

    cont = {"kind": "continuous", "prefill_chunk": None}
    for plen in (1, 16, 17, 255, 256, 257, 1536):
        assert counts.prefill_rows(cont, plen) == [_bucket(plen)]
    chunked = {"kind": "continuous", "prefill_chunk": 512}
    assert counts.prefill_rows(chunked, 1536) == [512, 512, 512]
    assert counts.prefill_rows(chunked, 1600) == [512, 512, 512, 64]
    assert counts.prefill_rows(chunked, 1700) == [512, 512, 512, 256]
    assert counts.prefill_rows(chunked, 300) == [512]
    paged = {"kind": "paged", "prefill_chunk": None, "block_size": 16}
    assert counts.prefill_rows(paged, 600) == [256, 256, 128]
    assert counts.prefill_rows(paged, 5) == [16]
    assert counts.prefill_rows(paged, 33) == [64]


def test_prefill_chunks_count_real_and_launched_rows():
    chunked = {"kind": "continuous", "prefill_chunk": 512}
    assert counts.prefill_chunks(chunked, 1600) == [(512, 512)] * 3 + [(64, 64)]
    assert counts.prefill_chunks(chunked, 1700) == [(512, 512)] * 3 + [(164, 256)]
    assert counts.prefill_chunks({"kind": "continuous", "prefill_chunk": None}, 1020) == \
        [(1020, 1024)]
    paged = {"kind": "paged", "prefill_chunk": None, "block_size": 16}
    assert counts.prefill_chunks(paged, 600) == [(256, 256), (256, 256), (88, 128)]


def test_step_calls_at_real_rows_and_launched_rows(models):
    """The roofline counts the prompt's tokens and the requests decoded; the
    check against the port's counters counts the rows the kernels run."""
    from harness.record import Run
    from harness.window import StepRecord

    model = models["mistral-7b-v0.3.w4sym"]
    engine = {"kind": "continuous", "prefill_chunk": None, "num_slots": 16}
    run = Run(model=model, mix={}, engine=engine, w0=0.0, w1=1.0, setup_s=0.0, records=[],
              steps=[])
    step = StepRecord(0, 0.0, 0.1, [1020], [300, 301, 302])
    real = run.lut_calls(step)
    launched = run.lut_calls(step, launched=True)
    assert len(real) == len(launched) == 2 * 32 * 4
    assert sorted({m for m, _, _ in real}) == [3, 1020]
    assert sorted({m for m, _, _ in launched}) == [16, 1024]
    assert run.expected_launches([step]) == {"all": 256, "loop": 128, "mid": 0, "wide": 128}
    # at real rows the least time is less: fewer operations and bytes
    assert run.lut_least_s(real) < run.lut_least_s(launched)


def test_routes():
    assert [counts.route(m) for m in (1, 16, 17, 192, 193, 2048)] == \
        ["loop", "loop", "mid", "mid", "wide", "wide"]


def test_prefill_flops_by_hand(models):
    m = models["mistral-7b-v0.3.w4sym"]
    params = 4096 * 6144 + 4096 * 4096 + 4096 * 28672 + 14336 * 4096
    want = 2 * 32 * params * 300 + 2 * 4096 * 32768 + 4 * 32 * 32 * 128 * 300 * 301 / 2
    assert counts.prefill_flops(m, 300) == pytest.approx(want, rel=1e-12)
