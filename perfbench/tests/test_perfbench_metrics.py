"""The metric arithmetic on runs built by hand: percentiles over all
requests, sums over sums, and a stall that moves the tail."""

import math

import pytest

import tiny  # noqa: F401
from harness import readers
from harness.manifest import Manifest
from harness.record import Run
from harness.window import ReqRecord, StepRecord

MODEL = {"hidden_size": 4096, "intermediate_size": 14336, "num_hidden_layers": 32,
         "num_attention_heads": 32, "num_key_value_heads": 8, "head_dim": 128,
         "vocab_size": 32768, "quant": {"format": "w4sym", "group_size": 64}}
ENGINE = {"kind": "continuous", "num_slots": 16, "prefill_chunk": None}


@pytest.fixture(scope="module")
def read():
    m = Manifest()
    return lambda name, run: m.reader(name)(run)


def make_run(requests, steps=(), w0=10.0, w1=20.0):
    return Run(model=MODEL, mix={}, engine=ENGINE, w0=w0, w1=w1, setup_s=10.0,
               records=list(requests), steps=list(steps))


def req(i, due, first, n=3, gap=0.01, olen=3):
    r = ReqRecord(i, 100, olen, due)
    if first is not None:
        r.first = first
        r.last = first + gap * (n - 1)
        r.tokens = list(range(n))
    return r


def test_percentile_nearest_rank():
    assert readers.percentile([5, 1, 4, 2, 3], 90) == 5
    assert readers.percentile(list(range(1, 101)), 90) == 90
    assert readers.percentile([1, 2, math.inf], 50) == 2
    assert math.isnan(readers.percentile([], 90))


def test_ttft_over_every_request_due(read):
    reqs = [req(i, 10.0 + i * 0.1, 10.0 + i * 0.1 + 0.05) for i in range(10)]
    assert read("ttft_p90_ms", make_run(reqs)) == pytest.approx(50.0)
    assert read("ttft_p50_ms", make_run(reqs)) == pytest.approx(50.0)
    # one never answered counts as missing: the 90th percentile of ten is
    # the 9th value, so two missing move it past every number
    reqs[3].first = None
    assert read("ttft_p90_ms", make_run(reqs)) == pytest.approx(50.0)
    reqs[4].first = None
    assert read("ttft_p90_ms", make_run(reqs)) is None
    assert read("ttft_p75_ms", make_run(reqs)) == pytest.approx(50.0)
    # an answer after the close counts with its whole wait
    reqs[3].first, reqs[4].first = 25.0, 21.0
    assert read("ttft_p90_ms", make_run(reqs)) == pytest.approx(1e3 * (21.0 - 10.4))
    assert read("ttft_p75_ms", make_run(reqs)) == pytest.approx(50.0)
    # requests due before the window do not count
    early = [req(i, 5.0, 9.0) for i in range(30)]
    assert read("ttft_p90_ms", make_run(early + reqs[:3])) == pytest.approx(50.0)


def test_a_stall_moves_the_tail(read):
    base = [req(i, 10.0 + i * 0.1, 10.0 + i * 0.1 + 0.05) for i in range(40)]
    before = read("ttft_p75_ms", make_run(base))
    # a 2 s stall at t = 12: every request due in it waits until it ends
    stalled = [req(r.index, r.due, max(r.first, 14.0) if 12.0 <= r.due < 14.0 else r.first)
               for r in base]
    after = read("ttft_p75_ms", make_run(stalled))
    assert before == pytest.approx(50.0) and after > 500.0


def test_tpot_over_requests_finished_in_the_window(read):
    reqs = [req(i, 10.0, 11.0 + i, n=11, gap=0.02 + 0.001 * i, olen=11) for i in range(10)]
    reqs.append(req(99, 10.0, 19.99, n=11, gap=1.0, olen=11))  # finishes after the close
    got = read("tpot_p90_ms", make_run(reqs))
    assert got == pytest.approx(1e3 * (0.02 + 0.008))
    assert read("tpot_p50_ms", make_run(reqs)) == pytest.approx(1e3 * 0.024)


@pytest.mark.parametrize("dense,paged", [
    ("tpot_p90_ms", "tpot_p90_ms.paged"), ("tpot_p50_ms", "tpot_p50_ms.paged"),
    ("itl_mean_ms", "itl_mean_ms.paged"),
    ("decode_step_ms.steady", "decode_step_ms.paged"),
    ("prefill_ms_per_ktok.steady", "prefill_ms_per_ktok.paged"),
    ("decode_mfu.steady", "decode_mfu.paged")])
def test_each_cells_reader_keeps_the_same_arithmetic(read, dense, paged):
    """The paged engine's cell reads its metrics as the dense engine's does."""
    reqs = [req(i, 10.0 + i * 0.2, 10.3 + i * 0.2 + 0.01 * i, n=9, gap=0.02 + 0.002 * i, olen=9)
            for i in range(30)]
    steps = [StepRecord(i, 10.0 + 0.05 * i, 10.04 + 0.05 * i, [300] if i % 5 == 0 else [],
                        [400 + i] * 12) for i in range(100)]
    run = make_run(reqs, steps)
    assert read(dense, run) is not None
    assert read(paged, run) == read(dense, run)


def test_itl_mean_is_a_sum_over_a_sum(read):
    """Every finished request's streaming time over all their tokens after
    the first: a long request weighs by its tokens, not as one request."""
    reqs = [req(0, 10.0, 11.0, n=101, gap=0.02, olen=101),  # 100 gaps of 20 ms
            req(1, 10.0, 12.0, n=3, gap=0.5, olen=3),  # 2 gaps of 500 ms
            req(2, 10.0, 19.5, n=11, gap=0.1, olen=11)]  # finishes after the close
    got = read("itl_mean_ms", make_run(reqs))
    assert got == pytest.approx(1e3 * (100 * 0.02 + 2 * 0.5) / 102)
    assert read("itl_mean_ms", make_run(reqs[2:])) is None


def test_prefill_rate_is_a_sum_over_a_sum(read):
    steps = [StepRecord(0, 11.0, 11.2, [100, 300], [500]),
             StepRecord(1, 12.0, 12.1, [600], []),
             StepRecord(2, 13.0, 13.01, [], [700] * 4)]
    # (0.2 + 0.1) s over 1000 prompt tokens: 300 ms a thousand
    assert read("prefill_ms_per_ktok.steady", make_run([], steps)) == pytest.approx(300.0)
    assert read("decode_step_ms.steady", make_run([], steps)) == pytest.approx(10.0)


def test_decode_mfu_by_hand(read):
    steps = [StepRecord(0, 11.0, 11.01, [], [1000] * 16)]
    per_row = 2 * (32 * (4096 * 6144 + 4096 * 4096 + 4096 * 28672 + 14336 * 4096)
                   + 4096 * 32768)
    attn = 4 * 32 * 32 * 128 * 1000
    want = 100 * 16 * (per_row + attn) / (0.01 * 989e12)
    assert read("decode_mfu.steady", make_run([], steps)) == pytest.approx(want, rel=1e-9)
