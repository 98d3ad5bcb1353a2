"""The traffic generator: deterministic for a seed, within the mix's
ranges, at its rate, stratified within each block, and the same work for
every seed."""

from collections import Counter

import numpy as np
import pytest

import tiny
from harness import traffic
from harness.manifest import Manifest


@pytest.fixture(scope="module")
def mixes():
    """The repository's mixes, and the toy backlog mix of the CPU tests."""
    return {"chat": Manifest().traffic("chat"), "batch": tiny.MIXES["batch"]}


@pytest.mark.parametrize("name", ["chat", "batch"])
def test_same_seed_same_requests(mixes, name):
    mix = mixes[name]
    a = traffic.generate(mix, 2**31 + 77, 32768, mix["engine"]["max_len"], rate=4.0)
    b = traffic.generate(mix, 2**31 + 77, 32768, mix["engine"]["max_len"], rate=4.0)
    c = traffic.generate(mix, 2**31 + 78, 32768, mix["engine"]["max_len"], rate=4.0)
    assert all(x.due == y.due and x.output_len == y.output_len and
               np.array_equal(x.prompt, y.prompt) for x, y in zip(a, b))
    assert any(not np.array_equal(x.prompt, y.prompt) for x, y in zip(a, c))


@pytest.mark.parametrize("name", ["chat", "batch"])
def test_lengths_in_range(mixes, name):
    mix = mixes[name]
    max_len = mix["engine"]["max_len"]
    reqs = traffic.generate(mix, 5, 32768, max_len, rate=4.0)
    p = np.array([len(r.prompt) for r in reqs])
    o = np.array([r.output_len for r in reqs])
    assert p.min() >= mix["prompt_len"]["min"] and p.max() <= mix["prompt_len"]["max"]
    assert o.max() <= mix["output_len"]["max"]
    assert (o >= 1).all() and (p + o + 1 <= max_len).all()
    assert all(0 <= int(r.prompt.min()) and int(r.prompt.max()) < 32768 for r in reqs)


def test_chat_lognormal_medians(mixes):
    mix = mixes["chat"]
    reqs = traffic.generate(mix, 9, 32768, mix["engine"]["max_len"], rate=4.0)
    assert abs(np.median([len(r.prompt) for r in reqs]) / mix["prompt_len"]["median"] - 1) < 0.05
    assert abs(np.median([r.output_len for r in reqs]) / mix["output_len"]["median"] - 1) < 0.05


@pytest.mark.parametrize("rate", [1.5, 4.0, 9.0])
def test_open_loop_rate(mixes, rate):
    mix = mixes["chat"]
    reqs = traffic.generate(mix, 11, 32768, mix["engine"]["max_len"], rate=rate)
    due = np.array([r.due for r in reqs])
    assert due[0] == 0 and (np.diff(due) >= 0).all()
    assert abs((len(due) - 1) / due[-1] / rate - 1) < 0.08


@pytest.mark.parametrize("block", [1, 4, 7])
def test_stratified_takes_one_draw_from_each_slice(block):
    rng = np.random.default_rng(3)
    u = traffic.stratified(rng, 10 * block + 3, block)
    for b in range(0, len(u), block):
        k = len(u[b:b + block])
        assert sorted(np.floor(u[b:b + block] * k).astype(int)) == list(range(k))


def test_every_seed_offers_the_same_work(mixes):
    """Within each block of the mix the sizes are the same multiset for
    every seed; only their order, the gaps' order and the token ids
    change."""
    mix = mixes["chat"]
    blk = mix["block"]
    sizes, dues = [], []
    for seed in (1, 2, 2**33 + 5):
        reqs = traffic.generate(mix, seed, 32768, mix["engine"]["max_len"], rate=4.0)
        sizes.append([Counter((len(r.prompt), r.output_len) for r in reqs[b:b + blk])
                      for b in range(0, len(reqs), blk)])
        dues.append([r.due for r in reqs])
    assert sizes[0] == sizes[1] == sizes[2]
    assert dues[0] != dues[1]


@pytest.mark.parametrize("seed", [1, 2**31 + 5, 2**33 + 7])
def test_each_block_of_arrivals_takes_its_mean_time(mixes, seed):
    """Every block's gaps sum to the block's share of the rate, so a window
    holds the same number of arrivals whatever the seed."""
    mix = mixes["chat"]
    blk = mix["block"]
    due = np.array([r.due for r in traffic.generate(mix, seed, 32768, mix["engine"]["max_len"],
                                                    rate=2.0)])
    # the last arrival of each block comes a block's mean time after the last
    # of the block before
    assert np.allclose(np.diff(due[blk - 1::blk]), blk / 2.0)


def test_backlog_has_no_due_times(mixes):
    mix = mixes["batch"]
    reqs = traffic.generate(mix, 3, 32768, mix["engine"]["max_len"])
    assert all(r.due == 0 for r in reqs)


def test_open_loop_needs_a_rate(mixes):
    mix = mixes["chat"]
    with pytest.raises(ValueError):
        traffic.generate(mix, 3, 32768, mix["engine"]["max_len"])
