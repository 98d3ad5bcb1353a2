"""The one traffic generator: requests (prompt tokens, output length, due
time) from a mix's parameters and the run's seed.

A mix file (``perfbench/traffic/<name>.json``) gives:

* ``kind``: ``open_loop`` (requests due at arrival times, sent whatever the
  server does) or ``backlog`` (a queue kept ``backlog`` requests deep, so
  that every slot is always busy);
* ``prompt_len`` and ``output_len``: ``{"dist": "lognormal", "median",
  "sigma", "min", "max"}`` or ``{"dist": "uniform", "min", "max"}``
  (whole numbers, both ends included);
* ``arrivals`` (open loop): ``{"process": "poisson"}`` at the cell's rate,
  or ``{"process": "gamma", "cv": c}`` for bursts at the same mean rate;
* ``shape_seed``, ``requests`` and ``block``: the sizes and gaps are one
  fixed sequence of ``requests`` draws made from ``shape_seed``, stratified
  in blocks of ``block``: within each block, the prompt lengths take one
  draw from each of ``block`` equal slices of the distribution's
  probability, and so do the output lengths and the gaps; each block's
  gaps are scaled to the mean gap. The run's seed shuffles the requests,
  and apart from them the gaps, within each block, and draws the token
  ids. So every seed offers the same work in every block, in another
  order, and a window holds the same number of arrivals (a seed that drew
  the sizes too would change the work: see ``PERF.md``).

A request's output length is cut so that prompt plus output stays below the
engine's ``max_len`` (a deployment's context limit).
"""

from __future__ import annotations

import dataclasses
from statistics import NormalDist

import numpy as np


@dataclasses.dataclass
class Request:
    index: int
    prompt: np.ndarray  # int64 token ids
    output_len: int
    due: float  # seconds from the start of arrivals (open loop); 0 for a backlog


def stratified(rng: np.random.Generator, n: int, block: int) -> np.ndarray:
    """``n`` uniform draws in (0, 1): each block of ``block`` holds one
    from each slice ``[j / block, (j + 1) / block)``, in a shuffled order."""
    out = np.empty(n)
    for b in range(0, n, block):
        k = min(block, n - b)
        out[b:b + k] = (rng.permutation(k) + rng.random(k)) / k
    return np.clip(out, 1e-12, 1 - 1e-12)


def _block_order(rng: np.random.Generator, n: int, block: int) -> np.ndarray:
    """0 .. n-1 shuffled within consecutive blocks of ``block``."""
    return np.concatenate([b + rng.permutation(min(block, n - b)) for b in range(0, n, block)])


def _lengths(u: np.ndarray, spec: dict) -> np.ndarray:
    """Lengths at probabilities ``u`` of the spec's distribution."""
    lo, hi = int(spec["min"]), int(spec["max"])
    if spec["dist"] == "lognormal":
        z = np.array([NormalDist().inv_cdf(float(p)) for p in u])
        x = np.exp(np.log(float(spec["median"])) + float(spec["sigma"]) * z)
        return np.clip(np.rint(x), lo, hi).astype(np.int64)
    if spec["dist"] == "uniform":
        return np.minimum(lo + np.floor(u * (hi - lo + 1)), hi).astype(np.int64)
    raise ValueError(f"unknown length distribution {spec['dist']!r}")


def _gaps(u: np.ndarray, spec: dict, block: int) -> np.ndarray:
    """Gaps between arrivals at probabilities ``u``, each block's scaled
    to mean one."""
    if spec["process"] == "poisson":
        g = -np.log1p(-u)
    elif spec["process"] == "gamma":
        from scipy.stats import gamma

        shape = 1.0 / float(spec["cv"]) ** 2
        g = gamma.ppf(u, shape, scale=1.0 / shape)
    else:
        raise ValueError(f"unknown arrival process {spec['process']!r}")
    for b in range(0, len(g), block):
        g[b:b + block] /= g[b:b + block].mean()
    return g


def generate(mix: dict, seed: int, vocab: int, max_len: int, rate: float | None = None) -> list:
    """The mix's requests for ``seed``, in due order (open loop: due times
    at ``rate`` requests a second) or in queue order (backlog)."""
    n, block = int(mix["requests"]), int(mix["block"])
    shape = np.random.default_rng(int(mix["shape_seed"]))
    plens = _lengths(stratified(shape, n, block), mix["prompt_len"])
    olens = _lengths(stratified(shape, n, block), mix["output_len"])
    olens = np.minimum(olens, max_len - 1 - plens)
    if (olens < 1).any():
        raise ValueError("a prompt leaves no room for output under max_len")
    seed = int(seed) % (1 << 64)
    rng = np.random.default_rng([seed & 0xFFFFFFFF, seed >> 32, 0x7E57])
    order = _block_order(rng, n, block)
    plens, olens = plens[order], olens[order]
    if mix["kind"] == "open_loop":
        if rate is None or rate <= 0:
            raise ValueError("an open-loop mix needs the cell's rate")
        gaps = _gaps(stratified(shape, n, block), mix["arrivals"], block)
        gaps = gaps[_block_order(rng, n, block)] / rate
        due = np.cumsum(gaps) - gaps[0]
    elif mix["kind"] == "backlog":
        due = np.zeros(n)
    else:
        raise ValueError(f"unknown traffic kind {mix['kind']!r}")
    tokens = rng.integers(0, vocab, int(plens.sum()))
    cuts = np.concatenate([[0], np.cumsum(plens)])
    return [Request(i, tokens[cuts[i]:cuts[i + 1]], int(olens[i]), float(due[i]))
            for i in range(n)]
