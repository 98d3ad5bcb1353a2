"""Driving an engine: warm-up, the ramp, the measured window, and what the
benchmark records of them from its own side of ``submit`` / ``step`` /
``token_callback``.

A request's record keeps when it was due, when each of its tokens reached
the host (the engine calls the callback once the step has synchronised),
and its tokens. A step's record keeps its host span, the prompts it
admitted (a request whose first token came in the step) and the context of
every request it decoded. Under ``--trace 1`` each step is also a
``torch.profiler`` range named ``bench.step.<n>``, so that its span can be
read in the device trace's clock.

Open loop: requests are submitted when due, whatever the engine does; each
is timed from its due time, and how late the loop submitted it is kept.
Backlog: the queue is topped up before every step so that ``backlog``
requests always wait.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Callable, Optional

from .counts import prefill_rows


@dataclasses.dataclass
class ReqRecord:
    index: int
    plen: int
    olen: int
    due: float
    submitted: float = 0.0
    first: Optional[float] = None
    last: Optional[float] = None
    tokens: list = dataclasses.field(default_factory=list)

    @property
    def done(self) -> bool:
        return len(self.tokens) >= self.olen


@dataclasses.dataclass
class StepRecord:
    index: int
    t0: float
    t1: float
    admitted: list  # prompt lengths of the requests admitted in the step
    contexts: list  # context of each request decoded in the step


class Client:
    """Submits requests to ``engine``, steps it, and records both."""

    def __init__(self, engine, clock: Callable[[], float] = time.perf_counter):
        self.engine = engine
        self.clock = clock
        self.by_rid: dict = {}
        self.records: list = []
        self.steps: list = []
        self._in_step: dict = {}
        self.pending = 0  # submitted and not finished
        self.waiting = 0  # submitted and not yet admitted
        self.range_fn = None  # set while tracing: a profiler range per step
        engine.token_callback = self._on_token

    def _on_token(self, rid: int, tok: int) -> None:
        rec = self.by_rid.get(rid)
        if rec is None:
            return
        now = self.clock()
        if rec.first is None:
            rec.first = now
            self.waiting -= 1
        rec.last = now
        rec.tokens.append(int(tok))
        self._in_step.setdefault(rid, []).append(len(rec.tokens) - 1)
        if rec.done:
            self.pending -= 1

    def submit(self, req, due: float) -> ReqRecord:
        rec = ReqRecord(req.index, len(req.prompt), req.output_len, due)
        rec.submitted = self.clock()
        rid = self.engine.submit(req.prompt.tolist(), max_new_tokens=req.output_len)
        self.by_rid[rid] = rec
        self.records.append(rec)
        self.pending += 1
        self.waiting += 1
        return rec

    def step(self) -> StepRecord:
        self._in_step = {}
        n = len(self.steps)
        ctx = self.range_fn(f"bench.step.{n}") if self.range_fn else contextlib.nullcontext()
        t0 = self.clock()
        with ctx:
            self.engine.step()
        t1 = self.clock()
        admitted, contexts = [], []
        for rid, idxs in self._in_step.items():
            rec = self.by_rid[rid]
            for j in idxs:
                if j == 0:
                    admitted.append(rec.plen)
                else:  # the token at output index j attends plen + j positions
                    contexts.append(rec.plen + j)
        st = StepRecord(n, t0, t1, admitted, contexts)
        self.steps.append(st)
        return st

    def drain(self) -> None:
        """Step until every submitted request has finished."""
        while self.pending > 0:
            self.step()


def warm_prompt_lengths(engine: dict, lo: int, hi: int) -> list:
    """One prompt length for each distinct set of prefill call rows over
    ``[lo, hi]`` (the engine's buckets and chunks), and ``hi``: every shape
    the mix's admissions will use."""
    seen, out = set(), []
    for plen in range(lo, hi + 1):
        key = frozenset(prefill_rows(engine, plen))
        if key not in seen:
            seen.add(key)
            out.append(plen)
    if hi not in out:
        out.append(hi)
    return out


def open_loop(client: Client, requests: list, origin: float, until: float,
              on_tick: Optional[Callable[[float], None]] = None,
              hold: Optional[Callable[[], bool]] = None, grace: float = 60.0) -> None:
    """Submit each request at ``origin + due`` and step the engine until
    ``until``, and past it (at most ``grace`` seconds, arrivals going on)
    while ``hold()`` is true; sleep when there is nothing to do.
    ``requests`` is in due order; ``on_tick(now)`` runs before every step
    or sleep."""
    i, n = 0, len(requests)
    clock = client.clock
    while True:
        now = clock()
        if now >= until and (hold is None or not hold() or now >= until + grace):
            return
        if on_tick is not None:
            on_tick(now)
        while i < n and origin + requests[i].due <= now:
            client.submit(requests[i], origin + requests[i].due)
            i += 1
        if client.pending > 0:
            client.step()
        else:
            nxt = origin + requests[i].due if i < n else until
            time.sleep(max(0.0, min(nxt, max(until, now)) - now))


def backlog(client: Client, requests: list, depth: int, until: float,
            on_tick: Optional[Callable[[float], None]] = None) -> int:
    """Keep ``depth`` requests waiting and step until ``until``; returns
    the index of the next request not yet submitted."""
    i = 0
    clock = client.clock
    while True:
        now = clock()
        if now >= until:
            return i
        if on_tick is not None:
            on_tick(now)
        while client.waiting < depth:
            if i >= len(requests):
                raise RuntimeError("the backlog mix ran out of requests; raise 'requests'")
            client.submit(requests[i], now)
            i += 1
        client.step()
