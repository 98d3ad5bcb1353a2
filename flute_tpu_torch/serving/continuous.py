"""Continuous batching over a fixed slot grid, and the per-request sampling
and penalties every engine of the port shares; counterpart of
``flute_tpu/serving/continuous.py``.

``ContinuousBatchingEngine`` keeps one dense KV cache of ``num_slots`` rows
of ``max_len`` positions, allocated once and written in place: admission
prefills a request at batch 1 (a left-padded power-of-two bucket, or
chunks, or the remainder after a spliced run of cached prefix blocks) and
splices its K/V into a free slot's row; one T = 1 step serves every slot at
its own position (a ``[B]`` device ``pos`` into ``forward``). On CUDA the
step is captured once in a CUDA graph (``serving.graph.StepGraph``) and
replayed; penalties, sampling and logprobs run after it, outside the graph.

The warp and the penalties are deterministic and follow the JAX functions
step for step. The random draw cannot reproduce ``jax.random``'s bits: a
draw takes its randomness from an explicit ``torch.Generator`` (Gumbel-max
over the warped logits, which samples their softmax), seeded from (engine
key, request seed, generation index) alone (:func:`request_generator`), so
a request's sampled tokens do not depend on the batch around it.
"""

from __future__ import annotations

import dataclasses
from collections import OrderedDict, deque
from typing import Any, Callable, Optional, Sequence

import numpy as np
import torch

from flute_tpu_torch.device import resolve_device
from flute_tpu_torch.models import gemma2, llama
from flute_tpu_torch.parallel.tp import tp_engine_setup
from flute_tpu_torch.serving.graph import StepGraph
from flute_tpu_torch.serving.paged_fwd import check_family

_MASK64 = (1 << 64) - 1
# the engines' key of the sampling randomness (the JAX engines' PRNGKey(0))
ENGINE_KEY = 0


def _bucket(n: int, lo: int = 16) -> int:
    b = lo
    while b < n:
        b *= 2
    return b


def fold_in(key: int, data: int) -> int:
    """A new 63-bit seed from ``key`` and ``data`` (a splitmix64 round over
    their mix): the role of ``jax.random.fold_in`` for generator seeds."""
    z = (key * 0x9E3779B97F4A7C15 + data + 0x632BE59BD9B4E019) & _MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return (z ^ (z >> 31)) >> 1


def request_generator(device, seed: int, count: int, *tags: int) -> torch.Generator:
    """The generator of a request's ``count``-th draw, seeded with
    ``fold_in(fold_in(ENGINE_KEY, seed), count)`` and then folded with each
    of ``tags`` (speculative acceptance folds 1 for its uniforms and 2 for
    its residual draw, as the JAX engines do; an untagged generator is the
    plain engines' draw)."""
    key = fold_in(fold_in(ENGINE_KEY, seed), count)
    for tag in tags:
        key = fold_in(key, tag)
    gen = torch.Generator(device=device)
    gen.manual_seed(key)
    return gen


def family_of(config):
    """The model module (``llama`` or ``gemma2``) that serves ``config``."""
    return gemma2 if check_family(config) == "gemma2" else llama


def _warp_logits(logits: torch.Tensor, temperature: float, top_k: int, top_p: float):
    """Temperature, top-k and nucleus filters on one ``[V]`` f32 logits row:
    warped logits whose softmax is the sampling distribution. Temperature
    <= 0 collapses to a one-hot mass at the unwarped argmax (0 there, -inf
    elsewhere); top_k <= 0 and top_p >= 1 disable those filters."""
    v = logits.shape[-1]
    greedy = temperature <= 0.0
    # divided in f32 by the temperature rounded to f32, as JAX divides
    lg = logits / float(np.float32(1.0 if greedy else temperature))
    if top_k > 0:
        kth = torch.sort(lg, descending=True).values[min(max(top_k - 1, 0), v - 1)]
        lg = lg.masked_fill(lg < kth, float("-inf"))
    if top_p < 1.0:
        sorted_f = torch.sort(lg, descending=True).values
        cum = torch.cumsum(torch.softmax(sorted_f, dim=-1), dim=-1)
        # a gather, not an index by a 0-dim tensor (which reads it on the
        # host): no wait for the logits here
        idx = torch.clamp(torch.sum(cum < top_p), 0, v - 1).reshape(1)
        lg = lg.masked_fill(lg < torch.gather(sorted_f, 0, idx), float("-inf"))
    if greedy:
        return torch.full_like(logits, float("-inf")).scatter_(
            0, torch.argmax(logits).reshape(1), 0.0)
    return lg


def _sample_row(
    logits: torch.Tensor,
    temperature: float,
    top_k: int,
    top_p: float,
    generator: Optional[torch.Generator],
) -> torch.Tensor:
    """One token from one ``[V]`` row under per-request settings: the argmax
    for temperature <= 0 (no randomness drawn), else a Gumbel-max draw over
    the warped logits with noise from ``generator``."""
    if temperature <= 0.0:
        return torch.argmax(logits)
    return _gumbel_argmax(_warp_logits(logits, temperature, top_k, top_p), generator)


def _gumbel_argmax(lg: torch.Tensor, generator: Optional[torch.Generator]) -> torch.Tensor:
    """One draw from ``softmax(lg)`` (``lg`` one ``[V]`` row): the argmax of
    ``lg`` plus Gumbel noise from ``generator``."""
    u = torch.rand(lg.shape, generator=generator, device=lg.device, dtype=torch.float32)
    gumbel = -torch.log(-torch.log(u.clamp_min(torch.finfo(torch.float32).tiny)))
    return torch.argmax(lg + gumbel)


def _sample_slots(
    logits: torch.Tensor,  # [B, V]
    temperature: Sequence[float],
    top_k: Sequence[int],
    top_p: Sequence[float],
    generators: Sequence[Optional[torch.Generator]],
) -> torch.Tensor:
    """:func:`_sample_row` for each row with its own settings and generator;
    returns ``[B]`` int64 tokens."""
    return torch.stack([
        _sample_row(logits[i], float(temperature[i]), int(top_k[i]), float(top_p[i]),
                    generators[i])
        for i in range(logits.shape[0])
    ])


def _apply_penalties_row(logits, pcounts, ocounts, pres, freq, rep):
    """Per-request penalties on one ``[V]`` row (vLLM order, before the
    warp): repetition divides positive / multiplies negative logits of tokens
    seen in prompt or output; presence subtracts once per seen output token;
    frequency subtracts per output occurrence. The defaults (rep=1, pres=0,
    freq=0) are an exact identity."""
    return _apply_penalties(logits[None], pcounts[None], ocounts[None],
                            torch.as_tensor([pres]), torch.as_tensor([freq]),
                            torch.as_tensor([rep]))[0]


def _apply_penalties(logits, pcounts, ocounts, pres, freq, rep):
    """:func:`_apply_penalties_row` over rows: ``logits``, ``pcounts`` and
    ``ocounts`` ``[B, V]``, the per-row settings ``[B]``."""
    dev, dt = logits.device, logits.dtype
    pres = torch.as_tensor(pres, dtype=dt, device=dev)[:, None]
    freq = torch.as_tensor(freq, dtype=dt, device=dev)[:, None]
    rep = torch.as_tensor(rep, dtype=dt, device=dev)[:, None]
    seen_any = (pcounts + ocounts) > 0
    r = torch.where(rep > 0, rep, torch.ones_like(rep))
    lg = torch.where(seen_any, torch.where(logits > 0, logits / r, logits * r), logits)
    oc = ocounts.to(dt)
    return lg - freq * oc - pres * (ocounts > 0).to(dt)


def sample_step(row, pcounts, ocounts, pres, freq, rep, temperature, top_k, top_p, seeds,
                counts, greedy: bool):
    """A decode step's tokens ``[B]`` and their logprobs under the raw
    distribution, from f32 logits ``row`` ``[B, V]``: the penalties, then the
    argmax (``greedy``) or each slot's draw keyed on its (seed, count); the
    tokens are added to ``ocounts`` in place."""
    pen = _apply_penalties(row, pcounts, ocounts, pres, freq, rep)
    if greedy:
        nxt = torch.argmax(pen, dim=-1)
    else:
        gens = [request_generator(row.device, int(s), int(c)) if t > 0 else None
                for s, c, t in zip(seeds, counts, temperature)]
        nxt = _sample_slots(pen, temperature, top_k, top_p, gens)
    ar = torch.arange(row.shape[0], device=row.device)
    lp = torch.log_softmax(row, dim=-1)[ar, nxt]
    ocounts[ar, nxt] += 1
    return nxt, lp


def sample_first(logits_row: torch.Tensor, sampling, raw_row: Optional[torch.Tensor] = None):
    """The first token after prefill from ``logits_row`` (penalized or not)
    and its logprob under ``raw_row`` (the model's row; default
    ``logits_row``): the request's generation 0."""
    gen = (request_generator(logits_row.device, sampling.seed, 0)
           if sampling.temperature > 0 else None)
    tok = _sample_row(logits_row, sampling.temperature, sampling.top_k, sampling.top_p, gen)
    raw = logits_row if raw_row is None else raw_row
    lp = torch.log_softmax(raw.float(), dim=-1)[tok]
    return int(tok), float(lp)


def _first_token_row(row: np.ndarray, prompt, sampling, vocab: int):
    """Host-side prep of the first draw after prefill: the prompt's bincount
    and the repetition penalty over prompt tokens (presence and frequency
    act on output tokens, of which there are none yet). Returns (row for
    sampling, raw row for the logprob, pbins or None when unpenalized)."""
    if not sampling.has_penalties:
        return row, row, None
    pbins = np.zeros((vocab,), np.int32)
    np.add.at(pbins, np.asarray(prompt, np.int64), 1)
    r = sampling.repetition_penalty or 1.0
    raw = row
    row = row.copy()
    seen = pbins > 0
    row[seen] = np.where(row[seen] > 0, row[seen] / r, row[seen] * r)
    return row, raw, pbins


@dataclasses.dataclass
class SamplingParams:
    """Per-request sampling controls (greedy by default).

    ``stop_token_ids``: extra per-request stop tokens; generation finishes
    when one is produced, in addition to the engine-wide ``eos_id``, and
    like eos the stop token itself is not emitted. The penalties' defaults
    are exact no-ops: repetition over prompt and output tokens, presence and
    frequency over output tokens only."""

    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 1.0
    seed: int = 0
    stop_token_ids: tuple = ()
    repetition_penalty: float = 1.0
    presence_penalty: float = 0.0
    frequency_penalty: float = 0.0

    def __post_init__(self):
        self.stop_token_ids = tuple(self.stop_token_ids)

    @property
    def has_penalties(self) -> bool:
        return (
            self.repetition_penalty != 1.0
            or self.presence_penalty != 0.0
            or self.frequency_penalty != 0.0
        )


@dataclasses.dataclass
class _Request:
    rid: int
    prompt: list
    max_new_tokens: int
    sampling: SamplingParams = dataclasses.field(default_factory=SamplingParams)
    out: list = dataclasses.field(default_factory=list)
    # log p(token) under the raw model distribution, parallel to ``out``
    logprobs: list = dataclasses.field(default_factory=list)
    done: bool = False


@dataclasses.dataclass
class ContinuousBatchingEngine:
    """Continuous-batching decode (greedy or per-request sampled) over a
    fixed grid of ``num_slots`` slots, on ``device`` (``cuda`` unless named;
    params must live there). ``forward`` and ``init_cache`` default to the
    config's family (Llama or Gemma-2). The fields are the JAX engine's in
    its order; ``device`` is keyword-only."""

    params: Any
    config: Any
    forward: Optional[Callable] = None
    init_cache: Optional[Callable] = None
    num_slots: int = 8
    max_len: int = 1024
    eos_id: Optional[int] = None
    pad_id: int = 0
    # prompts longer than this prefill in chunks of it (None = one bucket)
    prefill_chunk: Optional[int] = None
    # block-granular exact prefix cache: K/V of complete ``prefix_block``-
    # token blocks of recent prompts, at most this many blocks (LRU; 0 =
    # off); an admission splices the longest contiguous run of cached
    # blocks from position 0 and prefills only the rest
    prefix_cache_entries: int = 0
    prefix_block: int = 64
    # token_callback(rid, token) after every generated token
    token_callback: Optional[Callable[[int, int], None]] = None
    # tensor parallelism (see serving.engine.Engine): every rank runs the
    # same calls on its slices; the slot cache holds this rank's KV heads
    mesh: Any = None
    params_specs: Any = None
    device: Any = dataclasses.field(default=None, kw_only=True)

    def __post_init__(self):
        family = family_of(self.config)
        self.forward = self.forward or family.forward
        self.init_cache = self.init_cache or family.init_cache
        self._cache_config = self.config
        if self.mesh is not None:
            self.params, self.params_specs, self.forward, self._cache_config = tp_engine_setup(
                self.params, self.config, self.mesh, self.params_specs, self.forward)
            self.device = self.mesh.device
        self.device = resolve_device(self.device)
        n, dev = self.num_slots, self.device
        self._queue: deque[_Request] = deque()
        self._slots: list[Optional[_Request]] = [None] * n
        self._pos = np.zeros((n,), np.int64)
        self._last_tok = np.zeros((n,), np.int64)
        self._gen_count = np.zeros((n,), np.int64)
        self._temp = np.zeros((n,), np.float32)
        self._top_k = np.zeros((n,), np.int32)
        self._top_p = np.ones((n,), np.float32)
        self._seeds = np.zeros((n,), np.int64)
        v = self.config.vocab_size
        self._pcounts = torch.zeros((n, v), dtype=torch.int32, device=dev)
        self._ocounts = torch.zeros((n, v), dtype=torch.int32, device=dev)
        # the penalties' settings per slot, on the device (set at admission)
        self._pres = torch.zeros((n,), dtype=torch.float32, device=dev)
        self._freq = torch.zeros((n,), dtype=torch.float32, device=dev)
        self._rep = torch.ones((n,), dtype=torch.float32, device=dev)
        self._cache = self.init_cache(self._cache_config, n, self.max_len, device=dev)
        self._next_rid = 0
        self._finished: dict[int, list] = {}
        self.finished_logprobs: dict[int, list] = {}
        # tuple(prompt[:i * prefix_block]) -> K/V of block i alone
        # (positions [(i - 1) * B, i * B)), in LRU order
        self._prefix_store: "OrderedDict[tuple, dict]" = OrderedDict()
        self.prefix_hits = 0  # requests that reused >= 1 cached block
        self.prefix_block_hits = 0  # blocks spliced in all
        # the decode step's inputs, at fixed addresses for its graph
        self._step_tokens = torch.zeros((n, 1), dtype=torch.int64, device=dev)
        self._step_pos = torch.zeros((n,), dtype=torch.int64, device=dev)
        self._graph = None if not self.graphed else StepGraph(
            lambda: self._decode_logits(self._step_tokens, self._step_pos), dev)

    @property
    def graphed(self) -> bool:
        """Whether the decode step is captured in a CUDA graph: on CUDA,
        without a mesh (a TP step runs eagerly)."""
        return self.device.type == "cuda" and self.mesh is None

    # -- steps ---------------------------------------------------------------

    @torch.inference_mode()
    def _decode_logits(self, tokens: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
        """One eager T = 1 step for every slot at its own cache position
        ``pos`` ``[B]`` (free slots compute on junk in their own rows);
        returns f32 logits ``[B, V]``."""
        logits, _ = self.forward(self.params, self.config, tokens, self._cache, pos)
        return logits[:, -1]

    def _step_logits(self) -> torch.Tensor:
        """The decode step's logits from the host's last tokens and
        positions, copied into the step's buffers: on CUDA the step's graph
        (captured at its first call, which runs eagerly; the returned logits
        are overwritten by the next step), elsewhere :meth:`_decode_logits`."""
        self._step_tokens.copy_(torch.from_numpy(self._last_tok[:, None]))
        self._step_pos.copy_(torch.from_numpy(self._pos))
        if self._graph is None:
            return self._decode_logits(self._step_tokens, self._step_pos)
        return self._graph()

    @torch.inference_mode()
    def _decode(self, greedy: bool):
        """A decode step for every slot: tokens [B] and the logprobs of the
        raw distribution, on the host."""
        nxt, lp = sample_step(self._step_logits(), self._pcounts, self._ocounts, self._pres,
                              self._freq, self._rep, self._temp, self._top_k, self._top_p,
                              self._seeds, self._gen_count, greedy)
        host = torch.stack([nxt.double(), lp.double()]).cpu().numpy()  # one wait
        return host[0].astype(np.int64), host[1]

    # -- admission -----------------------------------------------------------

    def submit(
        self,
        prompt: Sequence[int],
        max_new_tokens: int = 64,
        sampling: Optional[SamplingParams] = None,
        **sampling_kw,
    ) -> int:
        """Queue a request. Per-request sampling: a SamplingParams, or
        temperature=/top_k=/top_p=/seed=/... keywords (default greedy)."""
        if sampling is None:
            sampling = SamplingParams(**sampling_kw)
        elif sampling_kw:
            raise ValueError("pass either sampling= or keyword params, not both")
        rid = self._next_rid
        self._next_rid += 1
        self._queue.append(_Request(rid, list(prompt), max_new_tokens, sampling=sampling))
        return rid

    def _run_chunk(self, tokens: list, width: int, small_cache: dict, pos: int):
        """One right-padded prefill chunk (``width`` slots) at cache slot
        ``pos``: f32 logits ``[width, V]``. Junk K/V past the prompt is
        causally masked, and decode overwrites it before it is attended."""
        toks = np.full((1, width), self.pad_id, np.int64)
        toks[0, :len(tokens)] = tokens
        logits, _ = self.forward(self.params, self.config,
                                 torch.from_numpy(toks).to(self.device), small_cache, pos)
        return logits[0]

    def _find_prefix(self, prompt: list) -> list:
        """The longest contiguous run of cached blocks over a proper prefix
        of ``prompt`` (at least one token must remain to prefill)."""
        bs = self.prefix_block
        hit = []
        for i in range(1, (len(prompt) - 1) // bs + 1):
            entry = self._prefix_store.get(tuple(prompt[: i * bs]))
            if entry is None:
                break  # the splice is contiguous from position 0
            hit.append(entry)
        return hit

    def _store_prefix(self, prompt: list, small_cache: dict, start: int, plen: int) -> None:
        """Store every complete block of the prompt not cached yet
        (``small_cache`` holds its K/V at columns [start, start + plen))."""
        bs = self.prefix_block
        for i in range(1, plen // bs + 1):
            key = tuple(prompt[: i * bs])
            if key in self._prefix_store:
                self._prefix_store.move_to_end(key)
                continue
            c0 = start + (i - 1) * bs
            self._prefix_store[key] = {
                kv: [layer[:, :, c0:c0 + bs].clone() for layer in small_cache[kv]]
                for kv in ("k", "v")
            }
            while len(self._prefix_store) > self.prefix_cache_entries:
                self._prefix_store.popitem(last=False)  # least recently used

    def _prefill_from_prefix(self, req: _Request, hit: list):
        """Splice the cached run and prefill only the rest (RoPE'd K is
        position-absolute, so reuse at the same positions is exact)."""
        self.prefix_hits += 1
        self.prefix_block_hits += len(hit)
        bs = self.prefix_block
        plen = len(req.prompt)
        p0 = len(hit) * bs
        rem = plen - p0
        rb = _bucket(rem)
        small_cache = self.init_cache(self._cache_config, 1, _bucket(max(plen, p0 + rb)),
                                      device=self.device)
        for bi, entry in enumerate(hit):
            self._prefix_store.move_to_end(tuple(req.prompt[: (bi + 1) * bs]))
            for kv in ("k", "v"):
                for layer, block in zip(small_cache[kv], entry[kv]):
                    layer[:, :, bi * bs:(bi + 1) * bs] = block
        logits = self._run_chunk(req.prompt[p0:], rb, small_cache, p0)
        return logits[rem - 1], small_cache, plen, 0

    @torch.inference_mode()
    def _prefill(self, req: _Request):
        """Prefill one request: (last prompt token's f32 logits [V], the
        small cache, plen, start), the sequence at columns [start, start +
        plen) of the small cache."""
        plen = len(req.prompt)
        chunk = self.prefill_chunk
        if self.prefix_cache_entries:
            hit = self._find_prefix(req.prompt)
            if hit:
                out = self._prefill_from_prefix(req, hit)
                self._store_prefix(req.prompt, out[1], out[3], plen)
                return out
        if chunk is None or plen <= chunk:
            bucket = _bucket(plen)
            toks = np.full((1, bucket), self.pad_id, np.int64)
            toks[0, bucket - plen:] = req.prompt  # left-padded into the bucket
            start = bucket - plen
            small_cache = self.init_cache(self._cache_config, 1, bucket, device=self.device)
            logits, _ = self.forward(self.params, self.config,
                                     torch.from_numpy(toks).to(self.device), small_cache, 0,
                                     torch.tensor([start], device=self.device))
            if self.prefix_cache_entries:
                self._store_prefix(req.prompt, small_cache, start, plen)
            return logits[0, -1], small_cache, plen, start
        # full chunks at exact positions, then a right-padded remainder
        full = (plen // chunk) * chunk
        rem = plen - full
        rb = _bucket(rem) if rem else 0
        small_cache = self.init_cache(self._cache_config, 1, _bucket(max(plen, full + rb)),
                                      device=self.device)
        for c0 in range(0, full, chunk):
            logits = self._run_chunk(req.prompt[c0:c0 + chunk], chunk, small_cache, c0)
        last = logits[-1]
        if rem:
            last = self._run_chunk(req.prompt[full:], rb, small_cache, full)[rem - 1]
        if self.prefix_cache_entries:
            self._store_prefix(req.prompt, small_cache, 0, plen)
        return last, small_cache, plen, 0

    @torch.inference_mode()
    def _admit(self):
        for slot in range(self.num_slots):
            if self._slots[slot] is not None or not self._queue:
                continue
            req = self._queue.popleft()
            last, small_cache, plen, start = self._prefill(req)
            # the prompt's K/V into the slot's row, in place
            for kv in ("k", "v"):
                for big, small in zip(self._cache[kv], small_cache[kv]):
                    big[slot, :, :plen] = small[0, :, start:start + plen]
            s = req.sampling
            if s.has_penalties:
                srow, _, pbins = _first_token_row(last.cpu().numpy(), req.prompt, s,
                                                  self.config.vocab_size)
                srow = torch.from_numpy(srow).to(self.device)
                self._pcounts[slot] = torch.from_numpy(pbins).to(self.device)
            else:
                srow = last
                self._pcounts[slot] = 0
            tok, first_lp = sample_first(srow, s, last)
            self._ocounts[slot] = 0
            self._ocounts[slot, tok] = 1
            self._slots[slot] = req
            self._pos[slot] = plen
            self._last_tok[slot] = tok
            self._gen_count[slot] = 1  # the next decode draw is generation 1
            self._temp[slot] = s.temperature
            self._top_k[slot] = s.top_k
            self._top_p[slot] = s.top_p
            self._seeds[slot] = s.seed
            self._pres[slot] = s.presence_penalty
            self._freq[slot] = s.frequency_penalty
            self._rep[slot] = s.repetition_penalty
            self._record(slot, tok, first_lp)

    # -- stepping ------------------------------------------------------------

    def _record(self, slot: int, tok: int, lp: Optional[float] = None):
        req = self._slots[slot]
        if req is None:
            return
        stop = ((self.eos_id is not None and tok == self.eos_id)
                or tok in req.sampling.stop_token_ids)
        if stop or req.done:
            req.done = True
        else:
            req.out.append(tok)
            if lp is not None:
                req.logprobs.append(lp)
            if self.token_callback is not None:
                self.token_callback(req.rid, tok)
        if req.done or len(req.out) >= req.max_new_tokens or self._pos[slot] + 1 >= self.max_len:
            req.done = True
            self._finished[req.rid] = req.out
            self.finished_logprobs[req.rid] = req.logprobs
            self._slots[slot] = None

    def step(self) -> bool:
        """Admit waiting requests, then one decode step for every slot.
        True while work remains."""
        self._admit()
        active = [i for i, r in enumerate(self._slots) if r is not None]
        if not active:
            return bool(self._queue)
        nxt, lp = self._decode(greedy=all(self._temp[i] <= 0 for i in active))
        for slot in active:
            self._pos[slot] += 1
            self._gen_count[slot] += 1
            tok = int(nxt[slot])
            self._last_tok[slot] = tok
            self._record(slot, tok, float(lp[slot]))
        return bool(self._queue) or any(r is not None for r in self._slots)

    def run(self) -> dict[int, list]:
        """Drain the queue; {request id: generated tokens}."""
        while self.step():
            pass
        out, self._finished = self._finished, {}
        return out
