"""Paged KV-cache serving, counterpart of ``flute_tpu/serving/paged.py``.

K/V live in per-layer block pools ``[num_blocks, Hkv, block, D]``; a
per-slot block table, shared by every layer, maps logical blocks to pool
rows, so the cache holds sum(ceil(len_i / block)) blocks rather than
num_slots x max_len positions. Allocation is a host-side free list:
admission takes blocks, completion returns them. Block 0 is the trash
block: parked slots point at it with length 0, and the writes of padding
positions land there.

* Decode: one T = 1 forward for every slot whose attention is the paged
  decode kernel (K5, ``ops.paged_attention.paged_decode_attention``). The
  host writes the block tables, lengths and last tokens into fixed device
  buffers before each step; on CUDA the step is captured once in a CUDA
  graph (``serving.graph.StepGraph``) and replayed for the engine's whole
  life, across admissions and finishes. Penalties, sampling and logprobs
  run after it, outside the graph.
* Prefill, two routes. ``pool_prefill=True``: prompt chunks (``prefill_chunk``,
  default 256) are written straight into the slot's pool blocks and attend
  through the multi-query kernel (K6, ``serving.paged_fwd``). Otherwise the
  dense model runs the prompt (in ``prefill_chunk`` pieces when set) into a
  bucketed scratch cache, into which shared prefix blocks are spliced
  first, and the new whole blocks are then scattered into the pool.
* Prefix cache (``prefix_cache_blocks`` > 0): full prompt blocks stay in the
  pool after their request finishes, keyed by their exact token prefix,
  and later requests share them by reference (refcounts keep live blocks;
  unreferenced ones are evicted least recently used first under pressure).
* Per-request sampling, penalties, stop tokens, logprobs of the raw
  distribution and a per-token callback, as the JAX engine has them.

Unlike the JAX engine, the pools are written in place (it returns updated
copies); each layer's K/V write still comes before that layer's attention.
Sampled tokens cannot reproduce ``jax.random``'s bits; the randomness of a
draw is keyed on (``continuous.ENGINE_KEY``, request seed, generation
index) through an explicit ``torch.Generator``, so a request's tokens do
not depend on the batch around it. Llama and Gemma-2 are served, told
apart by the config as the JAX engine tells them
(``serving.paged_fwd.check_family``).

Tensor parallelism (``mesh``, as ``serving.engine.Engine`` takes it): the
pools hold this rank's KV heads, the decode step, both prefill routes and
the paged kernels run on the rank's slices with two all-reduces per block,
and the step runs eagerly (``graphed`` is False).
"""

from __future__ import annotations

import dataclasses
from collections import OrderedDict
from typing import Any, Optional, Sequence

import numpy as np
import torch

from flute_tpu_torch.device import resolve_device
from flute_tpu_torch.models.llama import rope_tables
from flute_tpu_torch.ops.paged_attention import paged_decode_attention
from flute_tpu_torch.parallel.tp import tp_engine_setup
from flute_tpu_torch.serving.continuous import (
    SamplingParams,
    _bucket,
    _first_token_row,
    family_of,
    sample_first,
    sample_step,
)
from flute_tpu_torch.serving.graph import StepGraph
from flute_tpu_torch.serving.paged_fwd import (
    _head_logits,
    attention_options,
    decoder_layers,
    embed,
    make_paged_multitoken_forward,
)


@dataclasses.dataclass
class PagedEngine:
    """Slot-based engine over a paged KV pool (greedy or per-request
    sampled decode), on ``device`` (``cuda`` unless named; params must live
    there). ``num_blocks`` bounds the cached tokens (num_blocks * block_size),
    apart from ``num_slots * max_len``. The fields are the JAX engine's in
    its order, ``(params, config, num_slots, block_size, num_blocks,
    max_len, pad_id, eos_id, forward, init_cache, token_callback,
    prefix_cache_blocks, mesh, params_specs, prefill_chunk, pool_prefill)``;
    ``device`` is keyword-only, so that a subclass's fields follow them as
    in JAX."""

    params: Any
    config: Any
    num_slots: int = 8
    block_size: int = 16
    num_blocks: int = 64
    max_len: int = 512  # per-sequence logical cap (table width)
    pad_id: int = 0
    eos_id: Optional[int] = None
    # dense-prefill hooks (the model's forward and init_cache)
    forward: Any = None
    init_cache: Any = None
    # token_callback(rid, token) after every generated token
    token_callback: Any = None
    # pool-level prefix caching: cached blocks kept at most (0 = off)
    prefix_cache_blocks: int = 0
    # tensor parallelism: a parallel.tp.Mesh (every rank makes the same calls)
    mesh: Any = None
    params_specs: Any = None
    # prompts longer than this prefill in chunks of it (None = one call on
    # the dense route, 256 on the pool route)
    prefill_chunk: Optional[int] = None
    # prefill through the pool and K6 instead of a dense scratch cache
    pool_prefill: bool = False
    device: Any = dataclasses.field(default=None, kw_only=True)
    # whether submit takes repetition/presence/frequency penalties (a
    # subclass whose steps keep no output counts says no)
    supports_penalties = True

    def __post_init__(self):
        cfg = self.config
        family = family_of(cfg)
        # positions past a request's budget that decode may write: 1
        self._tail = 1
        self.forward = self.forward or family.forward
        self.init_cache = self.init_cache or family.init_cache
        self._cache_config = cfg
        self._group = None
        if self.mesh is not None:
            self.params, self.params_specs, self.forward, self._cache_config = tp_engine_setup(
                self.params, cfg, self.mesh, self.params_specs, self.forward)
            self.device = self.mesh.device
            self._group = self.mesh.reduce_group
        self.device = resolve_device(self.device)
        bs = self.block_size
        if self.max_len % bs:
            raise ValueError(f"max_len {self.max_len} % block {bs} != 0")
        self.max_blocks = self.max_len // bs
        shape = (self.num_blocks, self._cache_config.num_kv_heads, bs, cfg.head_dim)
        dev = self.device
        self._kp = [torch.zeros(shape, dtype=cfg.dtype, device=dev) for _ in range(cfg.num_layers)]
        self._vp = [torch.zeros(shape, dtype=cfg.dtype, device=dev) for _ in range(cfg.num_layers)]
        self._tables = np.zeros((self.num_slots, self.max_blocks), np.int32)
        self._lengths = np.zeros((self.num_slots,), np.int32)
        self._free = list(range(self.num_blocks - 1, 0, -1))  # block 0 is the trash block
        self._slot_blocks: list[list[int]] = [[] for _ in range(self.num_slots)]
        self._slot_req: list[Optional[int]] = [None] * self.num_slots
        self._budget: dict[int, int] = {}
        self._out: dict[int, list] = {}
        self._out_lp: dict[int, list] = {}
        self.finished_logprobs: dict[int, list] = {}
        self._last = np.zeros((self.num_slots,), np.int64)
        self._temp = np.zeros((self.num_slots,), np.float32)
        self._top_k = np.zeros((self.num_slots,), np.int32)
        self._top_p = np.ones((self.num_slots,), np.float32)
        self._seeds = np.zeros((self.num_slots,), np.int64)
        self._stop: list[frozenset] = [frozenset()] * self.num_slots
        self._pres = np.zeros((self.num_slots,), np.float32)
        self._freq = np.zeros((self.num_slots,), np.float32)
        self._rep = np.ones((self.num_slots,), np.float32)
        v = cfg.vocab_size
        self._pcounts = torch.zeros((self.num_slots, v), dtype=torch.int32, device=dev)
        self._ocounts = torch.zeros((self.num_slots, v), dtype=torch.int32, device=dev)
        self._gen_count = np.zeros((self.num_slots,), np.int64)
        self._queue: list = []
        self._next_rid = 0
        self._finished: dict[int, list] = {}
        # prefix cache: tuple(prompt[:i*bs]) -> pool row (LRU order), and
        # the number of live readers of each pool row
        self._prefix_map: "OrderedDict[tuple, int]" = OrderedDict()
        self._refs = np.zeros((self.num_blocks,), np.int64)
        self._slot_shared: list[list[int]] = [[] for _ in range(self.num_slots)]
        self._slot_prompt: list[Optional[list]] = [None] * self.num_slots
        self.prefix_hits = 0  # requests that reused >= 1 cached block
        self.prefix_block_hits = 0  # blocks shared by reference in all
        self._pool_fwd = make_paged_multitoken_forward(cfg, bs) if self.pool_prefill else None
        # the decode step's inputs, at fixed addresses for its graph
        self._step_tables = torch.zeros((self.num_slots, self.max_blocks), dtype=torch.int32,
                                        device=dev)
        self._step_lengths = torch.zeros((self.num_slots,), dtype=torch.int32, device=dev)
        self._step_tokens = torch.zeros((self.num_slots, 1), dtype=torch.int64, device=dev)
        self._graph = None if not self.graphed else StepGraph(lambda: self._decode_logits(
            self._step_tables, self._step_lengths, self._step_tokens), dev)

    @property
    def graphed(self) -> bool:
        """Whether the steps are captured in CUDA graphs: on CUDA, without a
        mesh (a TP step runs eagerly)."""
        return self.device.type == "cuda" and self.mesh is None

    # -- steps ---------------------------------------------------------------

    @torch.inference_mode()
    def _decode_logits(self, tables: torch.Tensor, lengths: torch.Tensor,
                       tokens: torch.Tensor) -> torch.Tensor:
        """One eager paged T = 1 forward for every slot (inactive slots
        compute on junk at length 0 on the trash block); returns f32 logits
        ``[B, V]``."""
        cfg = self.config
        bs = self.block_size
        b = tokens.shape[0]
        x = embed(self.params, cfg, tokens)  # [B, 1, hidden]
        lengths = lengths.long()
        cos, sin = rope_tables(cfg, lengths[:, None])
        ar = torch.arange(b, device=tokens.device)
        rows = tables[ar, torch.clamp(lengths // bs, max=self.max_blocks - 1)].long()
        offs = lengths % bs
        att_len = lengths + 1

        def attend(li, q, k, v):
            # this token's K/V at (pool row, offset) of each slot, then attend
            self._kp[li][rows, :, offs, :] = k[:, 0].to(self._kp[li].dtype)
            self._vp[li][rows, :, offs, :] = v[:, 0].to(self._vp[li].dtype)
            return paged_decode_attention(q[:, 0], self._kp[li], self._vp[li], tables,
                                          att_len, **attention_options(cfg, li))[:, None]

        x = decoder_layers(self.params, cfg, x, cos, sin, attend, self._group)
        return _head_logits(self.params, cfg, x, None)[:, -1]

    def _step_logits(self) -> torch.Tensor:
        """The decode step's f32 logits ``[B, V]`` from the host's tables,
        lengths and last tokens, copied into the step's buffers: on CUDA the
        step's graph (captured at its first call, which runs eagerly;
        the returned logits are overwritten by the next step), elsewhere
        :meth:`_decode_logits`."""
        self._step_tables.copy_(torch.from_numpy(self._tables))
        self._step_lengths.copy_(torch.from_numpy(self._lengths))
        self._step_tokens.copy_(torch.from_numpy(self._last[:, None]))
        if self._graph is None:
            return self._decode_logits(self._step_tables, self._step_lengths, self._step_tokens)
        return self._graph()

    @torch.inference_mode()
    def _decode(self, greedy: bool):
        """A decode step for every slot: tokens [B] and the logprobs of the
        raw distribution, on the host."""
        nxt, lp = sample_step(self._step_logits(), self._pcounts, self._ocounts,
                              torch.from_numpy(self._pres), torch.from_numpy(self._freq),
                              torch.from_numpy(self._rep), self._temp, self._top_k,
                              self._top_p, self._seeds, self._gen_count, greedy)
        return nxt.cpu().numpy(), lp.cpu().numpy()

    # -- admission / bookkeeping -------------------------------------------

    def submit(
        self,
        prompt: Sequence[int],
        max_new_tokens: int = 32,
        sampling: Optional[SamplingParams] = None,
        **sampling_kw,
    ) -> int:
        """Queue a request. Per-request sampling: a SamplingParams, or
        temperature=/top_k=/top_p=/seed=/... keywords (default greedy)."""
        if len(prompt) + max_new_tokens + self._tail > self.max_len:
            raise ValueError(
                f"prompt {len(prompt)} + budget {max_new_tokens} exceeds max_len {self.max_len}"
            )
        need = self._blocks_needed(len(prompt) + max_new_tokens + self._tail)
        if need > self.num_blocks - 1:
            raise ValueError(f"request needs {need} blocks; pool has {self.num_blocks - 1}")
        if sampling is None:
            sampling = SamplingParams(**sampling_kw)
        elif sampling_kw:
            raise ValueError("pass either sampling= or keyword params, not both")
        if sampling.has_penalties and not self.supports_penalties:
            raise ValueError(
                "repetition/presence/frequency penalties are not supported by this engine "
                "(speculative verify does not track output counts); use PagedEngine or "
                "ContinuousBatchingEngine"
            )
        rid = self._next_rid
        self._next_rid += 1
        self._queue.append((rid, list(prompt), max_new_tokens, sampling))
        return rid

    def _blocks_needed(self, total_len: int) -> int:
        return -(-total_len // self.block_size)

    def _evictable(self) -> int:
        return sum(1 for r in self._prefix_map.values() if self._refs[r] == 0)

    def _evict_one(self) -> bool:
        """Free the least recently used unreferenced cached block."""
        for key, row in self._prefix_map.items():
            if self._refs[row] == 0:
                del self._prefix_map[key]
                self._free.append(row)
                return True
        return False

    def _take_blocks(self, n: int) -> Optional[list[int]]:
        """Pop ``n`` pool blocks, evicting cached blocks as needed; None when
        the pool cannot supply them (pool pressure)."""
        if len(self._free) + self._evictable() < n:
            return None
        while len(self._free) < n:
            self._evict_one()
        return [self._free.pop() for _ in range(n)]

    def _trim_cache(self):
        while len(self._prefix_map) > self.prefix_cache_blocks and self._evict_one():
            pass

    def _find_shared(self, prompt: list) -> list[int]:
        """Pool rows of the longest cached run over a proper prefix of
        ``prompt`` (at least one token must remain to prefill)."""
        bs = self.block_size
        shared = []
        for i in range(1, (len(prompt) - 1) // bs + 1):
            row = self._prefix_map.get(tuple(prompt[: i * bs]))
            if row is None:
                break
            shared.append(row)
        return shared

    def _admit(self):
        bs = self.block_size
        for slot in range(self.num_slots):
            if self._slot_req[slot] is not None or not self._queue:
                continue
            rid, prompt, budget, sampling = self._queue[0]
            plen = len(prompt)
            nb_total = self._blocks_needed(plen + budget + self._tail)
            shared = self._find_shared(prompt) if self.prefix_cache_blocks else []
            # pin shared rows before taking blocks: eviction takes unpinned ones
            for row in shared:
                self._refs[row] += 1
            own = self._take_blocks(nb_total - len(shared))
            if own is None:
                for row in shared:
                    self._refs[row] -= 1
                return  # pool pressure: wait for a slot to free
            self._queue.pop(0)
            for i in range(len(shared)):
                self._prefix_map.move_to_end(tuple(prompt[: (i + 1) * bs]))
            if shared:
                self.prefix_hits += 1
                self.prefix_block_hits += len(shared)
            blocks = shared + own
            self._slot_shared[slot] = list(shared)
            self._slot_blocks[slot] = own
            self._slot_prompt[slot] = list(prompt)
            self._tables[slot, :] = 0
            self._tables[slot, : len(blocks)] = blocks
            self._slot_req[slot] = rid
            self._budget[rid] = budget
            self._out[rid] = []
            self._out_lp[rid] = []
            self._temp[slot] = sampling.temperature
            self._top_k[slot] = sampling.top_k
            self._top_p[slot] = sampling.top_p
            self._seeds[slot] = sampling.seed
            self._stop[slot] = frozenset(sampling.stop_token_ids)
            self._pres[slot] = sampling.presence_penalty
            self._freq[slot] = sampling.frequency_penalty
            self._rep[slot] = sampling.repetition_penalty

            if self.pool_prefill:
                last_row = self._prefill_pool(slot, prompt, len(shared) * bs)
            else:
                last_row = self._prefill_dense(prompt, shared, blocks)
            self._start(slot, prompt, sampling, last_row)

    @torch.inference_mode()
    def _prefill_pool(self, slot: int, prompt: list, p0: int) -> torch.Tensor:
        """Prefill ``prompt[p0:]`` through the pool in chunks (K6); returns
        the last prompt token's f32 logits ``[V]``."""
        bs = self.block_size
        dev = self.device
        chunk = self.prefill_chunk or 256
        suffix = np.asarray(prompt[p0:], np.int64)
        rem = len(suffix)
        table_row = torch.from_numpy(self._tables[slot][None]).to(dev)
        real_end = torch.tensor([len(prompt)], device=dev)
        c0 = 0
        while c0 < rem:
            m = min(chunk, rem - c0)
            tb = bs
            while tb < m:
                tb *= 2
            toks = np.full((1, tb), self.pad_id, np.int64)
            toks[0, :m] = suffix[c0:c0 + m]
            logits, _, _ = self._pool_fwd(
                self.params, self._kp, self._vp, table_row,
                torch.tensor([p0 + c0], device=dev), torch.from_numpy(toks).to(dev),
                real_end=real_end, last_idx=m - 1, group=self._group,
            )
            c0 += m
        return logits[0, 0].float()

    @torch.inference_mode()
    def _prefill_dense(self, prompt: list, shared: list[int], blocks: list[int]) -> torch.Tensor:
        """Prefill the non-shared suffix with the dense model into a bucketed
        scratch cache (shared pool blocks spliced in first so the suffix
        attends to them), then scatter the new whole blocks into the pool.
        RoPE'd K is position-absolute, so reusing a block at the same
        positions is exact. Returns the last prompt token's f32 logits."""
        bs = self.block_size
        dev = self.device
        plen = len(prompt)
        nsh = len(shared)
        p0 = nsh * bs
        rem = plen - p0
        chunk = self.prefill_chunk
        # the calls: (start, tokens, real tokens); right padding is causally
        # masked and lies past the length, so paged attention never reads it
        if chunk is None or rem <= chunk:
            calls = [(p0, prompt[p0:], _bucket(rem, bs))]
        else:
            full = (rem // chunk) * chunk
            calls = [(p0 + c0, prompt[p0 + c0:p0 + c0 + chunk], chunk)
                     for c0 in range(0, full, chunk)]
            if rem > full:
                calls.append((p0 + full, prompt[p0 + full:], _bucket(rem - full, bs)))
        # the scratch holds every written slot (at least the prompt's bucket)
        csize = _bucket(max(plen, max(s + w for s, _, w in calls)), bs)
        scratch = self.init_cache(self._cache_config, 1, csize, device=dev)
        if shared:
            rows = torch.tensor(shared, device=dev)
            for li in range(self.config.num_layers):
                for name, pool in (("k", self._kp), ("v", self._vp)):
                    blk = pool[li][rows]  # [nsh, Hkv, bs, D]
                    flat = blk.transpose(0, 1).reshape(1, blk.shape[1], nsh * bs, blk.shape[3])
                    scratch[name][li][:, :, :nsh * bs] = flat.to(scratch[name][li].dtype)
        for start, toks, width in calls:
            t = np.full((1, width), self.pad_id, np.int64)
            t[0, :len(toks)] = toks
            logits, scratch = self.forward(self.params, self.config,
                                           torch.from_numpy(t).to(dev), scratch, start)
            last_row = logits[0, len(toks) - 1].float()
        new_rows = blocks[nsh:self._blocks_needed(plen)]
        m = len(new_rows)
        rows = torch.tensor(new_rows, device=dev)
        for li in range(self.config.num_layers):
            for src, pool in ((scratch["k"][li], self._kp[li]), (scratch["v"][li], self._vp[li])):
                seg = src[0, :, nsh * bs:(nsh + m) * bs, :]
                hkv, _, d = seg.shape
                pool[rows] = seg.reshape(hkv, m, bs, d).transpose(0, 1).to(pool.dtype)
        return last_row

    @torch.inference_mode()
    def _start(self, slot: int, prompt: list, sampling: SamplingParams, last_row: torch.Tensor):
        """Draw the first token, reset the slot's counts, record it."""
        if sampling.has_penalties:
            srow, _, pbins = _first_token_row(
                last_row.cpu().numpy(), prompt, sampling, self.config.vocab_size)
            srow = torch.from_numpy(srow).to(self.device)
        else:
            pbins, srow = None, last_row
        first, first_lp = sample_first(srow, sampling, last_row)
        if pbins is None:
            self._pcounts[slot] = 0
        else:
            self._pcounts[slot] = torch.from_numpy(pbins).to(self.device)
        self._ocounts[slot] = 0
        self._ocounts[slot, first] = 1
        self._lengths[slot] = len(prompt)
        self._gen_count[slot] = 1  # the next decode draw is generation 1
        self._record(slot, first, first_lp)

    def _record(self, slot: int, tok: int, lp: Optional[float] = None):
        rid = self._slot_req[slot]
        if (self.eos_id is not None and tok == self.eos_id) or tok in self._stop[slot]:
            self._finish(slot)
            return
        self._out[rid].append(tok)
        if lp is not None:
            self._out_lp[rid].append(lp)
        self._last[slot] = tok
        if self.token_callback is not None:
            self.token_callback(rid, tok)
        if len(self._out[rid]) >= self._budget[rid]:
            self._finish(slot)

    def _finish(self, slot: int):
        rid = self._slot_req[slot]
        self._finished[rid] = self._out.pop(rid)
        self.finished_logprobs[rid] = self._out_lp.pop(rid, [])
        bs = self.block_size
        for row in self._slot_shared[slot]:
            self._refs[row] -= 1
        # prompt-only owned blocks go to the prefix cache (unreferenced,
        # shareable, first to be evicted); the rest are freed
        prompt = self._slot_prompt[slot] or []
        plen = len(prompt)
        nshare = len(self._slot_shared[slot])
        for gi0, row in enumerate(self._slot_blocks[slot]):
            end = (nshare + gi0 + 1) * bs
            key = tuple(prompt[:end]) if end <= plen else None
            if self.prefix_cache_blocks and key is not None and key not in self._prefix_map:
                self._prefix_map[key] = row
            else:
                self._free.append(row)
        if self.prefix_cache_blocks:
            self._trim_cache()
        self._slot_blocks[slot] = []
        self._slot_shared[slot] = []
        self._slot_prompt[slot] = None
        self._slot_req[slot] = None
        self._stop[slot] = frozenset()
        # park the slot on the trash block at length 0
        self._tables[slot, :] = 0
        self._lengths[slot] = 0

    @property
    def blocks_in_use(self) -> int:
        """Blocks held by live requests (not the trash block, not idle
        cached prefix blocks)."""
        return self.num_blocks - 1 - len(self._free) - self._evictable()

    def step(self) -> bool:
        self._admit()
        active = [s for s in range(self.num_slots) if self._slot_req[s] is not None]
        if not active:
            return bool(self._queue)
        nxt, lp = self._decode(greedy=all(self._temp[s] <= 0 for s in active))
        for s in active:
            self._lengths[s] += 1
            self._gen_count[s] += 1
            self._record(s, int(nxt[s]), float(lp[s]))
        return True

    def run(self) -> dict[int, list]:
        while self.step():
            pass
        out, self._finished = self._finished, {}
        return out
