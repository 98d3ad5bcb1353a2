"""Speculative decoding over the paged KV pool, counterpart of
``flute_tpu/serving/paged_spec.py``.

The target lives in the block pool of ``serving/paged.py``; a draft model
proposes k tokens per round from a dense per-slot cache.

* Paged multi-token verify: the T = k+1 verify forward
  (``paged_fwd.make_paged_multitoken_forward``) writes all k+1 K/V entries
  into their (pool row, offset) homes, then runs the multi-query paged
  kernel (K6, ``ops.paged_attention.paged_verify_attention``): slot b's
  query j attends ``lengths[b] + j + 1`` positions, so causality across the
  proposed run follows from per-row lengths.
* Rejection junk stays in owned blocks: a verify writes k positions past
  the accepted point, so admission reserves ``blocks_needed(plen + budget +
  k + 1)`` (``_tail``); the junk lands in the slot's own blocks and the
  next verify overwrites it before it can be attended. Shared prefix blocks
  are never written: writes start at ``lengths >= plen``.
* The draft's cache is dense, ``[num_slots, Hkv, C, D]`` per layer with C
  the next power of two >= ``max_len``; admission prefills the whole
  prompt into a scratch cache and splices it into the slot's row.
* The round is the dense engine's (``speculative.SpeculativeRounds``):
  greedy and sampled slots share it, greedy slots accepting by argmax
  match and sampled slots by the modified-rejection step; a bonus token on
  full acceptance, with the catch-up fill.

On CUDA the draft's T = 1 step (one graph replayed for the catch-up and
the k proposals) and the paged T = k+1 verify are each captured once in a
CUDA graph over fixed buffers (the block tables, lengths and tokens); the
proposals stay on the device and the host reads the round's results once,
after the verify. Admission (prefill) runs eagerly.

Llama and Gemma-2, for target and draft independently (the vocabulary
must match). Penalties are refused at submit (``supports_penalties``): the
rounds keep no output counts.

Under a ``mesh`` (as ``PagedEngine`` takes it) the draft runs
tensor-parallel too: its params are sharded like the target's (fused
draft params permuted rank-major the same way), its dense cache holds this
rank's KV heads, and the draft steps and the verify run eagerly.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from flute_tpu_torch.parallel.tp import tp_engine_setup
from flute_tpu_torch.serving.continuous import family_of
from flute_tpu_torch.serving.graph import StepGraph
from flute_tpu_torch.serving.paged import PagedEngine
from flute_tpu_torch.serving.paged_fwd import make_paged_multitoken_forward
from flute_tpu_torch.serving.speculative import (
    SpecStats,
    SpeculativeRounds,
    host_to,
    make_accept_fn,
)


@dataclasses.dataclass
class PagedSpeculativeEngine(SpeculativeRounds, PagedEngine):
    """PagedEngine with a draft model proposing k tokens per round.

    The block pool, prefix-block sharing, per-request sampling, both
    prefill routes and the streaming callback carry over; the decode step
    is replaced by draft-propose / paged-verify rounds. ``draft_params``,
    ``draft_config`` and ``k`` follow :class:`PagedEngine`'s fields, as in
    JAX; ``device`` is keyword-only.
    """

    draft_params: Any = None
    draft_config: Any = None
    k: int = 4
    supports_penalties = False  # verify rounds keep no output counts

    def __post_init__(self):
        if self.draft_params is None or self.draft_config is None:
            raise ValueError("draft_params and draft_config are required")
        if self.k < 1:
            raise ValueError(f"k must be >= 1, got {self.k}")
        dfam = family_of(self.draft_config)
        super().__post_init__()
        self._tail = 1 + self.k  # a verify writes k past the accepted point
        cols = 1
        while cols < self.max_len:
            cols *= 2
        n, dev = self.num_slots, self.device
        self._dfwd, self._dinit = dfam.forward, dfam.init_cache
        self._d_cache_config = self.draft_config
        if self.mesh is not None:
            self.draft_params, _, self._dfwd, self._d_cache_config = tp_engine_setup(
                self.draft_params, self.draft_config, self.mesh, forward=dfam.forward)
        self._d_cache = self._dinit(self._d_cache_config, n, cols, device=dev)
        self._d_pos = np.zeros((n,), np.int64)
        self._d_ready = np.zeros((n,), bool)
        self._pending = np.full((n,), -1, np.int64)
        self.stats = SpecStats()
        self._accept = make_accept_fn(self.k)
        self._verify_fwd = make_paged_multitoken_forward(self.config, self.block_size)
        # the draft and verify steps' inputs, at fixed addresses for their
        # graphs (the verify also reads the parent's tables and lengths)
        self._d_tok = torch.zeros((n, 1), dtype=torch.int64, device=dev)
        self._d_pos_buf = torch.zeros((n,), dtype=torch.int64, device=dev)
        self._v_toks = torch.zeros((n, self.k + 1), dtype=torch.int64, device=dev)
        self._draft_graph = StepGraph(lambda: self._draft_logits(
            self._d_tok, self._d_pos_buf), dev) if self.graphed else None
        self._verify_graph = StepGraph(lambda: self._verify_logits(
            self._step_tables, self._step_lengths, self._v_toks), dev) if self.graphed else None

    # -- steps ---------------------------------------------------------------

    @torch.inference_mode()
    def _draft_logits(self, tok: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
        """The draft's eager T = 1 step for every slot at its own position:
        f32 logits ``[B, V]``."""
        logits, _ = self._dfwd(self.draft_params, self.draft_config, tok, self._d_cache, pos)
        return logits[:, -1]

    @torch.inference_mode()
    def _verify_logits(self, tables: torch.Tensor, lengths: torch.Tensor,
                       toks: torch.Tensor) -> torch.Tensor:
        """The target's eager paged T = k+1 step (K6) for every slot: f32
        logits ``[B, k+1, V]``."""
        return self._verify_fwd(self.params, self._kp, self._vp, tables, lengths, toks,
                                group=self._group)[0]

    def _draft_step(self) -> torch.Tensor:
        if self._draft_graph is None:
            return self._draft_logits(self._d_tok, self._d_pos_buf)
        return self._draft_graph()

    def _verify_step(self) -> torch.Tensor:
        if self._verify_graph is None:
            return self._verify_logits(self._step_tables, self._step_lengths, self._v_toks)
        return self._verify_graph()

    # -- admission / teardown hooks ------------------------------------------

    @torch.inference_mode()
    def _admit(self):
        super()._admit()
        # the draft prefills the whole prompt of each slot just admitted (it
        # has no share in the pool's prefix cache); junk past the prompt in
        # its row is overwritten by draft steps before it can be attended
        for s in range(self.num_slots):
            if self._slot_req[s] is None or self._d_ready[s]:
                continue
            prompt = self._slot_prompt[s]
            plen = len(prompt)
            tb = self.block_size
            while tb < plen:
                tb *= 2
            toks = np.full((1, tb), self.pad_id, np.int64)
            toks[0, :plen] = prompt
            scratch = self._dinit(self._d_cache_config, 1, tb, device=self.device)
            self._dfwd(self.draft_params, self.draft_config,
                       torch.from_numpy(toks).to(self.device), scratch, 0)
            for kv in ("k", "v"):
                for big, small in zip(self._d_cache[kv], scratch[kv]):
                    big[s, :, :plen] = small[0, :, :plen]
            self._d_pos[s] = plen
            self._pending[s] = -1
            self._d_ready[s] = True

    def _finish(self, slot: int):
        super()._finish(slot)
        self._d_ready[slot] = False
        self._pending[slot] = -1
        self._d_pos[slot] = 0

    # -- the speculative round -----------------------------------------------

    @torch.inference_mode()
    def step(self) -> bool:
        self._admit()
        active = [s for s in range(self.num_slots) if self._slot_req[s] is not None]
        if not active:
            return bool(self._queue)
        # the verify's block tables and lengths
        self._step_tables.copy_(host_to(self.device, self._tables))
        self._step_lengths.copy_(host_to(self.device, self._lengths))
        emitted = self._round(active, self._last, self._pending, self._d_pos,
                              (self._temp, self._top_k, self._top_p, self._seeds,
                               self._gen_count))
        for s, toks in emitted.items():
            self._lengths[s] += len(toks)
            self._gen_count[s] += len(toks)
            for tkn in toks:
                self._record(s, tkn)
                if self._slot_req[s] is None:
                    break  # eos, a stop token or the budget, mid-run
        return True
