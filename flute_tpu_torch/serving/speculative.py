"""Speculative decoding: a draft model proposes k tokens, the target
verifies them in one T = k+1 forward; counterpart of
``flute_tpu/serving/speculative.py``.

* Greedy acceptance: proposal j is accepted while it equals the target's
  argmax at verify position j; the first mismatch is replaced by the
  target's own argmax (the correction). The emitted stream is the target's
  greedy choice under its verify forward: a draft costs speed, never output.
* Speculative sampling (``generate(..., sampling=...)``): the draft samples
  x_j from its warped distribution q_j, the target accepts x_j while
  u_j < p_j(x_j) / q_j(x_j) and on the first rejection draws the correction
  from the normalised max(p_j - q_j, 0) (:func:`make_accept_fn`), so the
  emitted stream is distributed as target sampling. The same warp
  (``continuous._warp_logits``) shapes p and q.
* Bonus token: when all k proposals are accepted, the verify's position-k
  output is emitted too (greedily its argmax, sampled a draw from p_k with
  the plain engines' generator for that count), so a perfect round yields
  k+1 tokens. The draft is then a token behind; the next round starts with
  one T = 1 catch-up fill of the draft, in which slots without a straggler
  are fed a duplicate whose junk K/V the next write overwrites first.
* Junk K/V: rejected proposals leave K/V past the accepted point. Each
  later step writes its K/V before attending, and the causal mask admits
  only positions up to the query's, so junk is overwritten before it can
  be attended.

Randomness is the port's keyed scheme (``continuous.request_generator``):
a proposal at generation index c takes the plain engines' generator for
(seed, c); the uniform u_j folds tag 1 into (seed, c + j), the residual
draw tag 2 into (seed, c + a). So where the draft's q and the verify's p
have the same bits, every proposal is accepted and the stream is the plain
engines' sampled stream.

On CUDA the draft's T = 1 step (one graph, replayed for the catch-up fill
and the k proposals) and the target's T = k+1 verify step are each captured
once in a CUDA graph (``serving.graph.StepGraph``) over fixed input
buffers; the proposals stay on the device through the round and the host
reads the round's results once, after the verify. Prefill runs eagerly;
sampling and acceptance run outside the graphs.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional, Sequence

import numpy as np
import torch

from flute_tpu_torch.device import resolve_device
from flute_tpu_torch.serving.continuous import (
    SamplingParams,
    _gumbel_argmax,
    _warp_logits,
    family_of,
    request_generator,
)
from flute_tpu_torch.serving.graph import StepGraph


@dataclasses.dataclass
class SpecStats:
    rounds: int = 0
    proposed: int = 0
    accepted: int = 0
    bonus: int = 0  # extra tokens emitted on fully accepted rounds

    @property
    def acceptance_rate(self) -> float:
        return self.accepted / self.proposed if self.proposed else 0.0


def make_accept_fn(k: int) -> Callable:
    """The modified-rejection step of both speculative engines:
    ``accept(seeds, gen, proposals, p_logits, q_logits) -> (a, correction,
    bonus)``, each ``[B]`` int64 on the logits' device, every draw keyed on
    ``continuous.ENGINE_KEY``.

    ``seeds`` and ``gen`` are each slot's request seed and tokens generated
    so far (host ints); ``proposals`` ``[B, k]``; ``p_logits`` ``[B, k+1, V]``
    the target's warped logits after each verify input (row k is the bonus
    distribution) and ``q_logits`` ``[B, k, V]`` the draft's: their softmax is
    p and q. Proposal j is accepted while u_j < p_j(x_j) / q_j(x_j); a is the
    number accepted. The correction (valid when a < k) is drawn from the
    normalised max(p_a - q_a, 0), or from p_a where that mass is <= 1e-12;
    the bonus (valid when a == k) from p_k with the plain engines' generator
    for count gen + k, the same draw as ``continuous._sample_row``. Every
    draw is made on the device; the host waits for nothing."""

    def accept(seeds: Sequence[int], gen: Sequence[int], proposals: torch.Tensor,
               p_logits: torch.Tensor, q_logits: torch.Tensor):
        dev = p_logits.device
        p = torch.softmax(p_logits.float(), dim=-1)  # [B, k+1, V]
        q = torch.softmax(q_logits.float(), dim=-1)  # [B, k, V]
        props = proposals.long()[..., None]
        px = torch.gather(p[:, :k], 2, props)[..., 0]
        qx = torch.gather(q, 2, props)[..., 0].clamp_min(1e-30)
        slots = [(int(s), int(g)) for s, g in zip(seeds, gen)]
        u = torch.stack([
            torch.stack([torch.rand((), generator=request_generator(dev, s, g + j, 1), device=dev)
                         for j in range(k)])
            for s, g in slots])
        acc = u < px / qx
        a = torch.cumprod(acc.long(), dim=-1).sum(dim=-1)
        res = (p[:, :k] - q).clamp_min(0.0)
        mass = res.sum(dim=-1, keepdim=True)
        res = torch.where(mass > 1e-12, res / mass, p[:, :k])
        logres = torch.log(res.clamp_min(1e-30))
        # the correction at each place a rejection could be (the draw for
        # place i keyed on count g + i, tag 2), then the one at a
        corr_all = torch.stack([
            torch.stack([_gumbel_argmax(logres[i, j], request_generator(dev, s, g + j, 2))
                         for j in range(k)])
            for i, (s, g) in enumerate(slots)])
        corr = torch.gather(corr_all, 1, a.clamp(max=k - 1)[:, None])[:, 0]
        bonus = torch.stack([_gumbel_argmax(p_logits[i, k].float(),
                                            request_generator(dev, s, g + k))
                             for i, (s, g) in enumerate(slots)])
        return a, corr, bonus

    return accept


def warp_rows(logits: torch.Tensor, temperature, top_k, top_p) -> torch.Tensor:
    """``continuous._warp_logits`` on each row of ``logits`` ``[B, ..., V]``
    with row b's settings."""
    return torch.stack([
        torch.stack([_warp_logits(r, float(temperature[i]), int(top_k[i]), float(top_p[i]))
                     for r in logits[i].reshape(-1, logits.shape[-1])]).reshape(logits[i].shape)
        for i in range(logits.shape[0])])


def propose(row: torch.Tensor, temperature, top_k, top_p, seeds, counts):
    """Sampled proposals from the draft's f32 logits ``row`` ``[B, V]``:
    the warped rows (q's logits) and, per slot, a draw from them with the
    plain engines' generator for (seed, count), or the argmax of the raw row
    where the temperature is <= 0."""
    warped = warp_rows(row, temperature, top_k, top_p)
    nxt = torch.stack([
        _gumbel_argmax(warped[i], request_generator(row.device, int(seeds[i]), int(counts[i])))
        if temperature[i] > 0 else torch.argmax(row[i])
        for i in range(row.shape[0])])
    return nxt, warped


def host_to(dev: torch.device, arr: np.ndarray) -> torch.Tensor:
    """``arr`` on ``dev``, copied without a wait: on CUDA from pinned
    memory, asynchronously (a copy from pageable memory synchronises the
    stream)."""
    t = torch.from_numpy(arr)
    return t.pin_memory().to(dev, non_blocking=True) if dev.type == "cuda" else t


class SpeculativeRounds:
    """The round both speculative engines run. An engine provides ``k``,
    ``device``, ``stats``, ``_accept``, the step buffers ``_d_tok``
    ``[B, 1]``, ``_d_pos_buf`` ``[B]`` and ``_v_toks`` ``[B, k+1]``, and the
    steps ``_draft_step()`` (T = 1 at ``_d_pos_buf``) and ``_verify_step()``
    (T = k+1 at the positions the engine set before the round)."""

    def _round(self, active, last, pending, d_pos, sampling=None) -> dict:
        """One round for the slots in ``active``: the catch-up fill of the
        slots with a straggler (``pending >= 0``), k draft steps from
        ``last``, the verify, and each slot's acceptance: a greedy slot (all
        of them when ``sampling`` is None) by argmax match, a slot whose
        temperature in ``sampling = (temperature, top_k, top_p, seeds,
        counts)`` is > 0 by the modified-rejection step. The host waits once,
        after the verify. Updates ``pending``, ``d_pos`` and ``stats`` in
        place; returns each active slot's emitted tokens, the accepted
        proposals then the correction (a + 1) or the bonus (k + 1): the
        target's cache advances by as many."""
        k, dev = self.k, self.device
        has = pending >= 0
        # the round's host state in one copy
        state = host_to(dev, np.stack([np.where(has, pending, last), has.astype(np.int64), last,
                                       d_pos]))
        self._d_pos_buf.copy_(state[3])
        if has.any():  # the catch-up fill; its logits are not read
            self._d_tok[:, 0] = state[0]
            self._draft_step()
            self._d_pos_buf += state[1]
            d_pos += has
            pending[:] = -1
        self._d_tok[:, 0] = state[2]
        sampled = sampling is not None and any(sampling[0][s] > 0 for s in active)
        if sampled:
            temp, top_k, top_p, seeds, counts = sampling
        props, q_rows = [], []
        for j in range(k):
            row = self._draft_step()
            if sampled:
                nxt, q_j = propose(row, temp, top_k, top_p, seeds, counts + j)
                q_rows.append(q_j)
            else:
                nxt = torch.argmax(row, dim=-1)
            props.append(nxt)
            if j < k - 1:
                self._d_tok[:, 0] = nxt
                self._d_pos_buf += 1
        proposals = torch.stack(props, dim=1)  # [B, k]
        self._v_toks[:, 0] = state[2]
        self._v_toks[:, 1:] = proposals
        vlogits = self._verify_step()
        res = [proposals, torch.argmax(vlogits, dim=-1)]
        if sampled:
            # greedy slots' rows are one-hot here; their results go unread
            p_rows = warp_rows(vlogits, temp, top_k, top_p)
            res += [r[:, None] for r in self._accept(seeds, counts, proposals, p_rows,
                                                     torch.stack(q_rows, dim=1))]
        res = torch.cat(res, dim=1).cpu().numpy()  # the round's one wait
        proposals_np, greedy = res[:, :k], res[:, k:2 * k + 1]
        emitted = {}
        for s in active:
            if sampled and temp[s] > 0:
                a, correction, bonus_tok = (int(x) for x in res[s, 2 * k + 1:])
            else:
                a = 0
                while a < k and proposals_np[s, a] == greedy[s, a]:
                    a += 1
                correction = int(greedy[s, min(a, k - 1)])
                bonus_tok = int(greedy[s, k])
            self.stats.proposed += k
            self.stats.accepted += a
            if a < k:
                emitted[s] = [int(t) for t in proposals_np[s, :a]] + [correction]
                d_pos[s] += a + 1
            else:
                # the draft still owes x_{k-1}: next round's catch-up
                emitted[s] = [int(t) for t in proposals_np[s, :k]] + [bonus_tok]
                d_pos[s] += k
                pending[s] = int(proposals_np[s, k - 1])
                self.stats.bonus += 1
        self.stats.rounds += 1
        return emitted


@dataclasses.dataclass
class SpeculativeEngine(SpeculativeRounds):
    """Speculative generation for a batch with a draft/target pair on dense
    KV caches, on ``device`` (``cuda`` unless named; params must live there).

    Both models share the vocabulary. The draft may be narrower or
    shallower, a more aggressively quantized copy of the target (W2 drafting
    for W4), or the target itself. ``forward``/``init_cache`` serve both
    models when given; otherwise each side's family's (Llama or Gemma-2).
    The caches are allocated at the first ``generate`` and zeroed at each
    later one, so the step graphs captured against them stay valid. The
    fields are the JAX engine's in its order; ``device`` is keyword-only.
    """

    target_params: Any
    target_config: Any
    draft_params: Any
    draft_config: Any
    k: int = 4  # proposals per round
    forward: Optional[Callable] = None
    init_cache: Optional[Callable] = None
    max_len: int = 1024
    batch_size: int = 8
    pad_id: int = 0
    device: Any = dataclasses.field(default=None, kw_only=True)

    def __post_init__(self):
        if self.k < 1:
            raise ValueError(f"k must be >= 1, got {self.k}")
        self.device = resolve_device(self.device)
        tfam, dfam = family_of(self.target_config), family_of(self.draft_config)
        self._t_fwd = self.forward or tfam.forward
        self._d_fwd = self.forward or dfam.forward
        self._t_init = self.init_cache or tfam.init_cache
        self._d_init = self.init_cache or dfam.init_cache
        self._accept = make_accept_fn(self.k)
        self.stats = SpecStats()
        self._t_cache: Optional[dict] = None
        self._d_cache: Optional[dict] = None
        b, dev = self.batch_size, self.device
        # the steps' inputs, at fixed addresses for their graphs
        self._offsets = torch.zeros((b,), dtype=torch.int64, device=dev)
        self._d_tok = torch.zeros((b, 1), dtype=torch.int64, device=dev)
        self._d_pos_buf = torch.zeros((b,), dtype=torch.int64, device=dev)
        self._v_toks = torch.zeros((b, self.k + 1), dtype=torch.int64, device=dev)
        self._t_pos = torch.zeros((b,), dtype=torch.int64, device=dev)
        cuda = dev.type == "cuda"
        self._draft_graph = StepGraph(lambda: self.draft_logits(
            self._d_tok, self._d_pos_buf, self._offsets), dev) if cuda else None
        self._verify_graph = StepGraph(lambda: self.verify_logits(
            self._v_toks, self._t_pos, self._offsets), dev) if cuda else None

    # -- steps ---------------------------------------------------------------

    @torch.inference_mode()
    def draft_logits(self, tok: torch.Tensor, pos: torch.Tensor,
                     offsets: torch.Tensor) -> torch.Tensor:
        """The draft's eager T = 1 step at per-slot cache slots ``pos``
        ``[B]``: f32 logits ``[B, V]``."""
        logits, _ = self._d_fwd(self.draft_params, self.draft_config, tok, self._d_cache, pos,
                                offsets)
        return logits[:, -1]

    @torch.inference_mode()
    def verify_logits(self, toks: torch.Tensor, pos: torch.Tensor,
                      offsets: torch.Tensor) -> torch.Tensor:
        """The target's eager T = k+1 step at per-slot cache slots ``pos``:
        f32 logits ``[B, k+1, V]``."""
        logits, _ = self._t_fwd(self.target_params, self.target_config, toks, self._t_cache, pos,
                                offsets)
        return logits

    def _draft_step(self) -> torch.Tensor:
        """The draft step on its buffers: its graph on CUDA (the output is
        overwritten by the next replay), else eager."""
        if self._draft_graph is None:
            return self.draft_logits(self._d_tok, self._d_pos_buf, self._offsets)
        return self._draft_graph()

    def _verify_step(self) -> torch.Tensor:
        if self._verify_graph is None:
            return self.verify_logits(self._v_toks, self._t_pos, self._offsets)
        return self._verify_graph()

    def _zeroed_caches(self):
        b = self.batch_size
        if self._t_cache is None:
            self._t_cache = self._t_init(self.target_config, b, self.max_len, device=self.device)
            self._d_cache = self._d_init(self.draft_config, b, self.max_len, device=self.device)
        else:
            for cache in (self._t_cache, self._d_cache):
                for layer in cache["k"] + cache["v"]:
                    layer.zero_()

    # -- generation ----------------------------------------------------------

    @torch.inference_mode()
    def generate(
        self,
        prompts: Sequence[Sequence[int]],
        max_new_tokens: int = 32,
        eos_id: Optional[int] = None,
        sampling: Optional[SamplingParams | Sequence[SamplingParams]] = None,
    ) -> list[list[int]]:
        """Generate greedily (``sampling=None``) or by speculative sampling
        (one SamplingParams for the batch or one per prompt). Penalties are
        refused: the verify keeps no output counts."""
        b, k, dev = self.batch_size, self.k, self.device
        if len(prompts) > b:
            raise ValueError(f"{len(prompts)} prompts > batch_size {b}")
        sampled = sampling is not None
        if sampled:
            if isinstance(sampling, SamplingParams):
                sampling = [sampling] * len(prompts)
            sampling = list(sampling)
            if any(s.has_penalties for s in sampling):
                raise ValueError("penalties are not supported by speculative decoding; use "
                                 "PagedEngine or ContinuousBatchingEngine")
            if len(sampling) != len(prompts):
                raise ValueError(f"{len(sampling)} sampling params for {len(prompts)} prompts")
            sampling += [SamplingParams()] * (b - len(sampling))
            temp = [s.temperature for s in sampling]
            top_k = [s.top_k for s in sampling]
            top_p = [s.top_p for s in sampling]
            seeds = [s.seed for s in sampling]
            gen = np.zeros((b,), np.int64)  # tokens sampled so far per slot
        stops = [frozenset(s.stop_token_ids) for s in sampling] if sampled else [frozenset()] * b
        plen = max(len(p) for p in prompts)
        bucket = 16
        while bucket < plen:
            bucket *= 2
        if bucket + max_new_tokens + k + 1 <= self.max_len:
            plen = bucket
        toks = np.full((b, plen), self.pad_id, np.int64)
        offsets = np.full((b,), plen, np.int64)
        for i, p in enumerate(prompts):
            toks[i, plen - len(p):] = p
            offsets[i] = plen - len(p)

        self._zeroed_caches()
        self._offsets.copy_(torch.from_numpy(offsets))
        toks_d = torch.from_numpy(toks).to(dev)
        logits, _ = self._t_fwd(self.target_params, self.target_config, toks_d, self._t_cache, 0,
                                self._offsets)
        row = logits[:, -1]
        if sampled:
            # the first token is draw 0 of each request's stream
            first = propose(row, temp, top_k, top_p, seeds, gen)[0]
            gen[:] = 1
        else:
            first = torch.argmax(row, dim=-1)
        self._d_fwd(self.draft_params, self.draft_config, toks_d, self._d_cache, 0,
                    self._offsets)
        last = first.cpu().numpy().astype(np.int64)

        out = [list() for _ in range(b)]
        done = np.zeros((b,), bool)
        done[len(prompts):] = True
        for i in range(len(prompts)):
            t = int(last[i])
            if (eos_id is not None and t == eos_id) or t in stops[i]:
                done[i] = True
            else:
                out[i].append(t)
        # the cache slot of each model's next write, and the straggler the
        # draft has not consumed yet (bonus rounds leave one; -1 = none)
        t_pos = np.full((b,), plen, np.int64)
        d_pos = np.full((b,), plen, np.int64)
        pending = np.full((b,), -1, np.int64)
        while not done.all():
            if int(t_pos.max()) + k + 1 > self.max_len:  # a verify writes through pos + k
                break
            self._t_pos.copy_(host_to(dev, t_pos))
            active = [i for i in range(len(prompts)) if not done[i]]
            emitted = self._round(active, last, pending, d_pos,
                                  (temp, top_k, top_p, seeds, gen) if sampled else None)
            for i, toks_i in emitted.items():
                last[i] = toks_i[-1]
                t_pos[i] += len(toks_i)
                if sampled:
                    gen[i] += len(toks_i)
                for t in toks_i:
                    if len(out[i]) >= max_new_tokens:
                        done[i] = True
                        break
                    if (eos_id is not None and t == eos_id) or t in stops[i]:
                        done[i] = True
                        break
                    out[i].append(t)
                if len(out[i]) >= max_new_tokens:
                    done[i] = True
        return [o[:max_new_tokens] for o in out[: len(prompts)]]
