"""Serving engine: prefill and decode steps and a batch generation loop;
counterpart of ``flute_tpu/serving/engine.py``.

Prompts are left-padded into one ``[B, P]`` block whose length is bucketed
to a power of two (at least 16), so one prefill serves every prompt length;
decode runs T=1 steps against the engine's KV cache, allocated once and
written in place. Finished sequences stay in the batch (masked on the
host), so shapes never change. On CUDA the decode step of ``generate`` is
captured once in a CUDA graph (``serving.graph.StepGraph``) and replayed,
as the reference compiles it with ``jax.jit``; prefill, whose length
varies, runs eagerly.

Tensor parallelism (``mesh``, a ``parallel.tp.Mesh``): every rank of the
mesh builds the same engine and makes the same calls; the engine serves
this rank's slices of the params (``parallel.tp.tp_engine_setup``) and
holds its KV heads, and the blocks' all-reduces give every rank the same
logits, so the same tokens. A TP step runs eagerly whatever the backend
(``graphed`` is False): a gloo all-reduce cannot be captured in a CUDA
graph.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Optional, Sequence

import numpy as np
import torch

from flute_tpu_torch.device import resolve_device
from flute_tpu_torch.models import llama
from flute_tpu_torch.parallel.tp import tp_engine_setup
from flute_tpu_torch.serving.graph import StepGraph


def sample_logits(
    logits: torch.Tensor,  # [B, V] float32
    temperature: float = 1.0,
    top_k: Optional[int] = None,
    top_p: Optional[float] = None,
    generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """Temperature / top-k / top-p (nucleus) sampling; greedy when
    temperature == 0. Randomness comes from ``generator``."""
    if temperature == 0.0:
        return torch.argmax(logits, dim=-1)
    logits = logits / temperature
    if top_k is not None:
        kth = torch.sort(logits, dim=-1).values[:, -top_k][:, None]
        logits = logits.masked_fill(logits < kth, float("-inf"))
    if top_p is not None:
        sorted_logits = torch.sort(logits, dim=-1, descending=True).values
        probs = torch.softmax(sorted_logits, dim=-1)
        cum = torch.cumsum(probs, dim=-1)
        # smallest set whose cumulative prob >= top_p; keep at least 1
        cutoff_idx = torch.sum(cum < top_p, dim=-1)
        cutoff = torch.gather(sorted_logits, -1, cutoff_idx[:, None])
        logits = logits.masked_fill(logits < cutoff, float("-inf"))
    probs = torch.softmax(logits, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0]


@dataclasses.dataclass
class Engine:
    """Prefill/decode wrapper around a model forward function.

    ``forward(params, config, tokens, cache, pos, offsets)`` is the model
    contract (that of :func:`flute_tpu_torch.models.llama.forward`). Runs
    on ``device`` (``cuda`` unless named); params must already live there.
    The KV cache is the engine's: each :meth:`prefill` zeroes and refills
    it, so the decode graph captured against it stays valid.

    ``mesh``: tensor-parallel serving on the mesh's device (fused params
    permuted rank-major first, ``parallel.permute_fused_params``);
    ``params_specs``: the specs to shard them with (default
    ``parallel.llama_partition_specs``).

    The fields are the JAX engine's in its order, ``(params, config,
    forward, init_cache, max_len, batch_size, pad_id, mesh,
    params_specs)``, so that its positional form binds the same names;
    ``device`` is keyword-only.
    """

    params: Any
    config: Any
    forward: Callable = llama.forward
    init_cache: Callable = llama.init_cache  # (config, batch, max_len, device=)
    max_len: int = 1024
    batch_size: int = 8
    pad_id: int = 0
    device: Any = dataclasses.field(default=None, kw_only=True)
    mesh: Any = None
    params_specs: Any = None

    def __post_init__(self):
        self._cache_config = self.config
        if self.mesh is not None:
            self.params, self.params_specs, self.forward, self._cache_config = tp_engine_setup(
                self.params, self.config, self.mesh, self.params_specs, self.forward)
            self.device = self.mesh.device
        self.device = resolve_device(self.device)
        # host-clock seconds of the last generate(): the prefill (up to the
        # first token on the host) and each decode step after it
        self.last_timings: dict = {}
        self._cache: Optional[dict] = None
        self._graph: Optional[StepGraph] = None

    def _zeroed_cache(self) -> dict:
        """The engine's cache, allocated at the first prefill and zeroed in
        place at every later one."""
        if self._cache is None:
            self._cache = self.init_cache(
                self._cache_config, self.batch_size, self.max_len, device=self.device
            )
        else:
            for layer in self._cache["k"] + self._cache["v"]:
                layer.zero_()
        return self._cache

    @torch.inference_mode()
    def prefill(self, tokens: torch.Tensor, offsets: torch.Tensor):
        """Logits of the last prompt slot [B, V] and the filled cache."""
        cache = self._zeroed_cache()
        logits, cache = self.forward(self.params, self.config, tokens, cache, 0, offsets)
        return logits[:, -1], cache

    @torch.inference_mode()
    def decode(self, tokens: torch.Tensor, cache: dict, pos, offsets: torch.Tensor):
        """One eager T=1 step at cache slot ``pos`` (an int or a 0-dim
        device tensor): logits [B, V] and the cache."""
        logits, cache = self.forward(self.params, self.config, tokens, cache, pos, offsets)
        return logits[:, -1], cache

    @property
    def graphed(self) -> bool:
        """Whether the decode step is captured in a CUDA graph: on CUDA,
        without a mesh."""
        return self.device.type == "cuda" and self.mesh is None

    def decode_step(self, tokens: torch.Tensor, pos: int, offsets: torch.Tensor) -> torch.Tensor:
        """The decode step of :meth:`generate` on the engine's cache: logits
        [B, V] of a T=1 step at slot ``pos``. When :attr:`graphed`, the
        step captured in a CUDA graph at its first call (which runs eagerly)
        and replayed: the returned logits are overwritten by the next step.
        Otherwise :meth:`decode`."""
        if not self.graphed:
            return self.decode(tokens, self._cache, pos, offsets)[0]
        if self._graph is None:
            b, dev = self.batch_size, self.device
            self._tokens = torch.zeros((b, 1), dtype=torch.int64, device=dev)
            self._pos = torch.zeros((), dtype=torch.int64, device=dev)
            self._offsets = torch.zeros((b,), dtype=torch.int64, device=dev)
            self._graph = StepGraph(lambda: self.decode(
                self._tokens, self._cache, self._pos, self._offsets)[0], dev)
        self._tokens.copy_(tokens)
        self._pos.fill_(pos)
        self._offsets.copy_(offsets)
        return self._graph()

    def generate(
        self,
        prompts: Sequence[Sequence[int]],
        max_new_tokens: int = 32,
        eos_id: Optional[int] = None,
        temperature: float = 0.0,
        top_k: Optional[int] = None,
        top_p: Optional[float] = None,
        generator: Optional[torch.Generator] = None,
    ) -> list[list[int]]:
        """Greedy (or sampled) generation for a batch of token prompts."""
        b = self.batch_size
        if len(prompts) > b:
            raise ValueError(f"{len(prompts)} prompts > batch_size {b}")
        plen = max(len(p) for p in prompts)
        # bucket the prefill length to a power of two; skip bucketing when it
        # would eat the generation headroom
        bucket = 16
        while bucket < plen:
            bucket *= 2
        if bucket + max_new_tokens <= self.max_len:
            plen = bucket
        # left-pad: sequence i's real tokens occupy slots [plen-len_i, plen),
        # so every next token lands in slot plen with the right RoPE position
        toks = np.full((b, plen), self.pad_id, np.int64)
        offsets = np.full((b,), plen, np.int64)
        for i, p in enumerate(prompts):
            toks[i, plen - len(p):] = p
            offsets[i] = plen - len(p)
        offsets_t = torch.from_numpy(offsets).to(self.device)
        if temperature > 0.0 and generator is None:
            generator = torch.Generator(device=self.device)
            generator.manual_seed(0)

        t0 = time.perf_counter()
        next_logits, _ = self.prefill(torch.from_numpy(toks).to(self.device), offsets_t)
        out = [list() for _ in range(b)]
        done = np.zeros((b,), bool)
        done[len(prompts):] = True
        pos = plen
        stamps = []
        for step in range(max_new_tokens):
            nxt = sample_logits(
                next_logits, temperature, top_k=top_k, top_p=top_p, generator=generator
            )
            nxt_np = nxt.cpu().numpy()  # waits for the step that made the logits
            stamps.append(time.perf_counter())
            for i in range(len(prompts)):
                if not done[i]:
                    t = int(nxt_np[i])
                    if eos_id is not None and t == eos_id:
                        done[i] = True
                    else:
                        out[i].append(t)
            # no decode step after the last token: its logits would go unused
            if done.all() or pos >= self.max_len or step == max_new_tokens - 1:
                break
            # sampled above: the next replay may overwrite next_logits
            next_logits = self.decode_step(nxt[:, None], pos, offsets_t)
            pos += 1
        self.last_timings = {
            "prefill_s": stamps[0] - t0,
            "decode_s": list(np.diff(stamps)),
        }
        return out[: len(prompts)]


def greedy_generate(
    params,
    config,
    prompts: Sequence[Sequence[int]],
    max_new_tokens: int = 32,
    *,
    forward: Callable = llama.forward,
    max_len: int = 1024,
    eos_id: Optional[int] = None,
    device=None,
) -> list[list[int]]:
    """One-shot convenience wrapper around :class:`Engine`."""
    eng = Engine(
        params=params,
        config=config,
        forward=forward,
        max_len=max_len,
        batch_size=len(prompts),
        device=device,
    )
    return eng.generate(prompts, max_new_tokens=max_new_tokens, eos_id=eos_id)


@torch.inference_mode()
def greedy_generate_fused(
    params,
    config,
    prompt_tokens: torch.Tensor,  # [B, P] (fully dense, no padding)
    max_new_tokens: int,
    *,
    forward: Callable = llama.forward,
    max_len: int = 1024,
    init_cache: Callable = llama.init_cache,
) -> torch.Tensor:
    """Offline greedy generation with no host round trip per token: prefill,
    then a plain loop of decode steps that feeds each argmax back on the
    device. Returns ``[B, max_new_tokens]`` token ids."""
    b, p = prompt_tokens.shape
    cache = init_cache(config, b, max_len, device=prompt_tokens.device)
    logits, cache = forward(params, config, prompt_tokens, cache, 0)
    toks = [torch.argmax(logits[:, -1], dim=-1)[:, None]]
    for step in range(max_new_tokens - 1):
        logits, cache = forward(params, config, toks[-1], cache, p + step)
        toks.append(torch.argmax(logits[:, -1], dim=-1)[:, None])
    return torch.cat(toks, dim=1)
