"""Per-request sampling and penalties, the part of
``flute_tpu/serving/continuous.py`` that the paged engine uses (the
continuous-batching engine itself is not ported yet).

The warp and the penalties are deterministic and follow the JAX functions
step for step. The random draw cannot reproduce ``jax.random``'s bits: a
draw takes its randomness from an explicit ``torch.Generator`` (Gumbel-max
over the warped logits, which samples their softmax), and the engine seeds
that generator from (engine seed, request seed, generation index) alone, so
a request's sampled tokens do not depend on the batch around it.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

_MASK64 = (1 << 64) - 1


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
        # kept on the device: no wait for the logits here
        cutoff = sorted_f[torch.clamp(torch.sum(cum < top_p), 0, v - 1)]
        lg = lg.masked_fill(lg < cutoff, float("-inf"))
    if greedy:
        onehot = torch.full_like(logits, float("-inf"))
        onehot[torch.argmax(logits)] = 0.0
        return onehot
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
    lg = _warp_logits(logits, temperature, top_k, top_p)
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
