"""Whether what the timed path served is right: the served tokens held
against the plain float32 reference (``reference/model.py``).

Once the window has closed and the program's state is freed, a sample of
the requests the window finished is drawn from the seed, the longest of
them always in it. The reference runs once over each prompt with its served
tokens and gives, at every served token, its float32 logits. The number
compared is the widest gap by which a served token's reference logit lies
below the reference's best at that position (greedy decoding serves the
argmax, so a sound program's gaps stay within its rounding). Beside it:
every finished request carries the output length it was sent with.

The control (``control=True``) is the same reference with every projection
in float8 e4m3: at each position of the same sequences, the gap of the
token the float8 model puts first. The runner judges it in the program's
place, by the same limit.
"""

from __future__ import annotations

import numpy as np


def sample(records: list, seed: int, count: int) -> list:
    """``count`` finished requests drawn from the seed, the longest first."""
    done = [r for r in records if r.done]
    if not done:
        return []
    longest = max(done, key=lambda r: (r.plen + r.olen, r.index))
    rest = [r for r in done if r is not longest]
    rng = np.random.default_rng([int(seed) % (1 << 32), 0xC4EC])
    pick = rng.choice(len(rest), size=min(count - 1, len(rest)), replace=False)
    return [longest] + [rest[i] for i in sorted(pick)]


def served_gaps(model: dict, inputs, picked: list, prompts: dict, control: bool = False) -> dict:
    """The reference's readings over the picked requests: ``max_logit_gap``
    of the served tokens and the count of tokens compared; with
    ``control``, ``control_gap``, the float8 model's widest gap."""
    import torch

    from reference import model as ref

    seqs = [list(prompts[r.index]) + r.tokens[:-1] for r in picked]
    starts = [r.plen - 1 for r in picked]
    full = ref.logits(model, inputs, seqs, starts)
    out = {"max_logit_gap": 0.0, "tokens_compared": 0}
    served = [torch.tensor(r.tokens, device=inputs.device) for r in picked]
    for lg, tok in zip(full, served):
        best = lg.max(dim=-1).values
        gap = best - lg.gather(1, tok[:, None])[:, 0]
        out["max_logit_gap"] = max(out["max_logit_gap"], float(gap.max()))
        out["tokens_compared"] += int(tok.numel())
    if control:
        low = ref.logits(model, inputs, seqs, starts, fp8=True)
        out["control_gap"] = 0.0
        for lg, lg8 in zip(full, low):
            pick = lg8.argmax(dim=-1)
            gap = lg.max(dim=-1).values - lg.gather(1, pick[:, None])[:, 0]
            out["control_gap"] = max(out["control_gap"], float(gap.max()))
    return out
