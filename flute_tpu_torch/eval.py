"""Perplexity; counterpart of ``flute_tpu/eval.py``.

``perplexity`` scores a token stream against a Llama or Gemma-2 model of
the port, quantized or dense, with the standard protocol: non-overlapping
windows of ``seq_len`` tokens, the next-token NLL summed over every scored
position and averaged. ``wikitext2_tokens`` tokenizes the standard corpus
where ``datasets`` and a tokenizer are installed (an import gated inside
the function, as in the JAX package; pass your own tokens otherwise).
"""

from __future__ import annotations

from typing import Any, Callable, Optional

import numpy as np
import torch

from flute_tpu_torch.device import resolve_device
from flute_tpu_torch.models import gemma2, llama


def _is_gemma2(config) -> bool:
    return type(config).__name__ == "Gemma2Config"


def llama_init_cache_like(config, batch: int, max_len: int, device=None):
    """Cache constructor dispatch (LlamaConfig vs Gemma2Config)."""
    family = gemma2 if _is_gemma2(config) else llama
    return family.init_cache(config, batch, max_len, device=device)


@torch.inference_mode()
def _nll(params, config, forward, tokens: torch.Tensor) -> tuple[float, int]:
    """Summed next-token NLL of ``tokens`` ``[B, seq_len]`` and the number of
    positions scored: ``forward`` over the first ``seq_len - 1`` tokens, a
    log-softmax over f32 logits, each position's target the next token."""
    b, seq_len = tokens.shape
    cache = llama_init_cache_like(config, b, seq_len, device=tokens.device)
    logits, _ = forward(params, config, tokens[:, :-1], cache, 0)
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -torch.gather(logp, -1, tokens[:, 1:, None].long())[..., 0]
    return float(nll.double().sum()), nll.numel()


def perplexity(
    params: Any,
    config: Any,
    token_ids,
    *,
    forward: Optional[Callable] = None,
    seq_len: int = 2048,
    batch_size: int = 1,
    device=None,
) -> float:
    """Perplexity of ``token_ids`` (1-D array-like) in non-overlapping
    windows of ``seq_len``, ``batch_size`` windows per forward; the windows
    that do not fill a last batch run one at a time. Runs on ``device``
    (``cuda`` unless named), where the params must live."""
    if forward is None:
        forward = gemma2.forward if _is_gemma2(config) else llama.forward
    ids = np.asarray(token_ids, np.int64).reshape(-1)
    n_windows = len(ids) // seq_len
    if n_windows == 0:
        raise ValueError(f"need at least {seq_len} tokens, got {len(ids)}")
    windows = torch.from_numpy(ids[: n_windows * seq_len].reshape(n_windows, seq_len))
    windows = windows.to(resolve_device(device))

    total, count = 0.0, 0
    full = (n_windows // batch_size) * batch_size
    for i in range(0, full, batch_size):
        s, c = _nll(params, config, forward, windows[i:i + batch_size])
        total += s
        count += c
    for i in range(full, n_windows):  # remainder rows scored at batch 1
        s, c = _nll(params, config, forward, windows[i:i + 1])
        total += s
        count += c
    return float(np.exp(total / count))


def wikitext2_tokens(tokenizer_path: str, split: str = "test"):
    """Tokenize wikitext-2 with a Hugging Face tokenizer (needs ``datasets``
    and the corpus in its local cache)."""
    from datasets import load_dataset  # gated: the corpus is not in the repository
    from transformers import AutoTokenizer

    ds = load_dataset("wikitext", "wikitext-2-raw-v1", split=split)
    tok = AutoTokenizer.from_pretrained(tokenizer_path)
    text = "\n\n".join(ds["text"])
    return np.asarray(tok(text)["input_ids"], np.int32)
