"""The yardstick: the H100's peaks, the operations and bytes of a LUT-GEMM
call and of a model step, and the calls that the served engines make.

Peaks are NVIDIA's data sheet for the H100 SXM: 989 TFLOP/s dense bf16 on
the tensor cores, 3.35 TB/s of HBM3. A card may run at a lower power limit;
the run reports it beside the numbers.

A LUT-GEMM call ``[M, K] @ W[K, N]`` needs ``2 M N K`` operations and reads
the packed weights at the format's bits, the group scales (bf16), the
format's table, x (bf16) and writes y (bf16), each byte once. Its least
time is the larger of operations at the peak rate and bytes at the peak
bandwidth.

A model step's operations are the useful ones: two per weight and row of
every projection, the head for the rows that need logits, and attention's
two products over each row's real context.
"""

from __future__ import annotations

PEAK_FLOPS = 989e12
PEAK_BYTES_S = 3.35e12

# bytes of the format's lookup table: 16 float32 values (w4sym) or the
# HIGGS grid's 256 pairs of float32 values
TABLE_BYTES = {"w4sym": 16 * 4, "higgs": 256 * 2 * 4}
WEIGHT_BITS = {"w4sym": 4, "higgs": 4}
ACT_BYTES = 2  # bf16


def projections(model: dict) -> dict:
    """(K, N) of each fused projection of a layer."""
    hid, inter = model["hidden_size"], model["intermediate_size"]
    h, hkv, d = model["num_attention_heads"], model["num_key_value_heads"], model["head_dim"]
    return {"qkv": (hid, (h + 2 * hkv) * d), "o": (h * d, hid),
            "gate_up": (hid, 2 * inter), "down": (inter, hid)}


def lut_flops(m: int, n: int, k: int) -> float:
    return 2.0 * m * n * k


def lut_bytes(m: int, n: int, k: int, fmt: str, group: int) -> float:
    weights = k * n * WEIGHT_BITS[fmt] / 8
    scales = (k // group) * n * ACT_BYTES
    return weights + scales + TABLE_BYTES[fmt] + (m * k + m * n) * ACT_BYTES


def lut_least_s(m: int, n: int, k: int, fmt: str, group: int) -> float:
    """The least time of one call: its operations at the peak rate or its
    bytes at the peak bandwidth, whichever is longer."""
    return max(lut_flops(m, n, k) / PEAK_FLOPS, lut_bytes(m, n, k, fmt, group) / PEAK_BYTES_S)


def layer_calls(model: dict, m: int) -> list:
    """The LUT-GEMM calls ``(M, N, K)`` of every layer's four projections
    at ``m`` rows."""
    return [(m, n, k) for _ in range(model["num_hidden_layers"])
            for k, n in projections(model).values()]


def _bucket(n: int, lo: int) -> int:
    b = lo
    while b < n:
        b *= 2
    return b


def prefill_chunks(engine: dict, plen: int) -> list:
    """``(real, launched)`` rows of each forward call that admitting a
    ``plen``-token prompt makes, as the engine buckets and chunks it (no
    prefix hit): ``ContinuousBatchingEngine`` one left-padded power-of-two
    bucket from 16, or full ``prefill_chunk`` chunks and the remainder's
    bucket; ``PagedEngine`` with pool prefill chunks of ``prefill_chunk``
    (256 when unset), each padded to a power of two from the block size.
    ``real`` counts the prompt's tokens in the call, ``launched`` the rows
    the kernels run."""
    chunk = engine.get("prefill_chunk")
    if engine["kind"] == "continuous":
        if chunk is None or plen <= chunk:
            return [(plen, _bucket(plen, 16))]
        full, rem = divmod(plen, chunk)
        return [(chunk, chunk)] * full + ([(rem, _bucket(rem, 16))] if rem else [])
    if engine["kind"] == "paged":
        chunk = chunk or 256
        out, c0 = [], 0
        while c0 < plen:
            m = min(chunk, plen - c0)
            out.append((m, _bucket(m, engine["block_size"])))
            c0 += m
        return out
    raise ValueError(f"unknown engine {engine['kind']!r}")


def prefill_rows(engine: dict, plen: int) -> list:
    """The launched rows of each forward call of a ``plen``-token prompt's
    admission (:func:`prefill_chunks`)."""
    return [launched for _, launched in prefill_chunks(engine, plen)]


def route(m: int) -> str:
    """The route of a LUT-GEMM call at ``m`` rows, for the counters' check:
    the decode loop to 16 rows, the mid route to 192, the wide-M kernel
    above."""
    return "loop" if m <= 16 else "mid" if m <= 192 else "wide"


def matmul_params(model: dict) -> int:
    """Weights of one layer's projections."""
    return sum(k * n for k, n in projections(model).values())


def head_params(model: dict) -> int:
    return model["hidden_size"] * model["vocab_size"]


def attention_flops(model: dict, context: int) -> float:
    """One row's two attention products over ``context`` positions, all
    layers."""
    h, d = model["num_attention_heads"], model["head_dim"]
    return 4.0 * model["num_hidden_layers"] * h * d * context


def decode_flops(model: dict, contexts: list) -> float:
    """A decode step's useful operations: one row per request decoded, each
    attending over its context (the new token included)."""
    per_row = 2.0 * (model["num_hidden_layers"] * matmul_params(model) + head_params(model))
    return per_row * len(contexts) + sum(attention_flops(model, c) for c in contexts)


def prefill_flops(model: dict, plen: int) -> float:
    """A prompt's useful prefill operations: every token through the layers,
    causal attention, the head for the last token."""
    h, d = model["num_attention_heads"], model["head_dim"]
    attn = 4.0 * model["num_hidden_layers"] * h * d * plen * (plen + 1) / 2
    return 2.0 * model["num_hidden_layers"] * matmul_params(model) * plen \
        + 2.0 * head_params(model) + attn
