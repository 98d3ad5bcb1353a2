"""The system under test: the port's model and serving engine, built from a
configuration file, a traffic mix and the benchmark's inputs, as the
port's ``serve`` builds them (``integrations/cli.py::build_serve_engine``).

* ``w4sym``: the dense weights go through ``models.llama.quantize_model``
  (the port's NF quantizer, sign-symmetric 4-bit grid, fused q/k/v and
  gate/up) one layer at a time, so that the dense model never sits whole
  on the card.
* ``higgs``: the codes, grid and scales go through
  ``quantize.higgs.from_higgs`` (the pair table, the rotation size).
* Engine: ``ContinuousBatchingEngine`` or ``PagedEngine`` (pool prefill),
  greedy, no end-of-sequence token, the mix's slots, ``max_len`` and
  prefill chunk. A paged pool holds every slot at ``max_len`` (plus the
  trash block), so that admission never waits for blocks.
"""

from __future__ import annotations

import torch

from .weights import Inputs


def llama_config(model: dict):
    """The port's ``LlamaConfig`` of a configuration file."""
    from flute_tpu_torch.models.llama import LlamaConfig

    if model.get("sliding_window") is not None:
        raise ValueError("a sliding window is not served by this configuration's path")
    return LlamaConfig(
        vocab_size=model["vocab_size"], hidden_size=model["hidden_size"],
        intermediate_size=model["intermediate_size"], num_layers=model["num_hidden_layers"],
        num_heads=model["num_attention_heads"], num_kv_heads=model["num_key_value_heads"],
        head_dim=model["head_dim"], rms_norm_eps=model["rms_norm_eps"],
        rope_theta=model["rope_theta"], rope_scaling_factor=None,
        tie_word_embeddings=model["tie_word_embeddings"], dtype=torch.bfloat16,
    )


def engine_settings(model: dict, mix: dict) -> dict:
    """The engine's kind (from the configuration) and sizes (from the mix)."""
    return {**model["engine"], **mix["engine"]}


def build_params(model: dict, inputs: Inputs, slots: int) -> dict:
    """The port's params of ``model`` from the benchmark's inputs."""
    from flute_tpu_torch.models import llama

    dev = inputs.device
    hid = model["hidden_size"]
    q = model["quant"]
    params = {"embed": inputs.embed(), "layers": [],
              "final_norm": torch.ones((hid,), dtype=torch.bfloat16, device=dev),
              "lm_head": inputs.head()}
    h, hkv, d, inter = (model["num_attention_heads"], model["num_key_value_heads"],
                        model["head_dim"], model["intermediate_size"])
    for i in range(model["num_hidden_layers"]):
        w = inputs.layer(i)
        norms = {"attn_norm": torch.ones((hid,), dtype=torch.bfloat16, device=dev),
                 "mlp_norm": torch.ones((hid,), dtype=torch.bfloat16, device=dev)}
        if q["format"] == "w4sym":
            qkv, gu = w["qkv"], w["gate_up"]
            dense = {**norms, "q": qkv[:, :h * d], "k": qkv[:, h * d:(h + hkv) * d],
                     "v": qkv[:, (h + hkv) * d:], "o": w["o"], "gate": gu[:, :inter],
                     "up": gu[:, inter:], "down": w["down"]}
            layer = llama.quantize_model({"layers": [dense]}, num_bits=4,
                                         group_size=q["group_size"], fuse=True,
                                         example_batch_size=slots, device=dev)["layers"][0]
        elif q["format"] == "higgs":
            from flute_tpu_torch.quantize import higgs

            grid = w["grid"].cpu().numpy()
            layer = dict(norms)
            for name in ("qkv", "o", "gate_up", "down"):
                layer[name] = higgs.from_higgs(
                    w[name]["codes"], grid, w[name]["scales"], num_bits=4,
                    group_size=q["group_size"], hadamard_size=q["hadamard_size"])
        else:
            raise ValueError(f"unknown format {q['format']!r}")
        params["layers"].append(layer)
        del w
    return params


def build_engine(model: dict, mix: dict, params: dict, device):
    """The serving engine of the cell (the benchmark's client sets its
    ``token_callback``)."""
    from flute_tpu_torch.serving import ContinuousBatchingEngine, PagedEngine

    e = engine_settings(model, mix)
    config = llama_config(model)
    if e["kind"] == "continuous":
        return ContinuousBatchingEngine(
            params=params, config=config, num_slots=e["num_slots"], max_len=e["max_len"],
            eos_id=None, prefill_chunk=e.get("prefill_chunk"), device=device)
    if e["kind"] == "paged":
        bs = e["block_size"]
        return PagedEngine(
            params=params, config=config, num_slots=e["num_slots"], block_size=bs,
            num_blocks=e["num_slots"] * e["max_len"] // bs + 1, max_len=e["max_len"],
            eos_id=None, prefill_chunk=e.get("prefill_chunk"),
            pool_prefill=e["pool_prefill"], device=device)
    raise ValueError(f"unknown engine {e['kind']!r}")
