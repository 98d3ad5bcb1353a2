"""HF checkpoint interop, counterpart of
``flute_tpu/integrations/huggingface.py``: read dense HF Llama and Gemma-2
safetensors directories into the port's params, quantize them (in memory
or streaming one projection at a time) into the quantized-checkpoint
format, and load such checkpoints back, retuning their launches on demand.

Shards are read with the port's own reader
(:mod:`flute_tpu_torch.integrations.safetensors_io`); only a hub repo id
reaches ``huggingface_hub``, imported where it is needed.
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Any, Iterator, Optional

import torch

from flute_tpu_torch.device import resolve_device
from flute_tpu_torch.integrations import checkpoint as ckpt_io
from flute_tpu_torch.integrations import safetensors_io
from flute_tpu_torch.models import llama as llama_mod

_LLAMA_LAYER_KEYS = {
    "input_layernorm.weight": ("attn_norm", False),
    "self_attn.q_proj.weight": ("q", True),
    "self_attn.k_proj.weight": ("k", True),
    "self_attn.v_proj.weight": ("v", True),
    "self_attn.o_proj.weight": ("o", True),
    "post_attention_layernorm.weight": ("mlp_norm", False),
    "mlp.gate_proj.weight": ("gate", True),
    "mlp.up_proj.weight": ("up", True),
    "mlp.down_proj.weight": ("down", True),
}

# Gemma-2 sandwich norms (HF names -> layer keys)
_GEMMA2_LAYER_KEYS = {
    **_LLAMA_LAYER_KEYS,
    "post_attention_layernorm.weight": ("post_attn_norm", False),
    "pre_feedforward_layernorm.weight": ("mlp_norm", False),
    "post_feedforward_layernorm.weight": ("post_mlp_norm", False),
}

# files copied beside a checkpoint so that it is self-contained
_SIDE_FILES = ("config.json", "tokenizer.json", "tokenizer_config.json")


def resolve_model_path(
    path_or_repo: str,
    *,
    revision: Optional[str] = None,
    cache_dir: Optional[str] = None,
    allow_patterns: Optional[list] = None,
) -> str:
    """A local directory as it is, or an HF-hub repo id (``org/name``)
    snapshotted through ``huggingface_hub``; anything else raises
    ``FileNotFoundError``."""
    if os.path.isdir(path_or_repo):
        return path_or_repo
    looks_remote = (
        "/" in path_or_repo
        and not os.path.isabs(path_or_repo)
        and not path_or_repo.startswith(".")
    )
    if not looks_remote:
        raise FileNotFoundError(
            f"{path_or_repo!r} is neither a local directory nor an HF-hub "
            "repo id (expected 'org/name')"
        )
    try:
        from huggingface_hub import snapshot_download
    except ImportError as e:
        raise ImportError(
            f"loading {path_or_repo!r} from the HF hub requires huggingface_hub") from e
    return snapshot_download(
        repo_id=path_or_repo,
        revision=revision,
        cache_dir=cache_dir,
        allow_patterns=allow_patterns,
    )


def _open_safetensor_shards(model_dir: str) -> Iterator[tuple[str, torch.Tensor]]:
    """``(name, CPU tensor)`` of the checkpoint, one tensor read at a time:
    by ``model.safetensors.index.json``'s shards (sorted) where there is
    one, else ``model.safetensors`` in name order."""
    index_path = os.path.join(model_dir, "model.safetensors.index.json")
    if os.path.exists(index_path):
        with open(index_path) as f:
            index = json.load(f)["weight_map"]
        shards: dict = {}
        for name, shard in index.items():
            shards.setdefault(shard, []).append(name)
        for shard in sorted(shards):
            with safetensors_io.SafeOpen(os.path.join(model_dir, shard)) as f:
                for name in shards[shard]:
                    yield name, f.get_tensor(name)
    else:
        with safetensors_io.SafeOpen(os.path.join(model_dir, "model.safetensors")) as f:
            for name in f.keys():
                yield name, f.get_tensor(name)


def model_type_of(model_dir: str) -> str:
    with open(os.path.join(model_dir, "config.json")) as f:
        return json.load(f).get("model_type", "llama")


def config_from_hf(model_dir: str):
    """The port's config (LlamaConfig or Gemma2Config, by ``model_type``)
    of an HF ``config.json``."""
    if model_type_of(model_dir) == "gemma2":
        return _gemma2_config_from_hf(model_dir)
    with open(os.path.join(model_dir, "config.json")) as f:
        hf = json.load(f)
    rope_scaling = hf.get("rope_scaling") or {}
    scaling_type = rope_scaling.get("rope_type") or rope_scaling.get("type")
    return llama_mod.LlamaConfig(
        vocab_size=hf["vocab_size"],
        hidden_size=hf["hidden_size"],
        intermediate_size=hf["intermediate_size"],
        num_layers=hf["num_hidden_layers"],
        num_heads=hf["num_attention_heads"],
        num_kv_heads=hf.get("num_key_value_heads", hf["num_attention_heads"]),
        head_dim=hf.get("head_dim", hf["hidden_size"] // hf["num_attention_heads"]),
        rms_norm_eps=hf.get("rms_norm_eps", 1e-5),
        rope_theta=hf.get("rope_theta", 10000.0),
        rope_scaling_factor=rope_scaling.get("factor") if scaling_type == "llama3" else None,
        rope_low_freq_factor=rope_scaling.get("low_freq_factor", 1.0),
        rope_high_freq_factor=rope_scaling.get("high_freq_factor", 4.0),
        rope_original_max_position=rope_scaling.get("original_max_position_embeddings", 8192),
        tie_word_embeddings=hf.get("tie_word_embeddings", False),
    )


def _gemma2_config_from_hf(model_dir: str):
    from flute_tpu_torch.models import gemma2

    with open(os.path.join(model_dir, "config.json")) as f:
        hf = json.load(f)
    return gemma2.Gemma2Config(
        vocab_size=hf["vocab_size"],
        hidden_size=hf["hidden_size"],
        intermediate_size=hf["intermediate_size"],
        num_layers=hf["num_hidden_layers"],
        num_heads=hf["num_attention_heads"],
        num_kv_heads=hf.get("num_key_value_heads", hf["num_attention_heads"]),
        head_dim=hf.get("head_dim", 256),
        rms_norm_eps=hf.get("rms_norm_eps", 1e-6),
        rope_theta=hf.get("rope_theta", 10000.0),
        query_pre_attn_scalar=float(hf.get("query_pre_attn_scalar", 256)),
        attn_logit_softcap=hf.get("attn_logit_softcapping", 50.0),
        final_logit_softcap=hf.get("final_logit_softcapping", 30.0),
        sliding_window=hf.get("sliding_window", 4096),
    )


def load_hf_params(model_dir: str, config=None, dtype: torch.dtype = torch.bfloat16,
                   device=None) -> dict:
    """Read an HF Llama/Gemma-2 safetensors checkpoint into the port's params
    on ``device`` (``cuda`` unless named), linear leaves transposed to
    ``[in, out]``. ``model_dir`` may be a local directory or a hub repo id."""
    dev = resolve_device(device)
    model_dir = resolve_model_path(model_dir)
    mtype = model_type_of(model_dir)
    config = config or config_from_hf(model_dir)
    key_map = _GEMMA2_LAYER_KEYS if mtype == "gemma2" else _LLAMA_LAYER_KEYS
    layers = [dict() for _ in range(config.num_layers)]
    params: dict = {"layers": layers}
    if mtype != "gemma2":
        params["lm_head"] = None

    def load(t, transpose=False):
        t = t.to(device=dev, dtype=dtype)
        return t.T.contiguous() if transpose else t

    for name, tensor in _open_safetensor_shards(model_dir):
        if name == "model.embed_tokens.weight":
            params["embed"] = load(tensor)
        elif name == "model.norm.weight":
            params["final_norm"] = load(tensor)
        elif name == "lm_head.weight" and mtype != "gemma2":
            params["lm_head"] = load(tensor, transpose=True)
        elif name.startswith("model.layers."):
            li, sub = name[len("model.layers."):].split(".", 1)
            if sub not in key_map:
                continue
            key, is_linear = key_map[sub]
            layers[int(li)][key] = load(tensor, transpose=is_linear)
        # rotary inv_freq buffers and the like are recomputed, not loaded
    if mtype == "gemma2":
        params.pop("lm_head", None)  # always tied: forward uses embed.T
    elif getattr(config, "tie_word_embeddings", False):
        params["lm_head"] = None
    return params


def _copy_side_files(model_dir: str, output_dir: str) -> None:
    for fname in _SIDE_FILES:
        src = os.path.join(model_dir, fname)
        if os.path.exists(src):
            shutil.copy(src, os.path.join(output_dir, fname))


def quantize_hf_model(
    model_dir: str,
    output_dir: str,
    num_bits: int = 4,
    group_size: int = 64,
    *,
    fake: bool = False,
    example_batch_size: int = 8,
    dtype: torch.dtype = torch.bfloat16,
    device=None,
) -> None:
    """Load, NF-quantize on ``device`` (``cuda`` unless named) and save with
    the sidecar. ``fake=True`` saves the fake-quantized dense model instead.
    ``example_batch_size`` is kept for the JAX signature: the port's keys
    do not depend on it."""
    del example_batch_size
    dev = resolve_device(device)
    model_dir = resolve_model_path(model_dir)
    config = config_from_hf(model_dir)
    params = load_hf_params(model_dir, config, dtype, device=dev)
    if fake:
        from flute_tpu_torch.quantize import nf

        for layer in params["layers"]:
            for key in llama_mod._PROJ_KEYS:
                w = layer[key].T
                layer[key] = nf.nf_quantize_fake(w, num_bits, group_size, dtype).T
        qparams = params
    else:
        qparams = llama_mod.quantize_model(params, num_bits, group_size, device=dev)
    ckpt_io.save_quantized(
        output_dir,
        qparams,
        model_config={"model_type": model_type_of(model_dir), "source": model_dir},
        num_bits=num_bits,
        group_size=group_size,
    )
    _copy_side_files(model_dir, output_dir)


def quantize_hf_model_streaming(
    model_dir: str,
    output_dir: str,
    num_bits: int = 4,
    group_size: int = 64,
    *,
    fuse: bool = False,
    example_batch_size: int = 8,
    quantize_lm_head: bool = False,
    device=None,
) -> dict:
    """Quantization with bounded host memory: walks the safetensors shards a
    tensor at a time, quantizes and packs each projection (or fused group)
    with ``nn.quantize_linear`` on ``device`` (``cuda`` unless named) as
    soon as it is complete, writes it to the output checkpoint and frees it. Peak residency is one
    decoder layer's projections. Writes the files of
    :func:`quantize_hf_model` for the same checkpoint.

    Returns ``{"buffered_high_water": int}``: the most projection tensors
    held at once."""
    from flute_tpu_torch import packing
    from flute_tpu_torch.nn import quantize_linear

    del example_batch_size  # kept for the JAX signature: keys do not depend on it
    dev = resolve_device(device)
    model_dir = resolve_model_path(model_dir)
    mtype = model_type_of(model_dir)
    key_map = _GEMMA2_LAYER_KEYS if mtype == "gemma2" else _LLAMA_LAYER_KEYS
    writer = ckpt_io.StreamingWriter(output_dir)
    tie = False
    try:
        with open(os.path.join(model_dir, "config.json")) as f:
            tie = bool(json.load(f).get("tie_word_embeddings", False))
    except FileNotFoundError:
        pass

    def bf16(t: torch.Tensor) -> torch.Tensor:
        return t.float().to(torch.bfloat16)

    def quant_store(tree_path: str, w_nk: torch.Tensor) -> None:
        """Quantize an ``[out, in]`` dense weight on ``dev`` as the in-memory
        path does (rounded through bf16 first, as it loads it; the wide
        3-bit layout where K allows) and flush it."""
        k = w_nk.shape[1]
        layer = quantize_linear(bf16(w_nk).to(dev), num_bits, group_size, device=dev,
                                wide=num_bits == 3 and k % packing.DEFAULT_CHUNK == 0)
        writer.add_quantized(tree_path, layer.planes, layer.scales, layer.table,
                             num_bits=num_bits, group_size=group_size,
                             config_key=layer.config_key, layout=layer.layout)

    pending: dict[int, dict[str, torch.Tensor]] = {}
    high_water = 0
    fuse_groups = {"qkv": ("q", "k", "v"), "gate_up": ("gate", "up")} if fuse else {}
    fused_members = {m for grp in fuse_groups.values() for m in grp}

    def flush_ready(li: int) -> None:
        buf = pending.get(li)
        if not buf:
            return
        for fused_key, members in fuse_groups.items():
            if all(m in buf for m in members):
                w = torch.cat([buf.pop(m) for m in members], dim=0)
                quant_store(f"layers/{li}/{fused_key}", w)
        for key in list(buf):
            if key not in fused_members:
                quant_store(f"layers/{li}/{key}", buf.pop(key))
        if not buf:
            del pending[li]

    saw_lm_head = False
    for name, tensor in _open_safetensor_shards(model_dir):
        if name == "model.embed_tokens.weight":
            writer.add_array("embed", bf16(tensor))
        elif name == "model.norm.weight":
            writer.add_array("final_norm", bf16(tensor))
        elif name == "lm_head.weight" and mtype != "gemma2":
            saw_lm_head = True
            if quantize_lm_head:
                quant_store("lm_head", tensor.float())
            else:
                writer.add_array("lm_head", bf16(tensor).T.contiguous())
        elif name.startswith("model.layers."):
            li_s, sub = name[len("model.layers."):].split(".", 1)
            if sub not in key_map:
                continue
            key, is_linear = key_map[sub]
            li = int(li_s)
            if not is_linear:
                writer.add_array(f"layers/{li}/{key}", bf16(tensor))
                continue
            pending.setdefault(li, {})[key] = tensor.float()
            high_water = max(high_water, sum(len(b) for b in pending.values()))
            flush_ready(li)
        del tensor
    for li in list(pending):
        flush_ready(li)
    if pending:
        raise ValueError(f"incomplete layers in checkpoint: {sorted(pending)}")
    if mtype != "gemma2" and (tie or not saw_lm_head):
        writer.add_none("lm_head")
    writer.finish(
        model_config={"model_type": mtype, "source": model_dir},
        num_bits=num_bits,
        group_size=group_size,
    )
    _copy_side_files(model_dir, output_dir)
    return {"buffered_high_water": high_water}


def model_fns(model_type: str):
    """(forward, init_cache) of a ``model_type`` string."""
    if model_type == "gemma2":
        from flute_tpu_torch.models import gemma2

        return gemma2.forward, gemma2.init_cache
    return llama_mod.forward, llama_mod.init_cache


def load_quantized_model(
    path: str, *, batch_size: Optional[int] = None, retune: bool = False, device=None,
) -> tuple[dict, Any, dict]:
    """Load a quantized checkpoint onto ``device`` (``cuda`` unless named);
    returns (params, config or None where the directory has no
    ``config.json``, sidecar). With ``retune=True`` each block's layers get
    the launch :func:`flute_tpu_torch.tune.tune_linear` picks for
    ``batch_size`` on this card (a launch choice only: no repack, the same
    bits). ``path`` may be a local directory or a hub repo id."""
    path = resolve_model_path(path)
    params, sidecar = ckpt_io.load_quantized(path, device)
    config = config_from_hf(path) if os.path.exists(os.path.join(path, "config.json")) else None
    if retune and batch_size is not None:
        from flute_tpu_torch import tune
        from flute_tpu_torch.nn import QuantizedLinear

        for layer in params["layers"]:
            for key, v in list(layer.items()):
                if isinstance(v, QuantizedLinear):
                    layer[key] = tune.tune_linear(v, batch_size)
    return params, config, sidecar
