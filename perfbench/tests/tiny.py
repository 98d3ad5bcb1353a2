"""A benchmark root at toy sizes for the CPU tests: the real harness,
readers and reference, with configurations, mixes and cells of their own
written into a temporary directory and found by name as the real ones are."""

from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

import torch

HOME = Path(__file__).resolve().parents[1]
ROOT = HOME.parent
for _p in (str(HOME), str(ROOT)):
    if _p not in sys.path:
        sys.path.insert(0, _p)

# the toy runs time their windows by the wall clock: a few threads each, so
# that test processes side by side do not starve one another
torch.set_num_threads(2)

TINY_MODEL = {
    "architectures": ["MistralForCausalLM"], "hidden_act": "silu", "hidden_size": 256,
    "intermediate_size": 512, "num_hidden_layers": 2, "num_attention_heads": 4,
    "num_key_value_heads": 2, "head_dim": 64, "vocab_size": 512, "rope_theta": 1000000.0,
    "rms_norm_eps": 1e-05, "sliding_window": None, "tie_word_embeddings": False,
    "initializer_range": 0.02, "reduced": [],
}
CONFIGS = {
    "tiny.w4sym": {**TINY_MODEL, "quant": {"format": "w4sym", "bits": 4, "group_size": 64},
                   "engine": {"kind": "continuous"}},
    "tiny.higgs": {**TINY_MODEL,
                   "quant": {"format": "higgs", "bits": 4, "group_size": 64,
                             "hadamard_size": 256},
                   "engine": {"kind": "paged", "pool_prefill": True, "block_size": 16}},
}
MIXES = {
    "chat": {"kind": "open_loop", "arrivals": {"process": "poisson"},
             "prompt_len": {"dist": "lognormal", "median": 24, "sigma": 0.6, "min": 8,
                            "max": 64},
             "output_len": {"dist": "lognormal", "median": 8, "sigma": 0.5, "min": 4,
                            "max": 16},
             "engine": {"num_slots": 4, "max_len": 128, "prefill_chunk": None},
             "shape_seed": 5, "requests": 200, "block": 8, "ramp_s": 0.3, "trace_s": 0.6,
             "check_requests": 3},
    "batch": {"kind": "backlog", "backlog": 4,
              "prompt_len": {"dist": "uniform", "min": 40, "max": 90},
              "output_len": {"dist": "uniform", "min": 4, "max": 8},
              "engine": {"num_slots": 4, "max_len": 128, "prefill_chunk": 32},
              "shape_seed": 6, "requests": 400, "block": 8, "ramp_s": 0.3, "trace_s": 0.6,
              "check_requests": 2},
}
CELLS = {
    "tiny-w4sym.chat": ("tiny.w4sym", "chat", {"rate_per_s": 6.0}),
    "tiny-higgs.chat": ("tiny.higgs", "chat", {"rate_per_s": 6.0}),
    "tiny-w4sym.batch": ("tiny.w4sym", "batch", {}),
}
# the widest gap a sound CPU run may read at these sizes (the port's plain
# path computes in bfloat16; the reference in float32)
TINY_LIMIT = 0.05


def make_root(tmp: Path, real: dict) -> Path:
    """A benchmark root under ``tmp`` for the toy cells, whose metric
    entries are ``real``'s (the repository's BENCHMARK.json) and whose
    readers are the repository's files."""
    home = tmp / "perfbench"
    for sub in ("configs", "traffic", "cells"):
        (home / sub).mkdir(parents=True)
    shutil.copytree(HOME / "metrics", home / "metrics")
    configs = []
    for name, model in CONFIGS.items():
        (home / "configs" / f"{name}.json").write_text(json.dumps(model))
        configs.append({"name": name, "source": "toy", "file": f"perfbench/configs/{name}.json",
                        "reduced": [], "why": "toy"})
    for name, mix in MIXES.items():
        (home / "traffic" / f"{name}.json").write_text(json.dumps(mix))
    workloads = []
    for name, (cfg, mix, cell) in CELLS.items():
        cell = {**cell, "limits": {"max_logit_gap": TINY_LIMIT}}
        (home / "cells" / f"{name}.json").write_text(json.dumps(cell))
        workloads.append({"name": name, "config": cfg, "traffic": mix, "chips": 1,
                          "why": "toy"})

    def retarget(entries):
        """A real cell's metrics go to the toy cell of the same format."""
        toy = {w["name"]: ("tiny-higgs.chat" if "higgs" in w["config"] else "tiny-w4sym.chat")
               for w in real["workloads"]}
        out = []
        for m in entries:
            m = dict(m)
            if "workloads" in m:
                m["workloads"] = sorted({toy[w] for w in m["workloads"]})
            out.append(m)
        return out

    data = {**real, "configs": configs, "workloads": workloads,
            "end_to_end": retarget(real["end_to_end"]), "per_layer": retarget(real["per_layer"])}
    (tmp / "BENCHMARK.json").write_text(json.dumps(data))
    return tmp


def real_manifest() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())
