"""The knee sweep of an open-loop cell: the cell's engine built once, then
its mix offered at each of a few fixed rates for ``seconds`` after a ramp,
the engine drained between rates. For each rate it prints the offered and
completed request rates, the TTFT and TPOT tails, and whether the backlog
(requests submitted and not yet admitted) grew over the window: its mean
over the window's last third more than one request above its first
third's.

The knee is the highest rate whose backlog does not grow; the cell's rate
(``perfbench/cells/<cell>.json``) is set once, from one sweep, at about
four fifths of it.
"""

from __future__ import annotations

import json
import time

from . import traffic
from .readers import percentile
from .runner import build_kernels, warm_up
from .system import build_engine, build_params, engine_settings
from .weights import Inputs
from .window import Client, open_loop


def sweep(manifest, workload: str, seed: int, seconds: float, rates: list, *, device,
          log, out_path=None) -> list:
    import torch

    w = manifest.workload(workload)
    model = manifest.config(w["config"])
    mix = manifest.traffic(w["traffic"])
    eng = engine_settings(model, mix)
    dev = torch.device(device)
    if dev.type == "cuda":
        build_kernels()
    params = build_params(model, Inputs(model, seed, dev), eng["num_slots"])
    engine = build_engine(model, mix, params, dev)
    del params
    warm_up(engine, eng, mix, model["vocab_size"])
    rows = []
    for rate in rates:
        client = Client(engine)
        requests = traffic.generate(mix, seed, model["vocab_size"], eng["max_len"], rate)
        origin = time.perf_counter()
        w0 = origin + float(mix["ramp_s"])
        w1 = w0 + seconds
        samples = []
        open_loop(client, requests, origin, w1,
                  on_tick=lambda now: samples.append((now, client.waiting)))
        due = [r for r in client.records if w0 <= r.due < w1]
        ttft = [r.first - r.due if r.first is not None and r.first < w1 else float("inf")
                for r in due]
        tpot = [(r.last - r.first) / (len(r.tokens) - 1) for r in client.records
                if r.done and len(r.tokens) > 1 and w0 <= r.last < w1]
        third = seconds / 3
        head = [q for t, q in samples if w0 <= t < w0 + third]
        tail = [q for t, q in samples if w1 - third <= t < w1]
        row = {
            "rate_per_s": rate,
            "due": len(due),
            "completed_per_s": sum(1 for r in client.records
                                   if r.done and w0 <= r.last < w1) / seconds,
            "ttft_p50_ms": 1e3 * percentile(ttft, 50),
            "ttft_p90_ms": 1e3 * percentile(ttft, 90),
            "tpot_p90_ms": 1e3 * percentile(tpot, 90) if tpot else None,
            "backlog_first_third": sum(head) / max(1, len(head)),
            "backlog_last_third": sum(tail) / max(1, len(tail)),
        }
        row["grows"] = row["backlog_last_third"] > row["backlog_first_third"] + 1
        rows.append(row)
        log("sweep " + json.dumps(row))
        client.drain()
    if out_path is not None:
        with open(out_path, "w") as f:
            json.dump({"workload": workload, "seed": seed, "seconds": seconds,
                       "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
                       "rows": rows}, f, indent=1)
    return rows
