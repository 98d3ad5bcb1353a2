"""Rank functions of the port's tensor- and pipeline-parallel tests.

``parallel.launch.run`` spawns the ranks, and each imports this module
to find its function: it imports no JAX (the test modules do), so the
children start without JAX's threads. Every function takes
``(rank, world, ...)``, runs on the CPU with the gloo backend and returns
numpy results for the test to compare across ranks and against the JAX
package and the port at tp = 1.
"""

import contextlib
import json
import time
import urllib.request
from concurrent.futures import ThreadPoolExecutor

import torch
import torch.distributed as dist

from flute_tpu_torch import interop
from flute_tpu_torch.integrations import cli
from flute_tpu_torch.models import gemma2, llama
from flute_tpu_torch.ops import lut_gemm
from flute_tpu_torch.parallel import (
    llama_partition_specs,
    make_hybrid_mesh,
    make_mesh,
    permute_fused_params,
    shard_params,
    tp_forward_fn,
    tp_model_forward,
)
from flute_tpu_torch.parallel.comm import COUNTS
from flute_tpu_torch.parallel.pp import PipelinedModel
from flute_tpu_torch.parallel.tp import local_config
from flute_tpu_torch.serving import (
    ContinuousBatchingEngine,
    Engine,
    PagedEngine,
    PagedSpeculativeEngine,
    server,
)

FAMILIES = {"llama": (llama, llama.LlamaConfig.tiny), "gemma2": (gemma2, gemma2.Gemma2Config.tiny)}


def group_order_plain(x2, planes, scales, table, *, num_bits, chunk, layout, pair_values=None):
    """The LUT-GEMM summed as JAX's kernel sums it (per scale group, x times
    the table values rounded to x's dtype summed in f32, then scaled in f32;
    one rounding at the end), the plain version the forwards are held to
    JAX's with."""
    assert pair_values is None
    codes = lut_gemm._packing.unpack(list(planes), num_bits, chunk=chunk, layout=layout)
    values = table.to(x2.dtype).float()[codes.long()]
    g = codes.shape[0] // scales.shape[0]
    acc = torch.zeros((x2.shape[0], values.shape[1]))
    for i in range(scales.shape[0]):
        rows = slice(i * g, (i + 1) * g)
        acc += (x2[:, rows].float() @ values[rows]) * scales[i].float()
    return acc.to(x2.dtype)


@contextlib.contextmanager
def jax_order_plain():
    saved = lut_gemm.lut_qgemm_plain
    lut_gemm.lut_qgemm_plain = group_order_plain
    try:
        yield
    finally:
        lut_gemm.lut_qgemm_plain = saved


def forward_rank(rank, world, tp_cases, dp_cases, dp):
    """The TP forwards of each case ``(family, numpy params, fused, tokens
    [B, T], cache length)`` on a ``(dp, world / dp)`` mesh: ``tp_cases``
    through the served ``tp_model_forward`` (the whole batch on every tp
    row), ``dp_cases`` through ``tp_forward_fn`` (the batch split over dp).
    Returns per case the logits, this rank's layer-0 K cache and the
    all-reduces of the call, the rank's coordinates, and the sums of the
    ranks over the groups of a hybrid mesh."""
    mesh = make_mesh(tp=world // dp, dp=dp, device="cpu")
    out = {"coords": mesh.coords, "tp_cases": [], "dp_cases": []}
    with jax_order_plain():
        for split, cases in (("tp_cases", tp_cases), ("dp_cases", dp_cases)):
            for family, tree, fused, tokens, s in cases:
                model, tiny = FAMILIES[family]
                cfg = tiny()
                params = interop.params_from_numpy(tree, device="cpu")
                if fused:
                    params = permute_fused_params(params, cfg, mesh.tp)
                specs = llama_partition_specs(params)
                sharded = shard_params(params, mesh, specs)
                b = tokens.shape[0]
                toks = torch.from_numpy(tokens)
                before = COUNTS["all_reduce"]
                with torch.inference_mode():
                    if split == "tp_cases":
                        cache = model.init_cache(local_config(cfg, mesh.tp), b, s, device="cpu")
                        fwd = tp_model_forward(cfg, mesh, specs, base_forward=model.forward)
                        logits, cache = fwd(sharded, cfg, toks, cache, 0)
                    else:
                        cache = model.init_cache(local_config(cfg, mesh.tp), b // mesh.dp, s,
                                                 device="cpu")
                        step = tp_forward_fn(cfg, mesh, specs, forward=model.forward)
                        logits, cache = step(sharded, toks, cache, 0,
                                             torch.zeros((b,), dtype=torch.int64))
                out[split].append(dict(logits=logits.numpy(), k0=cache["k"][0].float().numpy(),
                                       all_reduces=COUNTS["all_reduce"] - before))
    hybrid = make_hybrid_mesh(world // dp, dp, device="cpu")
    tp_sum = torch.tensor([float(rank)])
    dist.all_reduce(tp_sum, group=hybrid.tp_group)
    dp_sum = torch.tensor([float(rank)])
    dist.all_reduce(dp_sum, group=hybrid.dp_group)
    out["hybrid"] = (hybrid.coords, float(tp_sum), float(dp_sum))
    return out


def _run_requests(engine, reqs):
    rids = [engine.submit(p, max_new_tokens=n, **kw) for p, n, kw in reqs]
    out = engine.run()
    return [out[r] for r in rids]


def engines_rank(rank, world, trees, runs):
    """Each engine run ``(name, class name, tree key, fused, engine keywords,
    requests)`` at tp = ``world``: its tokens, blocks in use, prefix hits,
    all-reduces and whether it is graphed. ``Engine`` runs take requests
    as ``(prompts, new tokens)``."""
    mesh = make_mesh(tp=world, device="cpu")
    classes = {"Engine": Engine, "ContinuousBatchingEngine": ContinuousBatchingEngine,
               "PagedEngine": PagedEngine, "PagedSpeculativeEngine": PagedSpeculativeEngine}
    out = {}
    for name, cls, key, fused, kw, reqs in runs:
        family = key.split("_")[0]
        cfg = FAMILIES[family][1]()
        params = interop.params_from_numpy(trees[key], device="cpu")
        if fused:
            params = permute_fused_params(params, cfg, world)
        kw = dict(kw)
        if cls == "PagedSpeculativeEngine":
            kw.update(draft_params=params, draft_config=cfg)
        before = COUNTS["all_reduce"]
        eng = classes[cls](params=params, config=cfg, mesh=mesh, **kw)
        if cls == "Engine":
            prompts, n = reqs
            tokens = eng.generate(prompts, max_new_tokens=n)
        else:
            tokens = _run_requests(eng, reqs)
        out[name] = dict(tokens=tokens, all_reduces=COUNTS["all_reduce"] - before,
                         graphed=eng.graphed,
                         blocks_in_use=getattr(eng, "blocks_in_use", None),
                         prefix_hits=getattr(eng, "prefix_hits", None))
    return out


def post(url, payload) -> tuple:
    """A completion request: the request id and tokens of its answer, plain
    or the final record of a stream."""
    req = urllib.request.Request(url, data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=60) as r:
        last = r.read().decode().strip().splitlines()[-1]
    body = json.loads(last)
    return body["id"], body["tokens"]


def http_serve_rank(rank, world, argv, requests, idle_s, heartbeat_s):
    """``serve --tp``'s loop in a world: every rank builds the engine of the
    CLI arguments ``argv`` (``cli.build_serve_engine``); rank 0 serves it on
    a free port and posts ``requests`` (payloads) to itself all at once,
    then, after ``idle_s`` seconds idle (the loop beats every
    ``heartbeat_s``), the first once more, and returns the answers' ``(rid,
    tokens)`` in request order; every other rank follows and returns
    ``{rid: tokens}`` of the requests it completed."""
    server.HEARTBEAT_S = heartbeat_s
    eng, _ = cli.build_serve_engine(cli.build_parser().parse_args(argv))
    done = {}
    if rank:
        server.follow(eng, on_finish=lambda rid, toks: done.__setitem__(rid, list(toks)))
        return done
    srv = server.serve(eng, port=0)
    url = f"http://127.0.0.1:{srv.server_address[1]}/v1/completions"
    try:
        with ThreadPoolExecutor(len(requests)) as pool:
            answers = list(pool.map(lambda p: post(url, p), requests))
        time.sleep(idle_s)
        answers.append(post(url, requests[0]))
    finally:
        srv.shutdown()
        srv.loop.shutdown()
    return answers


def pp_tp_rank(rank, world, tree, tokens, s):
    """tp x pp: two stages of tp = 2 over ranks (0, 1) and (2, 3); the
    prefill logits and one decode step's, on every rank."""
    cfg = llama.LlamaConfig.tiny()
    meshes = [make_mesh(tp=2, ranks=[0, 1], device="cpu"),
              make_mesh(tp=2, ranks=[2, 3], device="cpu")]
    pm = PipelinedModel.build_tp(interop.params_from_numpy(tree, device="cpu"), cfg, meshes)
    toks = torch.from_numpy(tokens)
    caches = pm.init_cache(toks.shape[0], s)
    logits, caches = pm.forward(toks, caches, 0)
    nxt = torch.argmax(logits[:, -1], dim=-1)[:, None]
    step, _ = pm.forward(nxt, caches, toks.shape[1])
    return dict(logits=logits.numpy(), step=step.numpy(),
                stages=[st is not None for st in pm.stages])


def failing_rank(rank, world, bad_rank):
    """Rank ``bad_rank`` raises while the others wait in an all-reduce."""
    if rank == bad_rank:
        raise ValueError(f"rank {rank} gives up")
    x = torch.ones(1)
    dist.all_reduce(x)
    return float(x)


def hanging_rank(rank, world):
    """Rank 0 waits in an all-reduce that rank 1 never joins."""
    if rank == 0:
        dist.all_reduce(torch.ones(1))
    else:
        import time

        time.sleep(60)
    return rank
