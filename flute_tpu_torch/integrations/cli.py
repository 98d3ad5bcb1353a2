"""Command-line entry points of the port, counterpart of
``flute_tpu/integrations/cli.py``:

    python -m flute_tpu_torch.integrations.cli quantize \\
        --model-dir /path/to/hf-llama --output-dir /path/to/out \\
        --num-bits 4 --group-size 64

    python -m flute_tpu_torch.integrations.cli generate \\
        --checkpoint /path/to/out --prompt "..." --max-new-tokens 64

    python -m flute_tpu_torch.integrations.cli serve \
        --checkpoint /path/to/out --tp 2 --paged --pool-prefill --port 8000

Every subcommand that runs a model takes ``--device`` (default ``cuda``);
``--device cpu`` runs the plain PyTorch path on the CPU. Without a tokenizer in the
checkpoint (or without ``transformers``), prompts are whitespace-separated
token ids and outputs are printed as id lists. ``serve --tp N`` runs a
world of N processes (``parallel.launch``, gloo), one shard of the engine
each, on the cards ``rank % device_count`` (several ranks may share one):
rank 0 answers HTTP and every other rank follows its steps
(``serving.server.follow``). SIGINT or SIGTERM stops it. ``bench-kernel``
is not ported and says so.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

_TOKENIZER_FILES = ("tokenizer.json", "tokenizer_config.json", "tokenizer.model")


def load_tokenizer(path: str):
    """The checkpoint's tokenizer through ``transformers`` (local files
    only) where the directory holds tokenizer files, else None."""
    if not any(os.path.exists(os.path.join(path, f)) for f in _TOKENIZER_FILES):
        return None
    try:
        from transformers import AutoTokenizer

        return AutoTokenizer.from_pretrained(path, local_files_only=True)
    except Exception:
        return None


def _cmd_quantize(args):
    from flute_tpu_torch.integrations import huggingface as hf

    if args.streaming:
        if args.fake:
            raise SystemExit("--fake is incompatible with --streaming")
        stats = hf.quantize_hf_model_streaming(
            args.model_dir, args.output_dir, num_bits=args.num_bits,
            group_size=args.group_size, fuse=args.fuse,
            example_batch_size=args.example_batch_size, device=args.device,
        )
        print(f"quantized (streaming) {args.model_dir} -> {args.output_dir} "
              f"(peak buffered projections: {stats['buffered_high_water']})")
        return
    hf.quantize_hf_model(
        args.model_dir, args.output_dir, num_bits=args.num_bits, group_size=args.group_size,
        fake=args.fake, example_batch_size=args.example_batch_size, device=args.device,
    )
    print(f"quantized {args.model_dir} -> {args.output_dir}")


def _cmd_import_flute(args):
    """Convert a reference-FLUTE checkpoint into a servable checkpoint (or,
    without ``--output-dir``, only count what would be converted)."""
    from flute_tpu_torch.integrations.flute_format import (
        load_reference_checkpoint,
        reference_to_model_checkpoint,
    )

    if args.output_dir:
        n = reference_to_model_checkpoint(
            args.model_dir, args.output_dir, tile_p=args.tile_p, template_id=args.template_id
        )
        print(f"converted {n} quantized layers from {args.model_dir} -> "
              f"{args.output_dir} (servable: cli generate/serve --checkpoint)")
    else:
        out = load_reference_checkpoint(
            args.model_dir, tile_p=args.tile_p, template_id=args.template_id
        )
        n = sum(1 for v in out.values() if isinstance(v, dict) and "planes" in v)
        print(f"converted {n} quantized layers from {args.model_dir} (dry run)")


def _model_type(sidecar) -> str:
    return (sidecar.get("model_config") or {}).get("model_type", "llama")


def _cmd_generate(args):
    import torch

    from flute_tpu_torch.integrations.huggingface import (
        load_quantized_model,
        model_fns,
        resolve_model_path,
    )
    from flute_tpu_torch.serving import Engine, SpeculativeEngine
    from flute_tpu_torch.serving.continuous import SamplingParams

    params, config, sidecar = load_quantized_model(
        args.checkpoint, batch_size=1, retune=args.retune, device=args.device
    )
    if config is None:
        raise SystemExit("checkpoint lacks config.json; cannot build model")
    fwd, init_cache = model_fns(_model_type(sidecar))
    tok = load_tokenizer(resolve_model_path(args.checkpoint))
    if tok is not None:
        ids = tok(args.prompt)["input_ids"]
    else:
        ids = [int(t) for t in args.prompt.split()]
    if args.draft_checkpoint:
        # speculative decoding: the draft checkpoint (e.g. a W2 quantization
        # of the same model) proposes, the target verifies
        dparams, dconfig, dsidecar = load_quantized_model(
            args.draft_checkpoint, batch_size=1, retune=args.retune, device=args.device
        )
        if model_fns(_model_type(dsidecar))[0] is not fwd:
            raise SystemExit("draft and target model families must match")
        eng = SpeculativeEngine(
            target_params=params, target_config=config,
            draft_params=dparams, draft_config=dconfig,
            k=args.speculate_k, forward=fwd, init_cache=init_cache,
            max_len=args.max_len, batch_size=1, device=args.device,
        )
        sampling = None
        if args.temperature > 0:
            sampling = SamplingParams(temperature=args.temperature, top_k=args.top_k,
                                      top_p=args.top_p, seed=args.seed)
        out = eng.generate([ids], max_new_tokens=args.max_new_tokens, sampling=sampling)
        print(f"# speculative: {eng.stats.rounds} rounds, "
              f"{eng.stats.acceptance_rate:.0%} acceptance, "
              f"{eng.stats.bonus} bonus tokens", file=sys.stderr)
    else:
        eng = Engine(params=params, config=config, forward=fwd, init_cache=init_cache,
                     max_len=args.max_len, batch_size=1, device=args.device)
        gen = torch.Generator(device=eng.device)
        gen.manual_seed(args.seed)
        out = eng.generate(
            [ids], max_new_tokens=args.max_new_tokens, temperature=args.temperature,
            top_k=args.top_k or None, top_p=args.top_p if args.top_p < 1.0 else None,
            generator=gen,
        )
    print(tok.decode(out[0]) if tok is not None else out[0])


def _cmd_calibrate(args):
    """NFL: learn per-group scales on a token corpus, then quantize with
    them and save a servable checkpoint."""
    import numpy as np

    from flute_tpu_torch.integrations import checkpoint as ckpt_io
    from flute_tpu_torch.integrations import huggingface as hf
    from flute_tpu_torch.models import gemma2, llama
    from flute_tpu_torch.quantize import learnable

    config = hf.config_from_hf(args.model_dir)
    params = hf.load_hf_params(args.model_dir, config, device=args.device)
    if args.tokens_npy:
        ids = np.load(args.tokens_npy).astype(np.int32).reshape(-1)
    else:
        from flute_tpu_torch.eval import wikitext2_tokens

        ids = wikitext2_tokens(args.model_dir, split="train")
    n = args.batch_size * args.seq_len
    nb = min(args.steps, len(ids) // n)
    batches = [ids[i * n:(i + 1) * n].reshape(args.batch_size, args.seq_len) for i in range(nb)]
    mtype = hf.model_type_of(args.model_dir)
    trained = learnable.learn_scales(
        params, config, batches, num_bits=args.num_bits, group_size=args.group_size,
        learning_rate=args.lr, forward=gemma2.forward if mtype == "gemma2" else llama.forward,
        callback=lambda i, loss: print(f"step {i}: loss {loss:.4f}", flush=True),
    )
    final = learnable.finalize_model(trained)
    ckpt_io.save_quantized(
        args.output_dir, final,
        model_config={"model_type": mtype, "source": args.model_dir, "nfl": True},
        num_bits=args.num_bits, group_size=args.group_size,
    )
    # config.json beside it, so that generate and serve can load it
    hf._copy_side_files(args.model_dir, args.output_dir)
    print(f"NFL-calibrated checkpoint written to {args.output_dir}")


def _load_checked(path, args, what, device):
    """A checkpoint of ``serve`` (``what`` names it): params, config and
    sidecar on ``device``; with ``--tp`` above 1, checked with
    ``validate_tp``."""
    from flute_tpu_torch.integrations.huggingface import load_quantized_model
    from flute_tpu_torch.parallel import validate_tp

    params, config, sidecar = load_quantized_model(
        path, batch_size=args.num_slots, retune=args.retune, device=device
    )
    if config is None:
        raise SystemExit(f"{what} lacks config.json; cannot build model")
    if args.tp > 1:
        try:
            validate_tp(params, config, tp=args.tp)
        except ValueError as e:
            raise SystemExit(f"serve --tp {args.tp}: {e}") from None
    return params, config, sidecar


def _check_serve(args):
    """Refuse ``serve`` arguments that cannot be served."""
    if args.draft_checkpoint and not args.paged:
        raise SystemExit("--draft-checkpoint on serve requires --paged")
    if args.tp > 1 and args.retune:
        raise SystemExit("--retune tunes launches at the whole model's shapes, not at a "
                         "rank's shard; serve --tp without it")


def build_serve_engine(args):
    """The serving engine and tokenizer of ``serve``'s arguments: a
    ``ContinuousBatchingEngine``, a ``PagedEngine`` with ``--paged`` (pool
    prefill with ``--pool-prefill``), or a ``PagedSpeculativeEngine`` with
    ``--paged --draft-checkpoint``. With ``--tp`` above 1 it is this rank's
    shard, built on every rank of a world of ``--tp`` processes after
    ``torch.distributed.init_process_group``: as the JAX package builds it,
    the checkpoints checked with ``validate_tp``, their fused layers
    permuted rank-major, and the engine given a mesh."""
    from flute_tpu_torch.integrations.huggingface import model_fns, resolve_model_path
    from flute_tpu_torch.parallel import make_mesh, permute_fused_params
    from flute_tpu_torch.serving import (
        ContinuousBatchingEngine,
        PagedEngine,
        PagedSpeculativeEngine,
    )

    _check_serve(args)
    # at tp > 1 a rank loads on the host and its engine shards onto its card
    where = "cpu" if args.tp > 1 else args.device
    params, config, sidecar = _load_checked(args.checkpoint, args, "checkpoint", where)
    mesh = None
    if args.tp > 1:
        params = permute_fused_params(params, config, tp=args.tp)
        mesh = make_mesh(tp=args.tp, dp=1, device=args.device)
    fwd, init_cache = model_fns(_model_type(sidecar))
    tok = load_tokenizer(resolve_model_path(args.checkpoint))
    eos = getattr(tok, "eos_token_id", None)
    place = dict(mesh=mesh) if mesh is not None else dict(device=args.device)
    paged = dict(num_slots=args.num_slots, max_len=args.max_len, block_size=args.block_size,
                 num_blocks=args.num_blocks, eos_id=eos, prefill_chunk=args.prefill_chunk,
                 pool_prefill=args.pool_prefill, **place)
    if args.draft_checkpoint:
        dparams, dconfig, _ = _load_checked(args.draft_checkpoint, args, "draft checkpoint",
                                            where)
        dparams = permute_fused_params(dparams, dconfig, tp=args.tp)
        eng = PagedSpeculativeEngine(params=params, config=config, draft_params=dparams,
                                     draft_config=dconfig, k=args.speculative_k, **paged)
    elif args.paged:
        eng = PagedEngine(params=params, config=config, forward=fwd, init_cache=init_cache,
                          **paged)
    else:
        eng = ContinuousBatchingEngine(
            params=params, config=config, forward=fwd, init_cache=init_cache,
            num_slots=args.num_slots, max_len=args.max_len, eos_id=eos,
            prefill_chunk=args.prefill_chunk, prefix_cache_entries=args.prefix_cache,
            prefix_block=args.prefix_block, **place,
        )
    return eng, tok


def _serve_url(args, srv) -> str:
    return f"http://{args.host}:{srv.server_address[1]}/v1/completions"


def _serve_rank(rank, world, args, stop):
    """One rank of ``serve --tp``: rank 0 serves HTTP until ``stop`` is set,
    then stops its followers; every other rank follows rank 0's steps."""
    from flute_tpu_torch.serving.server import follow, serve

    eng, tok = build_serve_engine(args)
    if rank:
        follow(eng)
        return None
    srv = serve(eng, host=args.host, port=args.port, tokenizer=tok, model_id=args.checkpoint)
    print(f"serving on {_serve_url(args, srv)}", flush=True)
    while not stop.wait(0.5) and srv.loop.error is None:
        pass
    srv.shutdown()
    srv.loop.shutdown()
    if srv.loop.error is not None:
        raise RuntimeError("the serving loop failed") from srv.loop.error
    return None


# how long the ranks of a stopped ``serve --tp`` may take to leave
STOP_GRACE_S = 60.0


def _serve_tp(args):
    """``serve --tp N``: refuse what cannot be served, then run a world of
    N ranks (``parallel.launch.start`` builds the kernels once, here) until
    SIGINT or SIGTERM; exits nonzero if a rank failed."""
    import signal

    import torch
    import torch.multiprocessing as mp

    from flute_tpu_torch.parallel import launch

    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("serve --tp: no CUDA device is available; pass --device cpu to "
                         "serve on the CPU")
    _check_serve(args)
    # refuse what does not split before a port is bound or a rank started
    _load_checked(args.checkpoint, args, "checkpoint", "cpu")
    if args.draft_checkpoint:
        _load_checked(args.draft_checkpoint, args, "draft checkpoint", "cpu")
    stop = mp.get_context("spawn").Event()
    # the ranks inherit an ignored SIGINT (a Ctrl-C reaches the terminal's
    # whole process group): only this process's handler stops the world
    signal.signal(signal.SIGINT, signal.SIG_IGN)
    world = launch.start(_serve_rank, args.tp, args, stop,
                         threads=max(1, torch.get_num_threads() // args.tp))
    try:
        for sig in (signal.SIGINT, signal.SIGTERM):
            signal.signal(sig, lambda *_: stop.set())
        deadline = None
        while not world.join(timeout=0.5):  # raises when a rank fails
            if deadline is None and stop.is_set():
                deadline = time.monotonic() + STOP_GRACE_S
            if deadline is not None and time.monotonic() > deadline:
                world.terminate()
                raise SystemExit(f"serve --tp: the ranks did not stop within {STOP_GRACE_S} s")
    finally:
        world.close()


def _cmd_serve(args):
    if args.tp > 1:
        _serve_tp(args)
        return
    from flute_tpu_torch.serving.server import serve

    eng, tok = build_serve_engine(args)
    srv = serve(eng, host=args.host, port=args.port, tokenizer=tok, model_id=args.checkpoint)
    print(f"serving on {_serve_url(args, srv)}", flush=True)
    try:
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        srv.shutdown()
        srv.loop.shutdown()


def _cmd_bench_kernel(args):
    raise NotImplementedError(
        "bench-kernel: the port has no benchmark yet (ROADMAP.md item 9); "
        "chip_smoke.py times its kernels"
    )


def _add_device(p):
    p.add_argument("--device", default="cuda",
                   help="device to run on (default cuda; cpu runs the plain PyTorch path)")


def build_parser():
    p = argparse.ArgumentParser(prog="flute_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)

    q = sub.add_parser("quantize", help="quantize an HF checkpoint")
    q.add_argument("--model-dir", required=True)
    q.add_argument("--output-dir", required=True)
    q.add_argument("--num-bits", type=int, default=4)
    q.add_argument("--group-size", type=int, default=64)
    q.add_argument("--fake", action="store_true")
    q.add_argument("--example-batch-size", type=int, default=8)
    q.add_argument("--streaming", action="store_true",
                   help="layer-streaming quantization with bounded host memory")
    q.add_argument("--fuse", action="store_true",
                   help="fuse qkv / gate_up projections (streaming only)")
    _add_device(q)
    q.set_defaults(fn=_cmd_quantize)

    g = sub.add_parser("generate", help="generate from a quantized checkpoint")
    g.add_argument("--checkpoint", required=True)
    g.add_argument("--prompt", required=True)
    g.add_argument("--max-new-tokens", type=int, default=64)
    g.add_argument("--max-len", type=int, default=2048)
    g.add_argument("--retune", action="store_true")
    g.add_argument("--draft-checkpoint", default=None,
                   help="speculative decoding with this quantized draft checkpoint "
                        "(same tokenizer and vocabulary, e.g. a W2 quantization of the model)")
    g.add_argument("--speculate-k", type=int, default=4,
                   help="draft proposals per verify round")
    g.add_argument("--temperature", type=float, default=0.0,
                   help="sampling temperature (0 = greedy); with --draft-checkpoint "
                        "speculative sampling")
    g.add_argument("--top-k", type=int, default=0, help="top-k filter (0 = off)")
    g.add_argument("--top-p", type=float, default=1.0, help="nucleus filter (1.0 = off)")
    g.add_argument("--seed", type=int, default=0, help="sampling seed")
    _add_device(g)
    g.set_defaults(fn=_cmd_generate)

    c = sub.add_parser("calibrate", help="NFL learned-scale calibration")
    c.add_argument("--model-dir", required=True)
    c.add_argument("--output-dir", required=True)
    c.add_argument("--num-bits", type=int, default=4)
    c.add_argument("--group-size", type=int, default=64)
    c.add_argument("--tokens-npy", default=None,
                   help=".npy of token ids (default: wikitext-2 through datasets)")
    c.add_argument("--steps", type=int, default=128)
    c.add_argument("--batch-size", type=int, default=2)
    c.add_argument("--seq-len", type=int, default=512)
    c.add_argument("--lr", type=float, default=1e-4)
    _add_device(c)
    c.set_defaults(fn=_cmd_calibrate)

    s = sub.add_parser("serve", help="HTTP completion server (continuous batching)")
    s.add_argument("--checkpoint", required=True)
    s.add_argument("--host", default="127.0.0.1")
    s.add_argument("--port", type=int, default=8000)
    s.add_argument("--num-slots", type=int, default=8)
    s.add_argument("--max-len", type=int, default=2048)
    s.add_argument("--retune", action="store_true")
    s.add_argument("--prefill-chunk", type=int, default=None,
                   help="chunked prefill admission (bounds per-admission latency)")
    s.add_argument("--prefix-cache", type=int, default=0,
                   help="keep K/V of up to N recent prompt blocks for prefix reuse (LRU)")
    s.add_argument("--prefix-block", type=int, default=64,
                   help="prefix-cache block size in tokens")
    s.add_argument("--tp", type=int, default=1,
                   help="tensor-parallel ways: a world of this many processes, one shard each "
                        "(rank 0 serves HTTP)")
    s.add_argument("--paged", action="store_true",
                   help="paged KV engine: block-pool memory")
    s.add_argument("--block-size", type=int, default=16, help="paged KV block size in tokens")
    s.add_argument("--num-blocks", type=int, default=512, help="paged KV pool size in blocks")
    s.add_argument("--pool-prefill", action="store_true",
                   help="with --paged: prefill straight into pool blocks (K6)")
    s.add_argument("--draft-checkpoint", default=None,
                   help="with --paged: serve speculatively with this draft checkpoint")
    s.add_argument("--speculative-k", type=int, default=4,
                   help="draft proposals per verify round")
    _add_device(s)
    s.set_defaults(fn=_cmd_serve)

    imp = sub.add_parser("import-flute",
                         help="convert a reference-FLUTE checkpoint to the checkpoint format")
    imp.add_argument("--model-dir", required=True)
    imp.add_argument("--output-dir", default=None)
    imp.add_argument("--tile-p", type=int, default=None, choices=[32, 64])
    imp.add_argument("--template-id", type=int, default=None)
    imp.set_defaults(fn=_cmd_import_flute)

    b = sub.add_parser("bench-kernel", help="run the kernel benchmark (not ported)")
    b.set_defaults(fn=_cmd_bench_kernel)

    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
