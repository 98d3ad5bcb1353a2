"""OpenAI-style HTTP completion server over the port's serving engines;
counterpart of ``flute_tpu/serving/server.py``.

A standard-library ``ThreadingHTTPServer`` front end feeds one engine
(``ContinuousBatchingEngine``, ``PagedEngine`` or
``PagedSpeculativeEngine``), which a single background device thread steps.
Handler threads touch host state only (the engine's queue, the loop's
results and counters): on the card an engine captures its step in a CUDA
graph at its first step, in the device thread, and a CUDA call from
another thread during that capture would end it.

Endpoints:
  POST /v1/completions        {"prompt": [token ids] | "text",
                               "max_tokens": N, "temperature": f,
                               "top_k": n, "top_p": f, "seed": n,
                               "stop_token_ids": [ids],
                               "repetition_penalty"/"presence_penalty"/
                               "frequency_penalty": f, "logprobs": bool,
                               "n": N, "stream": bool,
                               "model": str (OpenAI schema)}
  POST /v1/chat/completions   {"messages": [{role, content}], ...},
                              rendered through the tokenizer's chat template
  GET  /v1/models             OpenAI model listing
  GET  /metrics               Prometheus counters and engine gauges
  GET  /health

With ``"stream": true`` the answer is chunked newline-delimited JSON: one
``{"token": t}`` object per generated token as it is produced, then a final
``{"done": true, "tokens": [...]}`` record.

A request that carries a ``"model"`` field (the OpenAI SDK always sends
one), and every chat request, is answered in the OpenAI schema instead:
``{"object": "text_completion", "choices": [{"text", "index",
"finish_reason"}], "usage": {...}}``, and a stream becomes server-sent
events (``data: {chunk}`` ... ``data: [DONE]``) with per-token text
deltas. ``"n": N`` fans out N engine requests with seeds ``seed + i``.

A request the engine refuses at submission (``PagedEngine`` refuses one
that cannot fit its ``max_len`` or its pool) is answered 400, streamed or
not.

An engine built on a tensor-parallel mesh (``mesh.tp > 1``) is one rank's
shard of the model: every rank of its tp group runs its own engine and
steps it in lock step, since each step all-reduces across them. The rank
that serves HTTP (the group's first) runs :func:`serve`; every other rank
runs :func:`follow`. Before each step the device thread broadcasts the
requests accepted since the last one, each with the id its engine gave it,
and the followers submit them in that order and step too; a request the
engine refused was never sent. An idle server sends nothing but a
heartbeat every ``HEARTBEAT_S`` seconds, so that a follower waiting for
the next step never reaches the process group's timeout.
"""

from __future__ import annotations

import dataclasses
import json
import queue
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Optional

from flute_tpu_torch.serving.continuous import SamplingParams

# an idle tensor-parallel server's heartbeat to its followers, in seconds:
# far inside the process group's collective timeout (parallel.launch.start)
HEARTBEAT_S = 10.0


def _tp_source(mesh) -> Optional[tuple]:
    """The tp group of ``mesh`` and the global rank that serves it (its
    first), or None at tp = 1."""
    if mesh is None or mesh.tp == 1:
        return None
    return mesh.tp_group, mesh.ranks[mesh.dp_rank][0]


def _broadcast(source, msg=None):
    """Rank 0's message of the device thread, on every rank of the tp group."""
    import torch.distributed as dist

    group, src = source
    box = [msg]
    dist.broadcast_object_list(box, src=src, group=group)
    return box[0]


class ServingLoop:
    """Background thread that steps the engine whenever work is queued
    (and, on a TP engine, has the followers step with it)."""

    def __init__(self, engine, tokenizer=None, model_id: str = "flute-tpu"):
        self.engine = engine
        self.tokenizer = tokenizer
        self.model_id = model_id
        self._lock = threading.Lock()
        self._started = time.time()
        self.requests_total = 0
        self.completed_total = 0
        self.tokens_total = 0
        self._results: dict[int, Any] = {}
        self._logprobs: dict[int, list] = {}
        self._events: dict[int, threading.Event] = {}
        self._streams: dict[int, queue.Queue] = {}
        engine.token_callback = self._on_token
        self._source = _tp_source(getattr(engine, "mesh", None))
        # (rid, prompt, max_new_tokens, sampling) accepted since the last
        # step, for the followers of a TP engine
        self._pending: list = []
        self._work = threading.Event()  # set by each submission
        self.error: Optional[BaseException] = None  # what ended the device thread
        self._stop = False
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _on_token(self, rid: int, tok: int) -> None:
        # called from the device thread while it holds self._lock
        q = self._streams.get(rid)
        if q is not None:
            q.put(tok)

    def submit(
        self,
        prompt_ids,
        max_tokens: int,
        sampling: Optional[SamplingParams] = None,
        stream: bool = False,
    ) -> int:
        sampling = sampling or SamplingParams()
        with self._lock:
            self.requests_total += 1
            rid = self.engine.submit(prompt_ids, max_new_tokens=max_tokens, sampling=sampling)
            if self._source is not None:
                self._pending.append((rid, list(prompt_ids), max_tokens, sampling))
            self._events[rid] = threading.Event()
            if stream:
                self._streams[rid] = queue.Queue()
            self._work.set()
        return rid

    def wait(self, rid: int, timeout: float = 300.0):
        ev = self._events[rid]
        if not ev.wait(timeout):
            raise TimeoutError(f"request {rid} timed out")
        with self._lock:
            self._events.pop(rid, None)
            return self._results.pop(rid)

    def logprobs(self, rid: int) -> list:
        """Per-token log p under the raw model distribution (parallel to
        the result of wait); call after wait(rid)."""
        with self._lock:
            return self._logprobs.pop(rid, [])

    def stream_tokens(self, rid: int, timeout: float = 300.0):
        """Yield tokens for ``rid`` as they are generated (stream=True
        submissions only); ends when the request finishes."""
        q = self._streams[rid]
        deadline = time.monotonic() + timeout
        while True:
            try:
                tok = q.get(timeout=min(1.0, max(0.0, deadline - time.monotonic())))
            except queue.Empty:
                if self._events[rid].is_set():
                    break
                if time.monotonic() >= deadline:
                    raise TimeoutError(f"request {rid} timed out")
                continue
            if tok is None:
                break
            yield tok
        with self._lock:
            self._streams.pop(rid, None)
            self._events.pop(rid, None)
            self._results.pop(rid, None)

    def _run(self):
        try:
            busy = False
            while not self._stop:
                # idle: wait for a submission; a TP server beats meanwhile
                if not busy and not self._work.wait(HEARTBEAT_S):
                    if self._source is not None:
                        with self._lock:
                            _broadcast(self._source, ("beat",))
                    continue
                with self._lock:
                    self._work.clear()
                    if self._source is not None:
                        _broadcast(self._source, ("step", self._pending))
                        self._pending = []
                    busy = self.engine.step()
                    self._drain()
            if self._source is not None:
                _broadcast(self._source, ("stop",))
        except BaseException as e:  # noqa: BLE001 — the serving process reads it
            self.error = e
            raise

    def _drain(self):
        # called from the device thread while it holds self._lock
        done = self.engine._finished
        if not done:
            return
        lps = getattr(self.engine, "finished_logprobs", {})
        for rid, toks in list(done.items()):
            self.completed_total += 1
            self.tokens_total += len(toks)
            self._results[rid] = toks
            self._logprobs[rid] = lps.pop(rid, [])
            q = self._streams.get(rid)
            if q is not None:
                q.put(None)  # end-of-stream sentinel
            ev = self._events.get(rid)
            if ev is not None:
                ev.set()
        self.engine._finished = {}

    def metrics_text(self) -> str:
        """Prometheus text exposition of the serving counters and the
        engine's gauges, all read from host state."""
        eng = self.engine
        lines = [
            "# TYPE flute_requests_total counter",
            f"flute_requests_total {self.requests_total}",
            "# TYPE flute_completed_total counter",
            f"flute_completed_total {self.completed_total}",
            "# TYPE flute_tokens_generated_total counter",
            f"flute_tokens_generated_total {self.tokens_total}",
            "# TYPE flute_uptime_seconds gauge",
            f"flute_uptime_seconds {time.time() - self._started:.1f}",
        ]
        q = getattr(eng, "_queue", None)
        if q is not None:
            lines += ["# TYPE flute_queue_depth gauge", f"flute_queue_depth {len(q)}"]
        for name, attr in (
            ("flute_paged_blocks_in_use", "blocks_in_use"),
            ("flute_prefix_hits_total", "prefix_hits"),
            ("flute_prefix_block_hits_total", "prefix_block_hits"),
        ):
            val = getattr(eng, attr, None)
            if val is not None:
                lines += [f"# TYPE {name} gauge", f"{name} {val}"]
        stats = getattr(eng, "stats", None)
        if stats is not None and hasattr(stats, "acceptance_rate"):
            lines += [
                "# TYPE flute_spec_rounds_total counter",
                f"flute_spec_rounds_total {stats.rounds}",
                "# TYPE flute_spec_acceptance_rate gauge",
                f"flute_spec_acceptance_rate {stats.acceptance_rate:.4f}",
                "# TYPE flute_spec_bonus_total counter",
                f"flute_spec_bonus_total {stats.bonus}",
            ]
        return "\n".join(lines) + "\n"

    def shutdown(self):
        """Stop the device thread (after its step in flight; a TP loop then
        sends its followers the stop)."""
        self._stop = True
        self._work.set()
        self._thread.join(timeout=60)


def follow(engine, on_finish=None) -> None:
    """A follower rank of a TP server: mirror the serving rank's device
    thread on this rank's ``engine`` (the same engine, built on this rank's
    mesh) until it stops. Each step message's requests are submitted in
    order, each must get the id the serving rank's engine gave it, then the
    engine steps. ``on_finish(rid, tokens)`` sees each finished request;
    the engine keeps none of them."""
    source = _tp_source(engine.mesh)
    if source is None:
        raise ValueError("follow needs an engine on a mesh with tp > 1")
    engine.token_callback = None
    while True:
        msg = _broadcast(source)
        if msg[0] == "stop":
            return
        if msg[0] == "beat":
            continue
        for rid, prompt, max_new, sampling in msg[1]:
            got = engine.submit(prompt, max_new_tokens=max_new, sampling=sampling)
            if got != rid:
                raise RuntimeError(f"the follower's request {got} is the server's {rid}")
        engine.step()
        if on_finish is not None:
            for rid, toks in engine._finished.items():
                on_finish(rid, toks)
        engine._finished = {}
        getattr(engine, "finished_logprobs", {}).clear()


def _parse_sampling(req: dict) -> SamplingParams:
    return SamplingParams(
        temperature=float(req.get("temperature", 0.0)),
        top_k=int(req.get("top_k", 0)),
        top_p=float(req.get("top_p", 1.0)),
        seed=int(req.get("seed", 0)),
        stop_token_ids=tuple(int(t) for t in req.get("stop_token_ids", ())),
        repetition_penalty=float(req.get("repetition_penalty", 1.0)),
        presence_penalty=float(req.get("presence_penalty", 0.0)),
        frequency_penalty=float(req.get("frequency_penalty", 0.0)),
    )


def _finish_reason(n_out: int, max_tokens: int) -> str:
    return "length" if n_out >= max_tokens else "stop"


def _oai_completion(rid, model, toks, max_tokens, tokenizer, created):
    return {
        "id": f"cmpl-{rid}",
        "object": "text_completion",
        "created": created,
        "model": model,
        "choices": [{
            "index": 0,
            "text": tokenizer.decode(toks) if tokenizer is not None else "",
            "token_ids": toks,  # extension: available without a tokenizer
            "finish_reason": _finish_reason(len(toks), max_tokens),
        }],
        "usage": None,  # filled by the caller (needs the prompt length)
    }


def _parse_request(loop: ServingLoop, req: dict, chat: bool):
    """The prompt's token ids, ``max_tokens``, sampling, ``stream`` and
    ``n`` of a request; raises ValueError for a malformed one."""
    if chat:
        msgs = req.get("messages")
        if not isinstance(msgs, list) or not msgs:
            raise ValueError("messages must be a non-empty list")
        if loop.tokenizer is None or not hasattr(loop.tokenizer, "apply_chat_template"):
            raise ValueError("chat completions require a tokenizer with a chat template")
        prompt = loop.tokenizer.apply_chat_template(msgs, add_generation_prompt=True)
    else:
        prompt = req.get("prompt")
        if isinstance(prompt, str):
            if loop.tokenizer is None:
                raise ValueError("text prompts require a tokenizer; send token ids")
            prompt = loop.tokenizer(prompt)["input_ids"]
    if not isinstance(prompt, list) or not prompt:
        raise ValueError("prompt must be a non-empty token list")
    max_tokens = int(req.get("max_tokens", 64))
    sampling = _parse_sampling(req)
    stream = bool(req.get("stream", False))
    n = int(req.get("n", 1))
    if n < 1:
        raise ValueError("n must be >= 1")
    if n > 1 and stream:
        raise ValueError("n > 1 is not supported with stream")
    return prompt, max_tokens, sampling, stream, n


def make_handler(loop: ServingLoop):
    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, fmt, *args):  # quiet
            pass

        def _send(self, code: int, payload: dict):
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/health":
                self._send(200, {"status": "ok"})
            elif self.path == "/metrics":
                body = loop.metrics_text().encode()
                self.send_response(200)
                self.send_header("Content-Type", "text/plain; version=0.0.4")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
            elif self.path == "/v1/models":
                self._send(200, {
                    "object": "list",
                    "data": [{"id": loop.model_id, "object": "model", "owned_by": "flute-tpu"}],
                })
            else:
                self._send(404, {"error": "not found"})

        def do_POST(self):
            chat = self.path in ("/v1/chat/completions", "/chat/completions")
            if not chat and self.path not in ("/v1/completions", "/completions"):
                self._send(404, {"error": "not found"})
                return
            try:
                length = int(self.headers.get("Content-Length", "0"))
                req = json.loads(self.rfile.read(length) or b"{}")
                prompt, max_tokens, sampling, stream, n = _parse_request(loop, req, chat)
            except Exception as e:  # noqa: BLE001 — report to client
                self._send(400, {"error": str(e)})
                return

            # chat requests, and completion requests carrying "model" (the
            # OpenAI SDK always sends one), get the OpenAI schema; others
            # keep the lightweight token-id schema
            model = req.get("model")
            if chat and model is None:
                model = loop.model_id
            if stream:
                try:
                    rid = loop.submit(prompt, max_tokens, sampling, stream=True)
                except Exception as e:  # noqa: BLE001 — the engine refused it
                    self._send(400, {"error": str(e)})
                    return
                self._stream(rid, chat, model, max_tokens)
                return
            try:
                out = self._complete(prompt, max_tokens, sampling, n, chat, model,
                                     bool(req.get("logprobs")))
            except Exception as e:  # noqa: BLE001
                self._send(400, {"error": str(e)})
                return
            self._send(200, out)

        def _complete(self, prompt, max_tokens, sampling, n, chat, model, want_lp) -> dict:
            """A whole answer: ``n`` engine requests with seeds ``seed + i``
            (they batch in the same slot grid)."""
            if n > 1 and not chat and model is None:
                raise ValueError("n > 1 requires the OpenAI schema (send a \"model\" field)")
            samplings = [sampling if i == 0 else dataclasses.replace(sampling,
                                                                     seed=sampling.seed + i)
                         for i in range(n)]
            rids = [loop.submit(prompt, max_tokens, s) for s in samplings]
            all_toks = [loop.wait(r) for r in rids]
            rid, toks = rids[0], all_toks[0]
            tok = loop.tokenizer
            if chat:
                out = {
                    "id": f"chatcmpl-{rid}",
                    "object": "chat.completion",
                    "created": int(time.time()),
                    "model": model,
                    "choices": [{
                        "index": 0,
                        "message": {"role": "assistant", "content": tok.decode(toks)},
                        "finish_reason": _finish_reason(len(toks), max_tokens),
                    }],
                }
            elif model is not None:
                out = _oai_completion(rid, model, toks, max_tokens, tok,
                                      created=int(time.time()))
            else:
                out = {"id": rid, "tokens": toks}
                if tok is not None:
                    out["text"] = tok.decode(toks)
                return out
            tmpl = out["choices"][0]
            for i in range(1, n):
                c = dict(tmpl, index=i, finish_reason=_finish_reason(len(all_toks[i]),
                                                                     max_tokens))
                if "message" in c:
                    c["message"] = {"role": "assistant", "content": tok.decode(all_toks[i])}
                else:
                    c["text"] = tok.decode(all_toks[i]) if tok is not None else ""
                    c["token_ids"] = all_toks[i]
                out["choices"].append(c)
            total_out = sum(len(t) for t in all_toks)
            out["usage"] = {
                "prompt_tokens": len(prompt),
                "completion_tokens": total_out,
                "total_tokens": len(prompt) + total_out,
            }
            if want_lp:
                for i, r in enumerate(rids):
                    piece = out["choices"][i].get("message") or out["choices"][i]
                    piece["logprobs"] = {
                        "tokens": [tok.decode([t]) if tok is not None else str(t)
                                   for t in all_toks[i]],
                        "token_logprobs": loop.logprobs(r),
                        "top_logprobs": None,
                        "text_offset": [],
                    }
            return out

        def _stream(self, rid, chat, model, max_tokens):
            """A streamed answer, chunked: NDJSON, or server-sent events in
            the OpenAI schema."""
            self.send_response(200)
            ctype = "text/event-stream" if model is not None else "application/x-ndjson"
            self.send_header("Content-Type", ctype)
            self.send_header("Transfer-Encoding", "chunked")
            self.end_headers()

            def chunk_raw(data: bytes):
                self.wfile.write(f"{len(data):x}\r\n".encode() + data + b"\r\n")
                self.wfile.flush()

            def sse(obj) -> None:
                body = obj if isinstance(obj, str) else json.dumps(obj)
                chunk_raw(f"data: {body}\n\n".encode())

            created = int(time.time())
            tok = loop.tokenizer
            toks = []
            try:
                if chat:
                    # role chunk, per-token content deltas, finish chunk, [DONE]
                    def chat_chunk(delta, finish=None):
                        sse({
                            "id": f"chatcmpl-{rid}",
                            "object": "chat.completion.chunk",
                            "created": created,
                            "model": model,
                            "choices": [{"index": 0, "delta": delta, "finish_reason": finish}],
                        })

                    chat_chunk({"role": "assistant"})
                    for t in loop.stream_tokens(rid):
                        toks.append(t)
                        chat_chunk({"content": tok.decode([t])})
                    chat_chunk({}, finish=_finish_reason(len(toks), max_tokens))
                    sse("[DONE]")
                elif model is not None:
                    # per-token text deltas, a final chunk with the finish
                    # reason, then [DONE]
                    def completion_chunk(text, ids, finish=None):
                        sse({
                            "id": f"cmpl-{rid}",
                            "object": "text_completion",
                            "created": created,
                            "model": model,
                            "choices": [{"index": 0, "text": text, "token_ids": ids,
                                         "finish_reason": finish}],
                        })

                    for t in loop.stream_tokens(rid):
                        toks.append(t)
                        completion_chunk(tok.decode([t]) if tok is not None else "", [t])
                    completion_chunk("", [], _finish_reason(len(toks), max_tokens))
                    sse("[DONE]")
                else:
                    # newline-delimited JSON, token by token
                    for t in loop.stream_tokens(rid):
                        toks.append(t)
                        chunk_raw((json.dumps({"token": t}) + "\n").encode())
                    final: dict = {"done": True, "id": rid, "tokens": toks}
                    if tok is not None:
                        final["text"] = tok.decode(toks)
                    chunk_raw((json.dumps(final) + "\n").encode())
                self.wfile.write(b"0\r\n\r\n")
                self.wfile.flush()
            except (BrokenPipeError, ConnectionResetError):
                pass  # the client went away mid-stream

    return Handler


def serve(
    engine,
    host: str = "127.0.0.1",
    port: int = 8000,
    tokenizer=None,
    model_id: str = "flute-tpu",
) -> ThreadingHTTPServer:
    """Start the HTTP server (non-blocking; returns the server object, its
    port in ``server.server_address[1]``). Stop it with
    ``server.shutdown()`` and ``server.loop.shutdown()``."""
    loop = ServingLoop(engine, tokenizer, model_id=model_id)
    server = ThreadingHTTPServer((host, port), make_handler(loop))
    server.loop = loop  # type: ignore[attr-defined]
    threading.Thread(target=server.serve_forever, daemon=True).start()
    return server
