"""The port's HTTP server (``flute_tpu_torch.serving.server``) on
``LlamaConfig.tiny()``, every test of ``tests/test_server.py`` mirrored, and
the server held against the JAX package.

* Against JAX: the three prompts of ``tests/test_torch_engine.py`` sent
  concurrently over HTTP to the port's ``ContinuousBatchingEngine`` (two
  slots, ``max_len`` 32), and JAX's ``ContinuousBatchingEngine`` run
  directly on the same params (made by the JAX package, carried over by
  ``interop.params_from_numpy``): tokens identical before the first step
  where JAX's top-1/top-2 margin is within twice the bf16 threshold.
* The port alone: streams (NDJSON and server-sent events) equal the whole
  answer; ``n`` choices equal direct submissions with seeds ``seed + i``;
  chat equals a completion on the templated prompt; metrics count what was
  sent and received; malformed requests, and requests the engine refuses
  (streamed ones too, where the JAX server answers nothing), get 400;
  ``PagedEngine``, ``PagedSpeculativeEngine`` and Gemma-2 with its
  quantized tied head behind the server.

Every HTTP call carries a timeout, and every server is shut down.
"""

import contextlib
import json
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch
from test_torch_continuous import first_ties
from test_torch_engine import BF16_RTOL, build_models, jax_trajectory

from flute_tpu.serving.continuous import ContinuousBatchingEngine as JContinuous
from flute_tpu_torch.models import gemma2
from flute_tpu_torch.serving import (
    ContinuousBatchingEngine,
    PagedEngine,
    PagedSpeculativeEngine,
    SamplingParams,
)
from flute_tpu_torch.serving.server import serve

TIMEOUT = 60  # seconds, for every HTTP call
NEW_TOKENS = 8


@pytest.fixture(autouse=True, scope="module")
def few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def models():
    return build_models(4)


def continuous(config, params, **kw):
    kw = {"num_slots": 2, "max_len": 32, **kw}
    return ContinuousBatchingEngine(params=params, config=config, device="cpu", **kw)


@contextlib.contextmanager
def serving(engine, **kw):
    srv = serve(engine, port=0, **kw)
    try:
        yield srv
    finally:
        srv.shutdown()
        srv.server_close()
        srv.loop.shutdown()


@pytest.fixture(scope="module")
def server(models):
    _, _, config, tq, _ = models
    with serving(continuous(config, tq)) as srv:
        yield srv


def url(srv, path):
    return f"http://127.0.0.1:{srv.server_address[1]}{path}"


def post(srv, payload, path="/v1/completions"):
    req = urllib.request.Request(url(srv, path), data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=TIMEOUT) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def post_lines(srv, payload, path="/v1/completions"):
    """A streamed answer: its content type and its non-empty lines."""
    req = urllib.request.Request(url(srv, path), data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=TIMEOUT) as r:
        assert r.status == 200
        return r.headers["Content-Type"], [ln.decode().strip() for ln in r if ln.strip()]


def get(srv, path):
    with urllib.request.urlopen(url(srv, path), timeout=TIMEOUT) as r:
        return r.headers["Content-Type"], r.read().decode()


def metrics(srv) -> dict:
    ctype, text = get(srv, "/metrics")
    assert ctype.startswith("text/plain")
    vals = {}
    for ln in text.splitlines():
        if ln and not ln.startswith("#"):
            k, v = ln.split()
            vals[k] = float(v)
    return vals


def ndjson_tokens(lines):
    records = [json.loads(ln) for ln in lines]
    assert records[-1].get("done") is True
    toks = [rec["token"] for rec in records if "token" in rec]
    assert records[-1]["tokens"] == toks
    return toks


def sse_chunks(lines):
    assert all(ln.startswith("data: ") for ln in lines)
    assert lines[-1] == "data: [DONE]"
    return [json.loads(ln[6:]) for ln in lines[:-1]]


def direct(eng, prompt, n, **sampling):
    rid = eng.submit(prompt, max_new_tokens=n, sampling=SamplingParams(**sampling))
    return eng.run()[rid]


class StubTok:
    """The duck-typed tokenizer of ``tests/test_server.py``: the chat
    template flattens the messages' ids with a 7 after each; a token
    decodes to a space and its number."""

    eos_token_id = None

    def apply_chat_template(self, messages, add_generation_prompt=True):
        ids = []
        for m in messages:
            ids.extend(int(t) for t in m["content"].split())
            ids.append(7)
        return ids

    def __call__(self, text):
        return {"input_ids": [int(t) for t in text.split()]}

    def decode(self, toks):
        return "".join(f" {t}" for t in toks)


# -- against JAX -------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_continuous(models):
    """JAX's continuous engine on the three prompts (two slots, max_len 32),
    and the first near tie of each (JAX's dense Engine's logits)."""
    jconfig, jq, _, _, prompts = models
    jtokens, jlogits = jax_trajectory(jconfig, jq, prompts)
    jl = jlogits[:, :len(prompts)]
    top2 = np.sort(jl, axis=-1)[..., -2:]
    decided = (top2[..., 1] - top2[..., 0]) > 2 * BF16_RTOL * np.abs(jl).max(axis=-1)
    assert decided.mean() > 0.5, "too many near-ties for the test to say anything"
    jeng = JContinuous(params=jq, config=jconfig, num_slots=2, max_len=32)
    rids = [jeng.submit(p, max_new_tokens=NEW_TOKENS) for p in prompts]
    out = jeng.run()
    return [out[r] for r in rids], first_ties(decided)


def test_concurrent_greedy_matches_jax_continuous_engine(models, server, jax_continuous):
    """The three prompts as concurrent requests (one waits for a slot):
    each equals JAX's engine, run directly, before its first near tie."""
    prompts = models[4]
    results = {}

    def run(i):
        results[i] = post(server, {"prompt": prompts[i], "max_tokens": NEW_TOKENS})

    threads = [threading.Thread(target=run, args=(i,)) for i in range(len(prompts))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=TIMEOUT)
    want, ties = jax_continuous
    compared = 0
    for i, tie in enumerate(ties):
        code, out = results[i]
        assert code == 200 and len(out["tokens"]) == NEW_TOKENS
        assert out["tokens"][:tie] == want[i][:tie], i
        compared += tie
    assert compared >= len(prompts), ties


# -- tests/test_server.py, mirrored ------------------------------------------


def test_health(server):
    assert json.loads(get(server, "/health")[1])["status"] == "ok"


def test_single_completion(server):
    code, out = post(server, {"prompt": [1, 5, 9], "max_tokens": 4})
    assert code == 200 and len(out["tokens"]) == 4


def test_concurrent_requests(server, models):
    """Four concurrent requests on two slots: each equals a direct run of
    its prompt alone."""
    results = {}

    def run(i):
        results[i] = post(server, {"prompt": [1 + i, 5, 9], "max_tokens": 3})

    threads = [threading.Thread(target=run, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=TIMEOUT)
    assert len(results) == 4
    _, _, config, tq, _ = models
    for i, (code, out) in results.items():
        assert code == 200 and out["tokens"] == direct(continuous(config, tq), [1 + i, 5, 9], 3)


@pytest.mark.parametrize("payload", [
    {"prompt": "text not supported w/o tokenizer"},
    {"prompt": []},
    {"prompt": [1, 2], "n": 0},
    {"prompt": [1, 2], "n": 2, "stream": True},
    {"prompt": [1, 2], "max_tokens": "many"},
])
def test_bad_request(server, payload):
    code, out = post(server, payload)
    assert code == 400 and "error" in out


def test_unknown_path(server):
    code, out = post(server, {"prompt": [1]}, path="/v1/embeddings")
    assert code == 404 and "error" in out


def test_streaming_completion(server):
    """stream=true returns chunked NDJSON, one {"token": t} per token then a
    final {"done": true} record, equal to the non-streamed answer."""
    ctype, lines = post_lines(server, {"prompt": [1, 5, 9], "max_tokens": 4, "stream": True})
    assert ctype.startswith("application/x-ndjson")
    toks = ndjson_tokens(lines)
    assert len(toks) == 4
    code, out = post(server, {"prompt": [1, 5, 9], "max_tokens": 4})
    assert code == 200 and out["tokens"] == toks


def test_per_request_sampling(server):
    """Sampled output is deterministic per seed and differs across seeds;
    a greedy request beside sampled ones stays greedy."""
    def sample(seed):
        code, out = post(server, {"prompt": [2, 6, 10, 14], "max_tokens": 8,
                                  "temperature": 5.0, "top_p": 0.98, "seed": seed})
        assert code == 200
        return out["tokens"]

    a1, a2 = sample(7), sample(7)
    assert a1 == a2
    assert any(sample(s) != a1 for s in range(5))
    _, g1 = post(server, {"prompt": [1, 5, 9], "max_tokens": 4})
    _, g2 = post(server, {"prompt": [1, 5, 9], "max_tokens": 4, "temperature": 0.0})
    assert g1["tokens"] == g2["tokens"]


def test_openai_schema(server):
    """A request with "model" gets the OpenAI completions schema (object,
    usage, logprobs), its SSE stream ends in [DONE], and both carry the
    token ids of the plain answer; GET /v1/models lists the model."""
    _, legacy = post(server, {"prompt": [1, 5, 9], "max_tokens": 4})
    code, out = post(server, {"prompt": [1, 5, 9], "max_tokens": 4, "model": "tiny",
                              "logprobs": True})
    assert code == 200 and out["object"] == "text_completion" and out["model"] == "tiny"
    choice = out["choices"][0]
    lps = choice["logprobs"]["token_logprobs"]
    assert len(lps) == 4 and all(v <= 0.0 for v in lps)
    assert choice["token_ids"] == legacy["tokens"]
    assert choice["finish_reason"] == "length"
    assert out["usage"] == {"prompt_tokens": 3, "completion_tokens": 4, "total_tokens": 7}

    models = json.loads(get(server, "/v1/models")[1])
    assert models["object"] == "list" and models["data"][0]["object"] == "model"

    ctype, lines = post_lines(server, {"prompt": [1, 5, 9], "max_tokens": 4, "model": "tiny",
                                       "stream": True})
    assert ctype.startswith("text/event-stream")
    chunks = sse_chunks(lines)
    toks = [c["choices"][0]["token_ids"][0] for c in chunks if c["choices"][0]["token_ids"]]
    assert toks == legacy["tokens"]
    assert chunks[-1]["choices"][0]["finish_reason"] == "length"


def test_metrics_endpoint(models):
    """/metrics counts every request sent and every token received."""
    _, _, config, tq, _ = models
    with serving(continuous(config, tq)) as srv:
        before = metrics(srv)
        assert before["flute_requests_total"] == 0 and before["flute_uptime_seconds"] >= 0
        got = 0
        for p, n in (([2, 4, 6], 3), ([1, 5], 5)):
            code, out = post(srv, {"prompt": p, "max_tokens": n})
            got += len(out["tokens"])
        got += len(ndjson_tokens(post_lines(srv, {"prompt": [3], "max_tokens": 2,
                                                  "stream": True})[1]))
        vals = metrics(srv)
    assert vals["flute_requests_total"] == vals["flute_completed_total"] == 3
    assert vals["flute_tokens_generated_total"] == got == 10
    assert vals["flute_queue_depth"] == 0
    assert vals["flute_prefix_hits_total"] == 0


def test_n_completions(server, models):
    """"n" choices: choice i equals a direct submission with seed + i, the
    choices differ, usage counts them all; n > 1 needs the OpenAI schema."""
    req = {"prompt": [2, 6, 10, 14], "max_tokens": 6, "model": "tiny", "temperature": 5.0,
           "top_p": 0.98, "seed": 11}
    code, out = post(server, dict(req, n=3))
    assert code == 200 and [c["index"] for c in out["choices"]] == [0, 1, 2]
    ids = [c["token_ids"] for c in out["choices"]]
    assert len(set(map(tuple, ids))) > 1
    assert out["usage"]["completion_tokens"] == sum(len(t) for t in ids)
    _, _, config, tq, _ = models
    for i, got in enumerate(ids):
        want = direct(continuous(config, tq), [2, 6, 10, 14], 6, temperature=5.0, top_p=0.98,
                      seed=11 + i)
        assert got == want, i
    _, one = post(server, req)
    assert one["choices"][0]["token_ids"] == ids[0]
    code, _ = post(server, {"prompt": [1, 2], "max_tokens": 2, "n": 2})
    assert code == 400


def test_chat_completions(models):
    """/v1/chat/completions renders the messages through the tokenizer's
    chat template and answers in the OpenAI chat schema, whole or as an SSE
    stream; its ids equal a completion on the templated prompt; a text
    prompt goes through the tokenizer."""
    _, _, config, tq, _ = models
    with serving(continuous(config, tq), tokenizer=StubTok(), model_id="tiny-chat") as srv:
        msgs = [{"role": "user", "content": "1 5 9"}]
        _, want = post(srv, {"prompt": [1, 5, 9, 7], "max_tokens": 4})
        assert want["text"] == StubTok().decode(want["tokens"])
        _, text = post(srv, {"prompt": "1 5 9 7", "max_tokens": 4})
        assert text["tokens"] == want["tokens"]

        code, out = post(srv, {"messages": msgs, "max_tokens": 4}, path="/v1/chat/completions")
        assert code == 200 and out["object"] == "chat.completion"
        assert out["model"] == "tiny-chat"
        msg = out["choices"][0]["message"]
        assert msg["role"] == "assistant"
        assert msg["content"].split() == [str(t) for t in want["tokens"]]
        assert out["choices"][0]["finish_reason"] == "length"
        assert out["usage"]["prompt_tokens"] == 4

        _, lines = post_lines(srv, {"messages": msgs, "max_tokens": 4, "stream": True},
                              path="/v1/chat/completions")
        chunks = sse_chunks(lines)
        assert chunks[0]["choices"][0]["delta"] == {"role": "assistant"}
        content = "".join(c["choices"][0]["delta"].get("content", "") for c in chunks)
        assert content.split() == [str(t) for t in want["tokens"]]
        assert chunks[-1]["choices"][0]["finish_reason"] == "length"

        code, _ = post(srv, {"messages": [], "max_tokens": 4}, path="/v1/chat/completions")
        assert code == 400
    with serving(continuous(config, tq)) as srv:  # no tokenizer: no chat
        code, out = post(srv, {"messages": msgs}, path="/v1/chat/completions")
        assert code == 400 and "tokenizer" in out["error"]


def test_paged_engine_server(models):
    """PagedEngine behind the server: whole and streamed answers equal the
    continuous engine's; a request the pool cannot hold gets 400, streamed
    or not (the JAX server closes a streamed one without an answer: ROADMAP
    queue 3 item 25); no block stays in use."""
    _, _, config, tq, _ = models
    want = direct(continuous(config, tq), [1, 5, 9], 4)
    eng = PagedEngine(params=tq, config=config, num_slots=2, block_size=8, num_blocks=10,
                      max_len=32, device="cpu")
    with serving(eng) as srv:
        code, out = post(srv, {"prompt": [1, 5, 9], "max_tokens": 4})
        assert code == 200 and out["tokens"] == want
        _, lines = post_lines(srv, {"prompt": [1, 5, 9], "max_tokens": 4, "stream": True})
        assert ndjson_tokens(lines) == want
        for stream in (False, True):
            code, out = post(srv, {"prompt": [1, 5, 9], "max_tokens": 40, "stream": stream})
            assert code == 400 and "max_len" in out["error"]
        vals = metrics(srv)
    assert vals["flute_paged_blocks_in_use"] == 0 and eng.blocks_in_use == 0


def test_paged_speculative_server(models):
    """PagedSpeculativeEngine (self-draft, k=3) behind the server: a round
    emits several tokens, each streamed in order; the answer equals the
    continuous engine's; the spec gauges are exported."""
    _, _, config, tq, _ = models
    want = direct(continuous(config, tq), [1, 5, 9], 6)
    eng = PagedSpeculativeEngine(params=tq, config=config, draft_params=tq, draft_config=config,
                                 k=3, num_slots=2, block_size=8, num_blocks=12, max_len=32,
                                 device="cpu")
    with serving(eng) as srv:
        code, out = post(srv, {"prompt": [1, 5, 9], "max_tokens": 6})
        assert code == 200 and out["tokens"] == want
        _, lines = post_lines(srv, {"prompt": [1, 5, 9], "max_tokens": 6, "stream": True})
        assert ndjson_tokens(lines) == want
        vals = metrics(srv)
    assert eng.stats.bonus > 0
    assert vals["flute_spec_rounds_total"] == eng.stats.rounds > 0
    assert vals["flute_spec_bonus_total"] == eng.stats.bonus
    assert vals["flute_paged_blocks_in_use"] == 0


def test_gemma2_server():
    """Gemma-2 with its quantized tied head behind the server: the answer
    equals the same engine type run directly, and repeats."""
    config = gemma2.Gemma2Config.tiny()
    params = gemma2.init_params(config, seed=0, device="cpu")
    qparams = gemma2.quantize_model(params, 4, 64, quantize_lm_head=True, device="cpu")
    want = direct(continuous(config, qparams), [1, 5, 9], 4)
    with serving(continuous(config, qparams)) as srv:
        code, out = post(srv, {"prompt": [1, 5, 9], "max_tokens": 4})
        assert code == 200 and out["tokens"] == want
        assert post(srv, {"prompt": [1, 5, 9], "max_tokens": 4})[1]["tokens"] == want


def test_concurrent_stress(models):
    """Twenty-four requests from as many threads on two slots, with the
    interpreter switching threads every 10 µs: every request is answered
    with its budget, each equals its prompt's direct run, and the
    counters the handler and device threads share lose no update."""
    import sys

    _, _, config, tq, _ = models
    prompts = [[1 + i % 6, 5, 9] for i in range(24)]
    want = {p[0]: direct(continuous(config, tq), p, 2) for p in prompts[:6]}
    results = {}
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        with serving(continuous(config, tq)) as srv:
            threads = [threading.Thread(target=lambda i=i: results.__setitem__(
                i, post(srv, {"prompt": prompts[i], "max_tokens": 2}))) for i in range(24)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=TIMEOUT)
            assert not any(t.is_alive() for t in threads)
            vals = metrics(srv)
    finally:
        sys.setswitchinterval(interval)
    assert sorted(results) == list(range(24))
    for i, (code, out) in results.items():
        assert code == 200 and out["tokens"] == want[prompts[i][0]]
    assert vals["flute_requests_total"] == vals["flute_completed_total"] == 24
    assert vals["flute_tokens_generated_total"] == 48
