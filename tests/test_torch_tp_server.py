"""``serve --tp 2`` on the CPU: the port's multi-process HTTP server, in which
rank 0 answers clients and every rank steps its own shard of the engine in
lock step over a gloo world (``flute_tpu_torch.integrations.cli``,
``serving.server.follow``, ``parallel.launch.start``), on the tiny Llama
checkpoints of ``test_torch_cli`` (the port's 4-bit and 2-bit ones and
JAX's 4-bit one).

Three servers run as subprocesses of ``python -m
flute_tpu_torch.integrations.cli serve --tp 2 --port 0 --device cpu``: the
continuous engine, the paged engine with pool prefill, and the paged
speculative engine with the 2-bit draft. Their streamed and plain greedy
tokens are the tp = 1 server's (in this process); the continuous one's
are JAX's own ``serve --tp 2`` engine's up to JAX's first near tie; a
sampled request with a seed repeats; an unfittable request is answered
400; ``/metrics`` counts. A world of ``launch.start`` runs the serving
loop with a rank function of ``torch_tp_ranks``: every rank completes the
same requests with the same tokens, and a server idle past the process
group's timeout still serves (its heartbeat). ``--tp 3`` is refused with
``validate_tp``'s message before a port is bound; SIGINT to the server's
process group ends every rank with exit code 0; a killed follower makes
the server exit nonzero. About a minute here.
"""

import json
import os
import re
import select
import signal
import subprocess
import sys
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch
import torch_tp_ranks
from test_torch_cli import BF16_RTOL, CPU, PROMPT, dirs  # noqa: F401 (a fixture)

from flute_tpu.integrations import cli as jcli
from flute_tpu.integrations import huggingface as jhf
from flute_tpu.parallel import validate_tp as jvalidate_tp
from flute_tpu.serving import Engine as JEngine
from flute_tpu_torch.integrations import cli
from flute_tpu_torch.parallel import launch
from flute_tpu_torch.serving import server

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NEW = 6
PROMPTS = [[int(t) for t in PROMPT.split()], [3, 17, 42, 9], [11, 5, 8, 1, 13, 2, 7]]
COMMON = ["--num-slots", "2", "--max-len", "64", "--block-size", "8", "--num-blocks", "24"]
SAMPLED = dict(temperature=0.9, top_k=40, seed=7)
START_S = 120  # a server's start, under a loaded test host


def modes(dirs):
    return {"continuous": [],
            "paged": ["--paged", "--pool-prefill"],
            "spec": ["--paged", "--draft-checkpoint", dirs["w2"], "--speculative-k", "2"]}


def serve_argv(dirs, *extra):
    return ["serve", "--checkpoint", dirs["w4"], *COMMON, *extra, *CPU]


def start_server(argv):
    """``python -m flute_tpu_torch.integrations.cli`` with ``argv`` in a
    process group of its own, one intra-op thread a rank."""
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join([REPO, os.environ.get("PYTHONPATH", "")]))
    return subprocess.Popen([sys.executable, "-m", "flute_tpu_torch.integrations.cli", *argv],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=REPO,
                            env=env, start_new_session=True)


def read_url(proc) -> str:
    """The URL the server prints, or the failure with its errors."""
    ready, _, _ = select.select([proc.stdout], [], [], START_S)
    line = proc.stdout.readline() if ready else ""
    if not line.startswith("serving on "):
        proc.kill()
        raise AssertionError(f"no URL within {START_S} s: {line!r} {proc.stderr.read()[-3000:]}")
    return line.split()[-1]


def ranks_of(proc) -> list[int]:
    """The server's rank processes: its children whose command line is
    multiprocessing's spawn_main, each the leader of its thread group (a
    kernel may list a child's threads), in start order."""
    with open(f"/proc/{proc.pid}/task/{proc.pid}/children") as f:
        pids = [int(p) for p in f.read().split()]
    out = []
    for pid in pids:
        try:
            with open(f"/proc/{pid}/status") as f:
                tgid = int(re.search(r"^Tgid:\s+(\d+)", f.read(), re.M).group(1))
            with open(f"/proc/{pid}/cmdline", "rb") as f:
                if tgid == pid and b"spawn_main" in f.read():
                    out.append(pid)
        except FileNotFoundError:  # a thread that has ended
            continue
    return out


def gone(pid) -> bool:
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().split(")")[-1].split()[0] == "Z"
    except FileNotFoundError:
        return True


def post(url, payload) -> tuple:
    """(status, tokens or error) of a completion request, plain or streamed."""
    req = urllib.request.Request(url, data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            lines = r.read().decode().strip().splitlines()
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())["error"]
    if payload.get("stream"):
        toks = [json.loads(ln)["token"] for ln in lines[:-1]]
        assert json.loads(lines[-1])["tokens"] == toks
        return 200, toks
    return 200, json.loads(lines[0])["tokens"]


def greedy_answers(url) -> list:
    """Each prompt plain, then streamed."""
    return [post(url, {"prompt": p, "max_tokens": NEW, "stream": s})
            for p in PROMPTS for s in (False, True)]


@pytest.fixture(scope="module")
def servers(dirs):
    """The three tp = 2 servers, started together: {mode: (process, URL)}."""
    procs = {m: start_server(serve_argv(dirs, "--tp", "2", "--port", "0", *extra))
             for m, extra in modes(dirs).items()}
    try:
        yield {m: (p, read_url(p)) for m, p in procs.items()}
    finally:
        for p in procs.values():
            if p.poll() is None:
                os.killpg(p.pid, signal.SIGKILL)
                p.wait()


@pytest.fixture(scope="module")
def tp1_answers(dirs):
    """The same requests to the tp = 1 server of each mode, in this process."""
    out = {}
    for m, extra in modes(dirs).items():
        eng, tok = cli.build_serve_engine(cli.build_parser().parse_args(serve_argv(dirs, *extra)))
        srv = server.serve(eng, port=0, tokenizer=tok)
        try:
            out[m] = greedy_answers(f"http://127.0.0.1:{srv.server_address[1]}/v1/completions")
        finally:
            srv.shutdown()
            srv.loop.shutdown()
    return out


@pytest.mark.parametrize("mode", ["continuous", "paged", "spec"])
def test_tp2_server_gives_the_tp1_servers_tokens(servers, tp1_answers, mode):
    got = greedy_answers(servers[mode][1])
    assert all(status == 200 and len(toks) == NEW for status, toks in got)
    assert got == tp1_answers[mode]


def jax_decided_along(checkpoint, tokens):
    """Which of ``tokens`` (greedy, after PROMPT) JAX's Engine decides: its
    own logits along them, the argmax equal to the token and the top-1/top-2
    margin above twice the bf16 threshold of the largest logit."""
    import jax.numpy as jnp

    params, config, _ = jhf.load_quantized_model(checkpoint)
    eng = JEngine(params=params, config=config, max_len=32, batch_size=1)
    toks = np.zeros((1, 16), np.int32)
    toks[0, 16 - len(PROMPTS[0]):] = PROMPTS[0]
    offs = jnp.asarray([16 - len(PROMPTS[0])], jnp.int32)
    logits, cache = eng._prefill(params, jnp.asarray(toks), eng._new_cache(), offs)
    steps = [np.asarray(logits)[0]]
    for s, t in enumerate(tokens[:-1]):
        logits, cache = eng._decode(params, jnp.asarray([[t]], jnp.int32), cache,
                                    jnp.int32(16 + s), offs)
        steps.append(np.asarray(logits)[0])
    steps = np.stack(steps)
    top2 = np.sort(steps, axis=-1)[:, -2:]
    return ((steps.argmax(-1) == np.asarray(tokens))
            & ((top2[:, 1] - top2[:, 0]) > 2 * BF16_RTOL * np.abs(steps).max(axis=-1)))


def test_tp2_server_gives_jax_tp2_engines_tokens(dirs, servers, monkeypatch):
    """JAX's ``build_serve_engine`` with ``--tp 2`` (a mesh of two of the
    CPU devices) driven directly, against the port's server over HTTP."""
    monkeypatch.setenv("HF_HUB_OFFLINE", "1")
    args = jcli.build_parser().parse_args(
        ["serve", "--checkpoint", dirs["jax"], "--tp", "2", *COMMON])
    eng, _ = jcli.build_serve_engine(args)
    assert eng.mesh is not None
    rid = eng.submit(PROMPTS[0], max_new_tokens=NEW)
    want = eng.run()[rid]
    decided = jax_decided_along(dirs["jax"], want)
    tie = int(np.argmin(decided)) if not decided.all() else NEW
    assert tie >= 1, "JAX's first token is a near tie: the test would say nothing"
    status, got = post(servers["continuous"][1], {"prompt": PROMPTS[0], "max_tokens": NEW})
    assert status == 200 and got[:tie] == want[:tie]


def test_sampled_request_repeats(servers):
    url = servers["paged"][1]
    req = dict(prompt=PROMPTS[1], max_tokens=NEW, **SAMPLED)
    first = post(url, req)
    assert first[0] == 200 and len(first[1]) == NEW
    assert post(url, dict(req, stream=True)) == first


def metrics(url) -> dict:
    with urllib.request.urlopen(url.replace("/v1/completions", "/metrics"), timeout=60) as r:
        return {k: float(v) for k, v in (ln.split() for ln in r.read().decode().splitlines()
                                         if ln and not ln.startswith("#"))}


def test_refusals_and_metrics(servers):
    url = servers["spec"][1]
    before = metrics(url)
    for stream in (False, True):
        status, err = post(url, {"prompt": [1] * 60, "max_tokens": 20, "stream": stream})
        assert status == 400 and "exceeds max_len" in err
    assert post(url, {"prompt": PROMPTS[2], "max_tokens": NEW})[0] == 200
    after = metrics(url)
    assert after["flute_requests_total"] - before["flute_requests_total"] == 3
    assert after["flute_completed_total"] - before["flute_completed_total"] == 1
    assert after["flute_tokens_generated_total"] - before["flute_tokens_generated_total"] == NEW
    assert after["flute_paged_blocks_in_use"] == 0


def test_every_rank_completes_the_same_requests(dirs):
    """The paged engine with pool prefill in a world of 2 whose collective
    timeout (6 s) is shorter than the server's idle spell (7 s): the
    heartbeat keeps the follower waiting within it."""
    argv = serve_argv(dirs, "--tp", "2", "--paged", "--pool-prefill")
    reqs = [dict(prompt=p, max_tokens=NEW, stream=i == 2) for i, p in enumerate(PROMPTS)]
    reqs.append(dict(prompt=PROMPTS[1], max_tokens=NEW, **SAMPLED))
    world = launch.start(torch_tp_ranks.http_serve_rank, 2, argv, reqs, 7.0, 0.5,
                         collective_timeout=6.0, threads=1)
    try:
        deadline = time.monotonic() + 120
        while not world.join(timeout=0.5):
            if time.monotonic() > deadline:
                world.terminate()
                raise TimeoutError("the world ran past 120 s")
        ranks = world.results()
    finally:
        world.close()
    answers, followed = ranks
    assert sorted(rid for rid, _ in answers) == list(range(len(reqs) + 1))
    assert dict(answers) == followed
    assert all(len(toks) == NEW for _, toks in answers)
    assert answers[-1][1] == answers[0][1]  # the first request again, after the idle spell


def test_tp_that_does_not_split_is_refused_before_binding(dirs):
    params, config, _ = jhf.load_quantized_model(dirs["jax"])
    with pytest.raises(ValueError) as e:
        jvalidate_tp(params, config, tp=3)
    proc = start_server(serve_argv(dirs, "--tp", "3", "--port", "0"))
    out, err = proc.communicate(timeout=START_S)
    assert proc.returncode != 0 and "serving on" not in out
    assert err.strip().splitlines()[-1] == f"serve --tp 3: {e.value}"


def test_sigint_stops_every_rank(servers):
    """A Ctrl-C reaches the server's whole process group: the ranks ignore
    it, the server stops them in order and exits 0."""
    for mode in ("continuous", "paged"):
        proc = servers[mode][0]
        ranks = ranks_of(proc)
        assert len(ranks) == 2
        os.killpg(proc.pid, signal.SIGINT)
        assert proc.wait(timeout=30) == 0, proc.stderr.read()[-3000:]
        deadline = time.monotonic() + 30
        while not all(gone(r) for r in ranks) and time.monotonic() < deadline:
            time.sleep(0.2)
        assert all(gone(r) for r in ranks)


def test_a_dead_follower_ends_the_server(servers):
    proc = servers["spec"][0]
    follower = ranks_of(proc)[1]
    os.kill(follower, signal.SIGKILL)
    assert proc.wait(timeout=60) != 0
    assert "terminated with signal SIGKILL" in proc.stderr.read()


def test_serve_tp_refusals_before_a_rank_starts(dirs):
    """No GPU and no ``--device cpu``: a refusal, not a CPU server; and
    ``--retune``, which would tune at the whole model's shapes."""
    argv = ["serve", "--checkpoint", dirs["w4"], "--tp", "2"]
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit, match="no CUDA device"):
            cli.main(argv)
    with pytest.raises(SystemExit, match="--retune"):
        cli.main(argv + ["--retune", *CPU])
