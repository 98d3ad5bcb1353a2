"""The port's CLI with ``--device cpu`` against the JAX package's CLI on a
seeded tiny Llama HF directory: ``quantize`` writes JAX's checkpoint files
(the manifest's TPU config keys aside) and ``generate`` gives JAX's tokens
up to JAX's first near tie (a top-1/top-2 margin within twice the bf16
threshold); ``generate --retune`` and ``generate --draft-checkpoint`` give
the plain tokens; ``calibrate`` writes an NFL checkpoint (``nfl: true``) that
``generate`` serves; ``serve``'s engine plumbing builds and drives the
continuous, paged (pool prefill) and paged speculative engines;
``bench-kernel`` raises, naming its ROADMAP item, and ``--device`` defaults
to ``cuda``. ``serve --tp 2`` is served (``test_torch_tp_server.py``)."""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
from test_torch_huggingface import jax_tiny, same_checkpoint, write_hf_dir
from test_torch_llama import to_numpy_tree

from flute_tpu.integrations import cli as jcli
from flute_tpu.integrations import huggingface as jhf
from flute_tpu.serving import Engine as JEngine
from flute_tpu_torch.integrations import cli
from flute_tpu_torch.integrations.huggingface import load_quantized_model
from flute_tpu_torch.nn import QuantizedLinear
from flute_tpu_torch.serving import ContinuousBatchingEngine, PagedEngine, PagedSpeculativeEngine

BF16_RTOL = 1.1e-2
PROMPT = "1 5 9 33 7"
NEW_TOKENS = 6
CPU = ["--device", "cpu"]


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    """An HF directory and its 4-bit quantization by each package's CLI, and
    the port's 2-bit quantization (a draft)."""
    root = tmp_path_factory.mktemp("cli")
    config, params = jax_tiny()
    hf = str(root / "hf")
    write_hf_dir(hf, config, to_numpy_tree(params))
    out = {"hf": hf, "w4": str(root / "w4"), "w2": str(root / "w2"), "jax": str(root / "jax")}
    cli.main(["quantize", "--model-dir", hf, "--output-dir", out["w4"]] + CPU)
    cli.main(["quantize", "--model-dir", hf, "--output-dir", out["w2"], "--num-bits", "2"] + CPU)
    jcli.main(["quantize", "--model-dir", hf, "--output-dir", out["jax"]])
    return out


def generate(capsys, main, checkpoint, *extra):
    main(["generate", "--checkpoint", checkpoint, "--prompt", PROMPT,
          "--max-new-tokens", str(NEW_TOKENS), "--max-len", "32", *extra])
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def jax_decided(checkpoint, tokens):
    """Which of JAX's greedy steps are decided: its Engine's own logits
    along its tokens, the top-1/top-2 margin above twice the bf16
    threshold of the largest logit."""
    params, config, _ = jhf.load_quantized_model(checkpoint)
    eng = JEngine(params=params, config=config, max_len=32, batch_size=1)
    prompt = [int(t) for t in PROMPT.split()]
    toks = np.zeros((1, 16), np.int32)
    toks[0, 16 - len(prompt):] = prompt
    offs = jnp.asarray([16 - len(prompt)], jnp.int32)
    logits, cache = eng._prefill(params, jnp.asarray(toks), eng._new_cache(), offs)
    steps = [np.asarray(logits)[0]]
    for s, t in enumerate(tokens[:-1]):
        logits, cache = eng._decode(params, jnp.asarray([[t]], jnp.int32), cache,
                                    jnp.int32(16 + s), offs)
        steps.append(np.asarray(logits)[0])
    steps = np.stack(steps)
    assert steps.argmax(-1).tolist() == tokens
    top2 = np.sort(steps, axis=-1)[:, -2:]
    return (top2[:, 1] - top2[:, 0]) > 2 * BF16_RTOL * np.abs(steps).max(axis=-1)


def test_quantize_and_generate_match_jax(dirs, capsys):
    same_checkpoint(dirs["w4"], dirs["jax"])
    got = generate(capsys, cli.main, dirs["w4"], *CPU)
    want = generate(capsys, jcli.main, dirs["jax"])
    assert len(got) == len(want) == NEW_TOKENS
    decided = jax_decided(dirs["jax"], want)
    tie = int(np.argmin(decided)) if not decided.all() else NEW_TOKENS
    assert tie >= 1, "JAX's first token is a near tie: the test would say nothing"
    assert got[:tie] == want[:tie]


def test_generate_retune_and_speculative_give_the_plain_tokens(dirs, capsys):
    plain = generate(capsys, cli.main, dirs["w4"], *CPU)
    assert generate(capsys, cli.main, dirs["w4"], "--retune", *CPU) == plain
    spec = generate(capsys, cli.main, dirs["w4"], "--draft-checkpoint", dirs["w2"],
                    "--speculate-k", "3", *CPU)
    assert spec == plain


def test_calibrate_writes_an_nfl_checkpoint(dirs, tmp_path, capsys):
    toks = np.random.default_rng(0).integers(0, 100, 4096).astype(np.int32)
    np.save(tmp_path / "toks.npy", toks)
    out = str(tmp_path / "nfl")
    cli.main(["calibrate", "--model-dir", dirs["hf"], "--output-dir", out,
              "--tokens-npy", str(tmp_path / "toks.npy"), "--steps", "2",
              "--batch-size", "1", "--seq-len", "32"] + CPU)
    printed = capsys.readouterr().out
    assert "step 0: loss" in printed and "step 1: loss" in printed
    with open(os.path.join(out, "flute_config.json")) as f:
        assert json.load(f)["model_config"]["nfl"] is True
    params, config, _ = load_quantized_model(out, device="cpu")
    assert config is not None
    layer = params["layers"][0]["q"]
    assert isinstance(layer, QuantizedLinear) and layer.layout == "w4sym"
    assert len(generate(capsys, cli.main, out, *CPU)) == NEW_TOKENS


def serve_args(dirs, *extra):
    return cli.build_parser().parse_args(
        ["serve", "--checkpoint", dirs["w4"], "--num-slots", "2", "--max-len", "64",
         "--block-size", "8", "--num-blocks", "24", *extra] + CPU)


def test_serve_engine_plumbing(dirs, capsys):
    plain = generate(capsys, cli.main, dirs["w4"], *CPU)
    prompt = [int(t) for t in PROMPT.split()]
    cases = [([], ContinuousBatchingEngine),
             (["--paged", "--pool-prefill"], PagedEngine),
             (["--paged", "--draft-checkpoint", dirs["w2"], "--speculative-k", "2"],
              PagedSpeculativeEngine)]
    for extra, kind in cases:
        eng, tok = cli.build_serve_engine(serve_args(dirs, *extra))
        assert type(eng) is kind and tok is None
        if kind is not ContinuousBatchingEngine:
            assert eng.pool_prefill == ("--pool-prefill" in extra)
        rid = eng.submit(prompt, max_new_tokens=NEW_TOKENS)
        out = eng.run()
        assert len(out[rid]) == NEW_TOKENS
        assert out[rid] == plain, extra
    assert eng.k == 2
    with pytest.raises(SystemExit):
        cli.build_serve_engine(serve_args(dirs, "--draft-checkpoint", dirs["w2"]))


def test_unported_paths_raise_naming_their_items():
    with pytest.raises(NotImplementedError, match="item 9"):
        cli.main(["bench-kernel"])
    args = cli.build_parser().parse_args(["generate", "--checkpoint", "x", "--prompt", "1"])
    assert args.device == "cuda"
