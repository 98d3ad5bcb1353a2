"""The port's profiling helpers (``flute_tpu_torch.utils.profiling``), on
the CPU: ``device_trace`` writes a Chrome trace that holds an ``annotate``
region and the ops inside it, ``timed`` logs its region's time, and
``log_event`` logs one line of sorted JSON, as the JAX helpers
(``flute_tpu/utils/profiling.py``) do."""

import json
import logging
import os

import torch

from flute_tpu_torch.utils import profiling


def test_device_trace_writes_the_annotated_region(tmp_path):
    x = torch.randn(64, 64)
    with profiling.device_trace(str(tmp_path / "trace")) as prof:
        with profiling.annotate("flute/matmul-region"):
            y = x @ x
    path = tmp_path / "trace" / profiling.TRACE_FILE
    assert path.is_file() and os.path.getsize(path) > 0
    trace = json.loads(path.read_text())
    names = [ev.get("name") for ev in trace["traceEvents"]]
    assert "flute/matmul-region" in names
    assert any(n in ("aten::mm", "aten::matmul") for n in names)
    keys = {ev.key for ev in prof.key_averages()}
    assert "flute/matmul-region" in keys
    assert torch.equal(y, x @ x)


def test_annotate_outside_a_trace_is_a_no_op():
    with profiling.annotate("nothing-records-this"):
        assert torch.ones(2).sum() == 2


def test_timed_logs(caplog):
    with caplog.at_level(logging.INFO, logger="flute_tpu_torch"):
        with profiling.timed("quantize step"):
            pass
        with profiling.timed("synced step", sync=True):
            pass
    msgs = [r.getMessage() for r in caplog.records]
    assert any(m.startswith("quantize step took ") and m.endswith("s") for m in msgs)
    assert any(m.startswith("synced step took ") for m in msgs)


def test_log_event_prints_sorted_json(caplog):
    with caplog.at_level(logging.INFO, logger="flute_tpu_torch"):
        profiling.log_event("tuned", shape=(8, 4096), b=2, a="x")
    (msg,) = [r.getMessage() for r in caplog.records]
    event, payload = msg.split(" ", 1)
    assert event == "tuned"
    assert payload == '{"a": "x", "b": 2, "shape": [8, 4096]}'
    assert list(json.loads(payload)) == ["a", "b", "shape"]
