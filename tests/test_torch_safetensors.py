"""The port's safetensors reader and writer against the ``safetensors``
package: the writer's files are byte-for-byte the package's for the same
tensors (bf16, f16, f32, int32, uint8, alone, mixed, with metadata), and the
reader gives the package's tensors back, bit for bit, from its files."""

import numpy as np
import pytest
import torch

safetensors = pytest.importorskip("safetensors")
from safetensors.numpy import save_file as np_save_file  # noqa: E402
from safetensors.torch import load_file as pt_load_file  # noqa: E402
from safetensors.torch import save_file as pt_save_file  # noqa: E402

from flute_tpu_torch.integrations import safetensors_io  # noqa: E402

DTYPES = [torch.bfloat16, torch.float16, torch.float32, torch.int32, torch.uint8]


def tensors(dtypes, seed=0):
    g = torch.Generator().manual_seed(seed)
    out = {}
    for i, dt in enumerate(dtypes):
        shape = (3 + i, 5) if i % 2 else (7 + i,)
        if dt.is_floating_point:
            t = torch.randn(shape, generator=g).to(dt)
        else:
            t = torch.randint(0, 200, shape, generator=g).to(dt)
        out[f"t{len(dtypes) - i}.{str(dt).split('.')[-1]}"] = t
    return out


@pytest.mark.parametrize("dtypes", [[d] for d in DTYPES] + [DTYPES, DTYPES[::-1]],
                         ids=lambda ds: "+".join(str(d).split(".")[-1] for d in ds))
@pytest.mark.parametrize("metadata", [None, {"format": "pt"}])
def test_writer_bytes_equal_the_package(tmp_path, dtypes, metadata):
    ts = tensors(dtypes)
    pt_save_file(ts, str(tmp_path / "a.safetensors"), metadata=metadata)
    safetensors_io.save_file(ts, str(tmp_path / "b.safetensors"), metadata=metadata)
    assert (tmp_path / "a.safetensors").read_bytes() == (tmp_path / "b.safetensors").read_bytes()


@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: str(d).split(".")[-1])
def test_reader_reads_the_package(tmp_path, dtype):
    ts = tensors([dtype, torch.float32, torch.uint8], seed=3)
    ts["empty"] = torch.zeros((0, 4), dtype=dtype)
    path = str(tmp_path / "m.safetensors")
    pt_save_file(ts, path, metadata={"format": "pt"})
    got = safetensors_io.load_file(path)
    want = pt_load_file(path)
    assert list(got) == sorted(want)
    for name, t in want.items():
        assert got[name].dtype == t.dtype and torch.equal(got[name], t)
    with safetensors_io.SafeOpen(path) as f:
        assert f.metadata() == {"format": "pt"}
        assert torch.equal(f.get_tensor(list(want)[0]), want[list(want)[0]])


def test_numpy_arrays_round_trip(tmp_path):
    """Arrays written by the package's numpy writer read back; numpy arrays
    given to the port's writer give the package's bytes."""
    rng = np.random.default_rng(5)
    arrays = {"w": rng.standard_normal((4, 6)).astype(np.float32),
              "c": rng.integers(0, 16, (9,)).astype(np.int32),
              "u": rng.integers(0, 255, (11,)).astype(np.uint8),
              "h": rng.standard_normal(5).astype(np.float16)}
    np_save_file(arrays, str(tmp_path / "a.safetensors"))
    safetensors_io.save_file(arrays, str(tmp_path / "b.safetensors"))
    assert (tmp_path / "a.safetensors").read_bytes() == (tmp_path / "b.safetensors").read_bytes()
    got = dict(safetensors_io.iter_dir(str(tmp_path)))
    for name, a in arrays.items():
        np.testing.assert_array_equal(got[name].numpy(), a)
