"""The benchmark's inputs: a served model's weights, made on the device
from the run's seed.

Both sides take them from here: the program quantizes or packs them
(``harness/system.py``), the reference works out the format from them again
(``reference/quant.py``). Each group of tensors is drawn by its own
``torch.Generator`` on the device, seeded from (seed, layer, what), in one
call a layer, so that the reference can make layer ``i`` again on its own
after the window and gets the same values.

* ``w4sym``: dense bfloat16 ``[in, out]`` weights, normal with the
  configuration's ``initializer_range`` as standard deviation, one flat draw
  a layer split into the fused ``qkv``, ``o``, ``gate_up`` and ``down``.
* ``higgs``: what a HIGGS checkpoint holds: uniform 8-bit vector codes
  ``[in / 2, out]``, bfloat16 group scales uniform in [0.015, 0.025) and one
  ``[256, 2]`` standard-normal grid for the model, so that a weight has
  about the same spread as the dense draw.
* Embedding and head: dense bfloat16, as the dense weights. The norms'
  weights are ones on both sides.
"""

from __future__ import annotations

import torch

from .counts import projections

_MASK64 = (1 << 64) - 1
_TAGS = {"embed": 1, "head": 2, "dense": 3, "codes": 4, "scales": 5, "grid": 6}


def mix_seed(seed: int, *parts: int) -> int:
    """A 63-bit generator seed from the run's seed and ``parts``
    (splitmix64 rounds)."""
    z = seed & _MASK64
    for p in parts:
        z = (z * 0x9E3779B97F4A7C15 + p + 0x632BE59BD9B4E019) & _MASK64
        z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
        z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
        z ^= z >> 31
    return z >> 1


class Inputs:
    """The weights of ``model`` (a configuration file's content) for
    ``seed`` on ``device``."""

    def __init__(self, model: dict, seed: int, device):
        self.model = model
        self.seed = int(seed)
        self.device = torch.device(device)
        self.std = float(model["initializer_range"])
        self.format = model["quant"]["format"]

    def _gen(self, *parts: int) -> torch.Generator:
        g = torch.Generator(device=self.device)
        g.manual_seed(mix_seed(self.seed, *parts))
        return g

    def _normal(self, n: int, *parts: int) -> torch.Tensor:
        w = torch.randn((n,), generator=self._gen(*parts), device=self.device,
                        dtype=torch.bfloat16)
        return w.mul_(self.std)

    def embed(self) -> torch.Tensor:
        v, hid = self.model["vocab_size"], self.model["hidden_size"]
        return self._normal(v * hid, _TAGS["embed"]).reshape(v, hid)

    def head(self) -> torch.Tensor:
        v, hid = self.model["vocab_size"], self.model["hidden_size"]
        return self._normal(hid * v, _TAGS["head"]).reshape(hid, v)

    def grid(self) -> torch.Tensor:
        return torch.randn((256, 2), generator=self._gen(_TAGS["grid"]), device=self.device,
                           dtype=torch.float32)

    def layer(self, i: int) -> dict:
        """Layer ``i``'s weights: ``{name: [in, out] bf16}`` (w4sym) or
        ``{"grid": ..., name: {"codes", "scales"}}`` (HIGGS)."""
        shapes = projections(self.model)
        if self.format == "w4sym":
            flat = self._normal(sum(k * n for k, n in shapes.values()), _TAGS["dense"], i)
            out, at = {}, 0
            for name, (k, n) in shapes.items():
                out[name] = flat[at:at + k * n].view(k, n)
                at += k * n
            return out
        if self.format == "higgs":
            g = self.model["quant"]["group_size"]
            codes = torch.randint(0, 256, (sum(k * n // 2 for k, n in shapes.values()),),
                                  generator=self._gen(_TAGS["codes"], i), device=self.device,
                                  dtype=torch.uint8)
            scales = torch.rand((sum(k * n // g for k, n in shapes.values()),),
                                generator=self._gen(_TAGS["scales"], i), device=self.device,
                                dtype=torch.float32).mul_(0.01).add_(0.015).to(torch.bfloat16)
            out, ac, asc = {"grid": self.grid()}, 0, 0
            for name, (k, n) in shapes.items():
                out[name] = {"codes": codes[ac:ac + k * n // 2].view(k // 2, n),
                             "scales": scales[asc:asc + k * n // g].view(k // g, n)}
                ac += k * n // 2
                asc += k * n // g
            return out
        raise ValueError(f"unknown format {self.format!r}")
