"""The benchmark's weights, made on the device from the run's seed.

Every tensor of a layer comes out of one ``normal_`` call of a generator
seeded from (seed, layer), so the program and the reference each ask for the
same layer and get the same values, the reference one layer at a time after
the window.  Linear weights and biases are N(0, 0.02) (the init of the HF
families); norm scales are 1 + N(0, 0.02) and norm shifts N(0, 0.02), so
that every parameter the forward reads is non-trivial.

A spec is a list of ``(name, shape, kind)``, ``kind`` one of ``w`` (weight
or bias), ``scale`` (a norm's scale) and ``shift`` (a norm's shift).
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

STD = 0.02
Spec = List[Tuple[str, tuple, str]]


def mix(seed: int, *salt: int) -> int:
    """A 63-bit generator seed from the run's seed and a few small ints."""
    h = int(seed) & 0xFFFFFFFFFFFFFFFF
    for s in salt:
        h = (h * 6364136223846793005 + 1442695040888963407 + int(s)) & 0xFFFFFFFFFFFFFFFF
    return h & 0x7FFFFFFFFFFFFFFF


def generate(spec: Spec, seed: int, salt: int, device,
             dtype=torch.float32) -> Dict[str, torch.Tensor]:
    """The tensors of ``spec``, drawn in one call from a generator on
    ``device`` seeded from (``seed``, ``salt``)."""
    sizes = [math.prod(shape) for _, shape, _ in spec]
    gen = torch.Generator(device=device).manual_seed(mix(seed, salt))
    flat = torch.empty(sum(sizes), dtype=torch.float32, device=device)
    flat.normal_(0.0, STD, generator=gen)
    out, at = {}, 0
    for (name, shape, kind), n in zip(spec, sizes):
        t = flat[at:at + n].view(shape)
        if kind == "scale":
            t = t + 1.0
        out[name] = t.to(dtype)
        at += n
    return out


def top(fam, cfg: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """The tensors outside the layers (embeddings, final norm)."""
    return generate(fam.top_spec(cfg), seed, 0, device)


def layer(fam, cfg: dict, seed: int, i: int, device) -> Dict[str, torch.Tensor]:
    """Layer ``i``'s tensors, named without the layer prefix."""
    return generate(fam.layer_spec(cfg), seed, i + 1, device)


@torch.no_grad()
def load_into(model: torch.nn.Module, fam, cfg: dict, seed: int) -> None:
    """Overwrite every parameter of the port's raw ``model`` with the seed's
    tensors, one layer at a time; raises if a parameter is left over or a
    name is missing."""
    params = dict(model.named_parameters())
    device = next(iter(params.values())).device
    done = set()

    def put(name, t):
        params[name].copy_(t)
        done.add(name)

    for name, t in top(fam, cfg, seed, device).items():
        put(name, t)
    for i in range(cfg["num_hidden_layers"]):
        for name, t in layer(fam, cfg, seed, i, device).items():
            put(fam.layer_prefix(i) + name, t)
    if done != set(params):
        raise RuntimeError(f"weights: unset {sorted(set(params) - done)[:4]}, "
                           f"unknown {sorted(done - set(params))[:4]}")
