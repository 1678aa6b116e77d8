"""LeNet-5: the smallest end-to-end co-design model.

Port of ``dmx_compressor_tpu/models/lenet.py``, the reference's LeNet test
vehicle.  Its module names (conv1 / mp1 / conv2 / mp2 / fc1 / fc2 / fc3) are
the reference config's keys.  The convolutions are torch's ``nn.Conv2d``
over NCHW (substitution makes them Dmx ``Conv2d``s); the pools are the Dmx
``MaxPool2d`` from the start, as in the JAX model.
"""

from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch
from torch import nn

from .. import rawnn
from ..kernels import resolve_device
from ..nn import modules as dmxnn

__all__ = ["LeNet5", "load_jax_params"]


class LeNet5(nn.Module):
    """Classic LeNet-5 over [B, 1, 28, 28] (NCHW) inputs.

    Built on the card unless ``device='cpu'``.  Weights are random, drawn
    from ``seed``: each weight and bias uniform in +-1 / sqrt(fan_in)
    (torch's default bounds); :func:`load_jax_params` replaces them."""

    def __init__(self, num_classes: int = 10, device=None, seed: int = 0):
        super().__init__()
        device = resolve_device(device)
        self.conv1 = nn.Conv2d(1, 6, 5, padding=2, device=device)
        self.relu1 = rawnn.ReLU()
        self.mp1 = dmxnn.MaxPool2d(2, 2)
        self.conv2 = nn.Conv2d(6, 16, 5, device=device)
        self.relu2 = rawnn.ReLU()
        self.mp2 = dmxnn.MaxPool2d(2, 2)
        self.fc1 = nn.Linear(400, 120, device=device)
        self.relu3 = rawnn.ReLU()
        self.fc2 = nn.Linear(120, 84, device=device)
        self.relu4 = rawnn.ReLU()
        self.fc3 = nn.Linear(84, num_classes, device=device)
        gen = torch.Generator(device=device).manual_seed(seed)
        with torch.no_grad():
            for m in self.modules():
                if isinstance(m, (nn.Conv2d, nn.Linear)):
                    bound = 1.0 / math.sqrt(m.weight[0].numel())
                    m.weight.uniform_(-bound, bound, generator=gen)
                    m.bias.uniform_(-bound, bound, generator=gen)

    def forward(self, x):
        h = self.mp1(self.relu1(self.conv1(x)))
        h = self.mp2(self.relu2(self.conv2(h)))
        h = h.reshape(h.shape[0], -1)
        h = self.relu3(self.fc1(h))
        h = self.relu4(self.fc2(h))
        return self.fc3(h)


def load_jax_params(model: LeNet5, params: Dict[str, np.ndarray]) -> None:
    """Copy a raw JAX LeNet-5's weights into a raw port model, in place:
    ``nnx.Conv.kernel`` [kh, kw, in, out] becomes ``weight`` [out, in, kh,
    kw], ``nnx.Linear.kernel`` [in, out] ``weight`` [out, in], biases as
    they are; the pools' cast state is not a weight and is skipped.  Every
    parameter of the port must be covered."""
    own = dict(model.named_parameters())
    seen = set()
    with torch.no_grad():
        for path, arr in params.items():
            mod, leaf = path.rsplit(".", 1)
            if mod.split(".")[0] in ("mp1", "mp2"):
                continue
            value = torch.tensor(np.asarray(arr, dtype=np.float32))
            if leaf == "kernel":
                value = value.permute(3, 2, 0, 1) if value.ndim == 4 else value.T
            elif leaf != "bias":
                raise KeyError(f"{path}: unknown leaf {leaf!r}")
            name = f"{mod}.{'bias' if leaf == 'bias' else 'weight'}"
            if name not in own:
                raise KeyError(f"{path}: no parameter {name} in the port model")
            if tuple(value.shape) != tuple(own[name].shape):
                raise ValueError(f"{path}: shape {tuple(value.shape)} != "
                                 f"{tuple(own[name].shape)}")
            own[name].copy_(value)
            seen.add(name)
    missing = set(own) - seen
    if missing:
        raise KeyError(f"parameters not in params: {sorted(missing)}")
