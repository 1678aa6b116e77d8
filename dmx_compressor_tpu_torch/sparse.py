"""Fine-grain structured weight sparsity.

Port of ``dmx_compressor_tpu/sparse.py``.  ``Sparseness`` patterns are frozen
dataclasses with a pure ``get_mask(score)``; :class:`Sparsify` holds the
learnable ``score`` and routes gradients (STE / supermask / joint) with
``detach`` where the JAX package uses ``stop_gradient``.  N:M masks keep the
K largest scores of each block (``torch.topk``), ties resolved as in the JAX
package: the earliest tied entries of a block are pruned.

The score is materialized at the first forward of a non-dense pattern (the
JAX package's lazy ``(0,)`` placeholder; here ``None`` until then, so an idle
sparsifier adds no Parameter), uniform in [0, 1) from a ``torch.Generator``
seeded 0 on the weight's device: its stream is not JAX's, so a parity test
carries the JAX score across, as weights are carried.
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Optional

import torch
from torch import nn

from .utils.tracing import eager


class Sparseness:
    """Abstract sparseness pattern."""

    blocked: bool = False
    density: Optional[float] = None

    def __init__(self, mask_gradient: bool = False):
        self.mask_gradient = mask_gradient

    def get_mask(self, score: torch.Tensor,
                 generator: Optional[torch.Generator] = None) -> Optional[torch.Tensor]:
        raise NotImplementedError

    @staticmethod
    def from_shorthand(sh: str) -> "Sparseness":
        sh = sh.strip()
        if sh.startswith("DENSE"):
            return Dense.from_shorthand(sh)
        if sh.startswith("TOPK"):
            return TopK.from_shorthand(sh)
        if sh.startswith("BTOPK"):
            return BlockTopK.from_shorthand(sh)
        if sh.startswith("BERN"):
            return Bernoulli.from_shorthand(sh)
        raise ValueError(f"unrecognized sparseness shorthand: {sh}")


@dataclass(frozen=True)
class Dense(Sparseness):
    """No pruning."""

    mask_gradient: bool = False
    blocked = False
    density = 1.0

    def get_mask(self, score, generator=None):
        return None

    @classmethod
    def from_shorthand(cls, sh):
        return cls()

    def __repr__(self):
        return "DENSE"


@dataclass(frozen=True)
class TopK(Sparseness):
    """Global top-K unstructured sparsity."""

    density: float = 0.5
    mask_gradient: bool = False
    blocked = False

    def __post_init__(self):
        if not 0 <= self.density <= 1.0:
            raise ValueError("density has to be between 0 and 1")

    def get_mask(self, score, generator=None):
        flat = score.reshape(-1)
        n_prune = int(flat.numel() * (1.0 - self.density))
        if n_prune == 0:
            return torch.ones_like(score)
        # the n_prune lowest scores are zeroed (a stable argsort, as JAX's)
        drop = torch.argsort(flat, stable=True)[:n_prune]
        mask = torch.ones_like(flat)
        mask[drop] = 0.0
        return mask.reshape(score.shape)

    @classmethod
    def from_shorthand(cls, sh):
        m = re.fullmatch(r"TOPK\{([0-9.]+)\}\((\w)\)", sh.strip())
        if m is None:
            raise ValueError(f"malformed TOPK shorthand: {sh!r}")
        return cls(density=float(m.group(1)), mask_gradient=m.group(2) == "M")

    def __repr__(self):
        return f"TOPK{{{self.density}}}({'M' if self.mask_gradient else 'U'})"


@dataclass(frozen=True)
class BlockTopK(Sparseness):
    """N:M structured sparsity: K non-zeros per ``block_size`` along
    ``block_dim``."""

    K: int = 4
    block_size: int = 8
    block_dim: int = -1
    mask_gradient: bool = False
    blocked = True

    def __post_init__(self):
        if not 0 < self.K <= self.block_size:
            raise ValueError(f"K {self.K} out of (0, block_size {self.block_size}]")

    @property
    def density(self):
        return self.K / self.block_size

    def get_mask(self, score, generator=None):
        bd = self.block_dim % score.ndim
        if score.shape[bd] % self.block_size:
            raise ValueError(f"score has size {score.shape[bd]} at dimension {bd}, "
                             f"not a multiple of block size {self.block_size}")
        st = torch.movedim(score, bd, -1)
        shape = st.shape
        blocks = st.reshape(-1, self.block_size)
        kth = torch.topk(blocks, self.K, dim=-1).values[:, -1:]
        mask = (blocks >= kth).to(score.dtype)
        # with ties at the threshold, prune the earliest tied entries of the
        # block until K remain
        excess = mask.sum(-1, keepdim=True) - self.K
        tie = (blocks == kth).to(score.dtype)
        drop = tie * (torch.cumsum(tie, dim=-1) <= excess)
        mask = (mask - drop).reshape(shape)
        return torch.movedim(mask, -1, bd)

    @classmethod
    def from_shorthand(cls, sh):
        m = re.fullmatch(r"BTOPK\{(\d+):(\d+),(-?\d+)\}\((\w)\)", sh.strip())
        if m is None:
            raise ValueError(f"malformed BTOPK shorthand: {sh!r}")
        return cls(K=int(m.group(1)), block_size=int(m.group(2)), block_dim=int(m.group(3)),
                   mask_gradient=m.group(4) == "M")

    def __repr__(self):
        return (f"BTOPK{{{self.K}:{self.block_size},{self.block_dim}}}"
                f"({'M' if self.mask_gradient else 'U'})")


@dataclass(frozen=True)
class Bernoulli(Sparseness):
    """Bernoulli supermask sampling; scores must lie in [0, 1]."""

    mask_gradient: bool = False
    blocked = False
    density = None

    def get_mask(self, score, generator=None):
        if generator is None:
            generator = torch.Generator(device=score.device).manual_seed(0)
        return torch.bernoulli(score.detach(), generator=generator).to(score.dtype)

    @classmethod
    def from_shorthand(cls, sh):
        return cls()

    def __repr__(self):
        return "BERN"


class Sparsify(nn.Module):
    """Sparsification of a weight by a mask of its learnable score."""

    def __init__(self, tensor_shape=None, sparseness="DENSE", backward_mode: str = "STE",
                 score_func=None, generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        if tensor_shape is not None:
            self.score = nn.Parameter(torch.rand(tuple(tensor_shape), generator=generator,
                                                 device=device))
        else:
            self.register_parameter("score", None)
        self.sparseness: Sparseness = Dense()
        self.backward_mode = "STE"
        self.enable_weight_gradient = True
        self.enable_mask_gradient = False
        self.score_func = None
        self.plastic = False
        self.training = False
        self.configure(sparseness, backward_mode, score_func)

    def configure(self, sparseness=None, backward_mode=None, score_func=None):
        if sparseness is not None:
            if not isinstance(sparseness, Sparseness):
                sparseness = Sparseness.from_shorthand(sparseness)
            self.sparseness = sparseness
        if backward_mode is not None:
            self.backward_mode = backward_mode
            self.enable_weight_gradient = backward_mode.lower() in {"ste", "joint"}
            self.enable_mask_gradient = backward_mode.lower() in {"supermask", "joint"}
        if score_func is not None:
            self.score_func = score_func
            self.plastic = True

    def _materialize(self, x: torch.Tensor, generator: Optional[torch.Generator] = None):
        if self.score is None or self.score.shape != x.shape:
            if generator is None:
                generator = torch.Generator(device=x.device).manual_seed(0)
            self.score = nn.Parameter(torch.rand(x.shape, generator=generator,
                                                 device=x.device))

    @property
    def mask(self) -> Optional[torch.Tensor]:
        if isinstance(self.sparseness, Dense):
            return None
        if self.score is None:
            raise RuntimeError("score not materialized yet")
        return self.sparseness.get_mask(self.score.detach())

    def forward(self, x, generator: Optional[torch.Generator] = None):
        if isinstance(self.sparseness, Dense):
            return x
        if eager():
            self._materialize(x, generator)
        elif self.score is None or self.score.shape != x.shape:
            raise RuntimeError("Sparsify score not materialized; run one eager forward first")
        score = (self.score_func(self.score, x) if (self.plastic and self.score_func is not None)
                 else self.score)
        if eager():
            self.plastic = False
        with torch.no_grad():
            mask = self.sparseness.get_mask(score.detach(), generator=generator)
        if self.training:
            if not self.enable_weight_gradient:
                x = x.detach()
            if self.enable_mask_gradient and not self.sparseness.mask_gradient:
                # supermask STE: the gradient reaches the score as the identity
                mask = score + (mask - score).detach()
        return x * mask.to(x.dtype)

    @property
    def density(self) -> float:
        if self.sparseness.density is not None:
            return self.sparseness.density
        m = self.mask
        return float(m.sum() / m.numel())

    def extra_repr(self):
        return f"sparseness={repr(self.sparseness)}, backward_mode={self.backward_mode}"


# the JAX package's alias: lazy behaviour is the default
LazySparsify = Sparsify


class SparsificationManager:
    """Scheduler-style reconfiguration of many sparsifiers."""

    def __init__(self, sparsify_modules, **kwargs):
        self.sparsify_modules = list(sparsify_modules)

    def step(self, **kwargs):
        for sm in self.sparsify_modules:
            sm.configure(**kwargs)
