"""SIMD-accurate surrogates of the nonlinear ops.

Port of ``poly2exp``, ``exp``, ``softmax``, ``_tiled_moments``,
``layer_norm``, ``rms_norm``, ``_sigmoid_via_exp``, ``silu``,
``quick_gelu``, ``gelu`` and ``apply_rotary_pos_emb`` of
``dmx_compressor_tpu/functional/simd_ops.py``: the same f32 arithmetic
written with torch ops (``torch.round`` rounds half to even, as
``jnp.round`` does).  They run as plain tensor code on the CPU and on the
card; the JAX package fuses them with XLA, not with a Pallas kernel.

Each function returns the approximated output; callers combine it with the
exact op by value replacement (see approximate.py).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

LN2 = 0.6931471805599453
INV_LN2 = 1.4426950408889634


def poly2exp(x: torch.Tensor, knorm: int = 0, kmax: int = 15,
             use_exp_large: bool = True) -> torch.Tensor:
    """Base-2 decomposition exponential: exp(x) = 2^k * exp(r) with
    k = round(x / ln2) clamped to [-kmax, kmax] (to 0 from above without
    ``use_exp_large``), |r| <= ln2 / 2 by a degree-4 polynomial; values with
    k below -kmax flush to zero.  ``knorm`` pre-biases the input by
    2^-knorm."""
    xf = x.to(torch.float32)
    if knorm:
        xf = xf * (2.0**-knorm)
    k_raw = torch.round(xf * INV_LN2)
    k = torch.clamp(k_raw, -kmax, kmax if use_exp_large else 0)
    r = torch.clamp(xf - k * LN2, -0.5 * LN2, 0.5 * LN2)
    p = 1.0 + r * (1.0 + r * (0.5 + r * (0.16666667 + r * 0.041666668)))
    out = p * torch.exp2(k)
    out = torch.where(k_raw < -kmax, torch.zeros_like(out), out)
    if knorm:
        out = out ** (2.0**knorm)
    return out.to(x.dtype)


def exp(x: torch.Tensor, knorm: int = 0, kmax: int = 15,
        use_exp_large: bool = True) -> torch.Tensor:
    """EXP surrogate (vsimd parameter surface)."""
    return poly2exp(x, knorm=knorm, kmax=kmax, use_exp_large=use_exp_large)


def softmax(x: torch.Tensor, dim: int = -1, input_clamp: Optional[float] = None,
            max_adjust: float = 0.0, knorm: int = 0, kmax: int = 15) -> torch.Tensor:
    """Softmax surrogate: clamp -> max-subtract (with adjustable bias) ->
    poly2 exp -> normalize with a Newton-refined reciprocal."""
    xf = x.to(torch.float32)
    if input_clamp is not None:
        xf = torch.clamp(xf, min=input_clamp)
    m = torch.amax(xf, dim=dim, keepdim=True) - max_adjust
    e = poly2exp(xf - m, knorm=knorm, kmax=kmax)
    s = torch.sum(e, dim=dim, keepdim=True)
    r0 = 1.0 / s
    r = r0 * (2.0 - s * r0)
    return (e * r).to(x.dtype)


def _tiled_moments(x: torch.Tensor, tile_size: Optional[int]
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Two-pass tiled mean / variance over the last axis (per-tile partial
    sums combined hierarchically)."""
    n = x.shape[-1]
    if tile_size is None or n % tile_size != 0 or tile_size >= n:
        mean = torch.mean(x, dim=-1, keepdim=True)
        var = torch.mean(torch.square(x - mean), dim=-1, keepdim=True)
        return mean, var
    t = x.reshape(*x.shape[:-1], n // tile_size, tile_size)
    mean = torch.sum(torch.sum(t, dim=-1), dim=-1, keepdim=True) / n
    d = t - mean[..., None]
    var = torch.sum(torch.sum(torch.square(d), dim=-1), dim=-1, keepdim=True) / n
    return mean, var


def layer_norm(x: torch.Tensor, normalized_shape, weight: Optional[torch.Tensor] = None,
               bias: Optional[torch.Tensor] = None, eps: float = 1e-5,
               tile_size: Optional[int] = None, norm: Optional[float] = None) -> torch.Tensor:
    """LayerNorm surrogate: tiled moments, rsqrt refined by one Newton step.
    ``norm`` is the SLaNC pre-scale of the input."""
    xf = x.to(torch.float32)
    if norm is not None:
        xf = xf * norm
    mean, var = _tiled_moments(xf, tile_size)
    r0 = torch.rsqrt(var + eps)
    r = r0 * (1.5 - 0.5 * (var + eps) * r0 * r0)
    y = (xf - mean) * r
    if weight is not None:
        y = y * weight.to(torch.float32)
    if bias is not None:
        y = y + bias.to(torch.float32)
    return y.to(x.dtype)


def rms_norm(x: torch.Tensor, normalized_shape, weight: Optional[torch.Tensor] = None,
             eps: float = 1e-6, tile_size: Optional[int] = None,
             norm: Optional[float] = None) -> torch.Tensor:
    """RMSNorm surrogate: the mean square (tiled as layer_norm's moments),
    rsqrt refined by one Newton step."""
    xf = x.to(torch.float32)
    if norm is not None:
        xf = xf * norm
    n = x.shape[-1]
    if tile_size is not None and n % tile_size == 0 and tile_size < n:
        t = xf.reshape(*xf.shape[:-1], n // tile_size, tile_size)
        ms = torch.sum(torch.sum(torch.square(t), dim=-1), dim=-1, keepdim=True) / n
    else:
        ms = torch.mean(torch.square(xf), dim=-1, keepdim=True)
    r0 = torch.rsqrt(ms + eps)
    r = r0 * (1.5 - 0.5 * (ms + eps) * r0 * r0)
    y = xf * r
    if weight is not None:
        y = y * weight.to(torch.float32)
    return y.to(x.dtype)


def _sigmoid_via_exp(x: torch.Tensor, **exp_kw) -> torch.Tensor:
    e = poly2exp(-torch.abs(x), **exp_kw)
    pos = 1.0 / (1.0 + e)
    return torch.where(x >= 0, pos, 1.0 - pos)


def silu(x: torch.Tensor, knorm: int = 0, kmax: int = 15) -> torch.Tensor:
    """SiLU surrogate: x * sigmoid(x) with the poly2 exponential."""
    xf = x.to(torch.float32)
    return (xf * _sigmoid_via_exp(xf, knorm=knorm, kmax=kmax)).to(x.dtype)


def quick_gelu(x: torch.Tensor, knorm: int = 0, kmax: int = 15) -> torch.Tensor:
    """QuickGELU surrogate: x * sigmoid(1.702 x) with the poly2 exponential."""
    xf = x.to(torch.float32)
    return (xf * _sigmoid_via_exp(1.702 * xf, knorm=knorm, kmax=kmax)).to(x.dtype)


def gelu(x: torch.Tensor, approximate: str = "tanh") -> torch.Tensor:
    """GELU surrogate: the tanh form, tanh(u) = (1 - e) / (1 + e) with e the
    poly2 exponential of -2|u|."""
    xf = x.to(torch.float32)
    c = 0.7978845608028654  # sqrt(2 / pi)
    u = c * (xf + 0.044715 * xf * xf * xf)
    e = poly2exp(-2.0 * torch.abs(u))
    t = (1.0 - e) / (1.0 + e)
    t = torch.where(u >= 0, t, -t)
    return (0.5 * xf * (1.0 + t)).to(x.dtype)


def rotate_half(x: torch.Tensor) -> torch.Tensor:
    """The last axis split into halves (x1, x2), returned as (-x2, x1)."""
    x1, x2 = torch.chunk(x, 2, dim=-1)
    return torch.cat([-x2, x1], dim=-1)


def apply_rotary_pos_emb(q: torch.Tensor, k: torch.Tensor, cos: torch.Tensor,
                         sin: torch.Tensor, unsqueeze_dim: int = 1
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Llama-style RoPE surrogate (APPLY_LLAMA_ROPE): the rotate-half form
    evaluated in f32."""
    cos = cos.unsqueeze(unsqueeze_dim).to(torch.float32)
    sin = sin.unsqueeze(unsqueeze_dim).to(torch.float32)
    qf, kf = q.to(torch.float32), k.to(torch.float32)
    q_out = qf * cos + rotate_half(qf) * sin
    k_out = kf * cos + rotate_half(kf) * sin
    return q_out.to(q.dtype), k_out.to(k.dtype)


FUNCTIONS = {
    "softmax": softmax,
    "exp": exp,
    "layer_norm": layer_norm,
    "rms_norm": rms_norm,
    "silu": silu,
    "quick_gelu": quick_gelu,
    "gelu": gelu,
    "apply_rotary_pos_emb": apply_rotary_pos_emb,
}
