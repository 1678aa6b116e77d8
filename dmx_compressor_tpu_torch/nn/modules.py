"""The Dmx op-module zoo.

Port of ``dmx_compressor_tpu/nn/modules.py``: Linear, Embedding, the
convolutions (Conv1d, Conv2d, ConvTranspose2d), the pools (MaxPool2d,
AvgPool2d, AdaptiveAvgPool2d), LayerNorm, RMSNorm, GemmaRMSNorm,
BatchNorm2d, GroupNorm, ResAdd, Mul, ActActMatMul, BAddBMM, Exp, Softmax,
Dropout, ReLU, ReLU6, SiLU, Tanh, the GELU family (GELUBase, GELU, NewGELU,
FastGELU, QuickGELU, BloomGELU, ClippedGELU), ApplyRotaryPosEmb,
RotaryEmbedding and the compound ScaledDotProductAttention, and the helpers
of the unfold-lowered convolutions of ``nn/experimental.py``
(``_init_weight``, ``_pair``, ``_im2col``).  Each module follows the
DmxModule pipeline (nn/core.py) and declares the same cast topology as its
JAX counterpart:

- Linear: weight [out, in]; input and weight casts block along the last
  (input-channel) axis.
- Conv*: NCHW, channel axis 1; weight [out, in / groups, *k], its cast
  blocked along its input channels (axis 1), as the input's.
- ActActMatMul: input blocks along -1, multiplier along -2; BAddBMM's
  batch1 along -1, batch2 along -2.

The convolutions and pools are ``torch.nn.functional``'s (the JAX package
computes them with ``lax`` outside any Pallas kernel); a conv on the card
runs in full f32 whatever ``torch.backends.cudnn.allow_tf32`` says.
"""

from __future__ import annotations

import contextlib
import math
from typing import Optional, Sequence, Union

import torch
from torch import nn

from ..functional.simd_ops import rotate_half
from ..numerics.format import Same
from .. import rawnn
from .core import DmxModule


def _init_weight(gen: torch.Generator, shape, fan_in: int, device=None) -> torch.Tensor:
    """Uniform in [-1/sqrt(fan_in), 1/sqrt(fan_in)] (1 for fan_in 0), drawn
    from ``gen``: the JAX package's conv initialisation."""
    if device is not None and torch.device(device).type == "meta":
        return torch.empty(shape, device="meta")  # from_raw shares the raw weight
    bound = 1.0 / math.sqrt(fan_in) if fan_in > 0 else 1.0
    return torch.empty(shape, device=device).uniform_(-bound, bound, generator=gen)


def _generator(generator: Optional[torch.Generator], device) -> Optional[torch.Generator]:
    """``generator``, or one of seed 0 on ``device`` (None on the meta
    device: nothing is drawn there)."""
    if generator is not None:
        return generator
    if device is not None and torch.device(device).type == "meta":
        return None
    return torch.Generator(device=device or "cpu").manual_seed(0)


def _pair(v, n: int) -> tuple:
    """``v`` as an n-tuple (a scalar repeated)."""
    return tuple(v) if isinstance(v, (tuple, list)) else (v,) * n


def _im2col(x: torch.Tensor, kernel_size, stride, padding, dilation) -> torch.Tensor:
    """Sliding patches of ``x`` [B, C, *spatial] (1-d or 2-d), zero-padded:
    [B, C * prod(k), L], the patch axis channel-major and tap-minor (channel
    c, tap t at c * prod(k) + t), as ``lax.conv_general_dilated_patches``
    lays it out and as a torch conv weight [out, in, *k] flattens."""
    nd = len(kernel_size)
    if nd == 2:
        return torch.nn.functional.unfold(x, kernel_size, dilation=dilation, padding=padding,
                                          stride=stride)
    if nd != 1:
        raise ValueError(f"_im2col takes 1-d or 2-d inputs, got {nd}-d kernels")
    (k,), (s,), (p,), (d,) = kernel_size, stride, padding, dilation
    xp = torch.nn.functional.pad(x, (p, p))
    span = d * (k - 1) + 1
    win = xp.unfold(2, span, s)[..., ::d]  # [B, C, L, k]
    B, C, L, _ = win.shape
    return win.permute(0, 1, 3, 2).reshape(B, C * k, L)


class ResAdd(DmxModule):
    """Residual addition with separate input/residual casts."""

    input_cast_names = ("input_cast", "residual_cast")

    def _forward(self, _input, _residual):
        return _input + _residual

    @classmethod
    def from_raw(cls, raw=None):
        return cls()


class Mul(DmxModule):
    """Elementwise multiply."""

    input_cast_names = ("input_cast", "multiplier_cast")

    def _forward(self, _input, _multiplier):
        return _input * _multiplier

    @classmethod
    def from_raw(cls, raw=None):
        return cls()


class ActActMatMul(DmxModule):
    """Activation x activation matmul: input blocks along -1, multiplier
    along -2 (the contraction dim)."""

    input_cast_names = ("input_cast", "multiplier_cast")

    def __init__(self):
        super().__init__()
        self.input_casts["input_cast"].block_dim = -1
        self.input_casts["multiplier_cast"].block_dim = -2

    def _forward(self, _input, _multiplier):
        return torch.matmul(_input, _multiplier)

    @classmethod
    def from_raw(cls, raw=None):
        return cls()


class Exp(DmxModule):
    """Elementwise exp with an approximation hook (the EXP surrogate)."""

    def _raw_forward(self, _input):
        return torch.exp(_input)

    def _forward(self, _input):
        return self.approx_forward((_input,))

    @classmethod
    def from_raw(cls, raw=None):
        return cls()


class BAddBMM(DmxModule):
    """Batched add-matmul ``beta * input + alpha * batch1 @ batch2``, each
    operand through its own cast: batch1 blocked along -1, batch2 along -2
    (the contraction dim)."""

    input_cast_names = ("input_cast", "batch1_cast", "batch2_cast")

    def __init__(self):
        super().__init__()
        self.input_casts["batch1_cast"].block_dim = -1
        self.input_casts["batch2_cast"].block_dim = -2

    def _forward(self, _input, batch1, batch2, beta=1, alpha=1):
        return beta * _input + alpha * torch.matmul(batch1, batch2)

    @classmethod
    def from_raw(cls, raw=None):
        return cls()


class Linear(DmxModule):
    """Quantized linear: y = x @ W.T + b, weight [out_features, in_features]."""

    ch_axis = -1
    win_ch_axis = -1
    wout_ch_axis = 0
    has_accum = True
    has_weight = True
    has_bias = True
    sparsifiable = True

    def __init__(self, in_features: int, out_features: int, bias: bool = True, device=None):
        self.in_features = in_features
        self.out_features = out_features
        self.has_bias = bias
        super().__init__()
        bound = 1.0 / math.sqrt(in_features) if in_features > 0 else 1.0
        self.weight = nn.Parameter(
            torch.empty(out_features, in_features, device=device).uniform_(-bound, bound)
        )
        self.bias = (
            nn.Parameter(torch.empty(out_features, device=device).uniform_(-bound, bound))
            if bias else None
        )
        self.input_casts["input_cast"].block_dim = -1
        self.weight_cast.block_dim = -1
        if self.bias_cast is not None:
            self.bias_cast.block_dim = -1

    def _forward(self, _input):
        tp = self.tp_shard  # tensor parallel (parallel/mesh.py), or None
        same = isinstance(self.accum_format, Same)
        _weight = self._weight
        if tp is not None:
            _input = tp.enter(_input)
        out = _input @ _weight.to(_input.dtype).T if same else _input.to(_weight.dtype) @ _weight.T
        if tp is not None:
            # a row-parallel product is summed before its accumulator cast and bias
            out = tp.partial_sum(out)
        if not same:
            out = self.accum_cast(out)
        if self.bias is not None:
            out = out + (self._bias.to(_input.dtype) if same else self._bias)
        return out if tp is None else tp.finish(out)

    def _flops_for(self, input_shape, output_shape):
        return math.prod(input_shape) * self.out_features

    @classmethod
    def from_raw(cls, raw: nn.Linear) -> "Linear":
        """Build from a torch ``nn.Linear``, sharing its parameters."""
        mod = cls(raw.in_features, raw.out_features, bias=raw.bias is not None,
                  device="meta")
        mod.weight = raw.weight
        mod.bias = raw.bias
        return mod

    @classmethod
    def from_tied(cls, raw) -> "Linear":
        """Build from ``rawnn.TiedLinear``: the weight Parameter IS the
        embedding table, so embedding and head stay tied."""
        V, D = raw.embed_ref.weight.shape
        mod = cls(D, V, bias=False, device="meta")
        mod.weight = raw.embed_ref.weight
        return mod


class Embedding(DmxModule):
    """Quantized embedding lookup (integer input: no input casts)."""

    has_weight = True
    wout_ch_axis = 0
    sparsifiable = True

    def __init__(self, num_embeddings: int, embedding_dim: int, device=None):
        self.num_embeddings = num_embeddings
        self.embedding_dim = embedding_dim
        super().__init__()
        self.weight = nn.Parameter(torch.randn(num_embeddings, embedding_dim, device=device))
        self.align_boundary_dtype = False

    def _forward(self, _input):
        if self.tp_shard is not None:  # vocabulary parallel (parallel/mesh.py)
            return self.tp_shard.lookup(self._weight, _input)
        return self._weight[_input]

    def forward(self, input, *args, **kwargs):
        return self.output_casts(self._forward(input), output=True)

    @classmethod
    def from_raw(cls, raw: nn.Embedding) -> "Embedding":
        mod = cls(raw.num_embeddings, raw.embedding_dim, device="meta")
        mod.weight = raw.weight  # shared, so a tied head stays tied
        return mod


@contextlib.contextmanager
def _f32_convs(x: torch.Tensor):
    """cuDNN convolutions in full f32 within (TF32 off while the global
    flag ``torch.backends.cudnn.allow_tf32`` is on), as the JAX package's
    f32 convs compute."""
    cudnn = torch.backends.cudnn
    if not x.is_cuda or not cudnn.allow_tf32:
        yield
        return
    cudnn.allow_tf32 = False
    try:
        yield
    finally:
        cudnn.allow_tf32 = True


class _ConvNd(DmxModule):
    """A quantized convolution over NCHW (NCL) inputs, weight [out, in /
    groups, *k]: the input cast blocks along the channel axis 1, the weight
    cast along its input channels (axis 1), the bias cast along -1; the
    conv runs in f32 (``torch.nn.functional``'s, where the JAX package runs
    ``lax.conv_general_dilated``)."""

    ch_axis = 1
    win_ch_axis = 1
    wout_ch_axis = 0
    has_accum = True
    has_weight = True
    has_bias = True
    sparsifiable = True
    _nd = 2

    def __init__(self, in_channels: int, out_channels: int, kernel_size, stride=1, padding=0,
                 dilation=1, groups: int = 1, bias: bool = True, device=None,
                 generator: Optional[torch.Generator] = None):
        nd = self._nd
        self.in_channels = in_channels
        self.out_channels = out_channels
        self.kernel_size = _pair(kernel_size, nd)
        self.stride = _pair(stride, nd)
        self.padding = _pair(padding, nd)
        self.dilation = _pair(dilation, nd)
        self.groups = groups
        self.has_bias = bias
        super().__init__()
        gen = _generator(generator, device)
        fan_in = in_channels // groups * math.prod(self.kernel_size)
        self.weight = nn.Parameter(_init_weight(
            gen, (out_channels, in_channels // groups, *self.kernel_size), fan_in, device))
        self.bias = (nn.Parameter(_init_weight(gen, (out_channels,), fan_in, device))
                     if bias else None)
        self.input_casts["input_cast"].block_dim = 1
        self.input_casts["input_cast"].ch_axis = 1
        self.weight_cast.block_dim = 1
        if self.bias_cast is not None:
            self.bias_cast.block_dim = -1

    def _conv(self, x, w):
        conv = torch.nn.functional.conv1d if self._nd == 1 else torch.nn.functional.conv2d
        with _f32_convs(x):
            return conv(x, w, None, self.stride, self.padding, self.dilation, self.groups)

    def _forward(self, _input):
        if isinstance(self.accum_format, Same):
            # the weight in the input's dtype, the conv in f32 (JAX's
            # preferred_element_type)
            out = self._conv(_input.to(torch.float32),
                             self._weight.to(_input.dtype).to(torch.float32))
        else:
            out = self.accum_cast(self._conv(_input.to(torch.float32),
                                             self._weight.to(torch.float32)))
        if self.bias is not None:
            out = out + self._bias.reshape((1, -1) + (1,) * self._nd).to(out.dtype)
        return out

    def unfold_input_for_hessian(self, inp: torch.Tensor) -> torch.Tensor:
        """im2col for GPTQ's Hessian: [C * prod(k), B * L]."""
        patches = _im2col(inp, self.kernel_size, self.stride, self.padding, self.dilation)
        return patches.transpose(0, 1).reshape(patches.shape[1], -1)

    def _flops_for(self, input_shape, output_shape):
        per_pos = math.prod(self.kernel_size) * self.in_channels * (
            self.out_channels // self.groups)
        return per_pos * input_shape[0] * math.prod(output_shape[2:])

    @classmethod
    def from_raw(cls, raw) -> "_ConvNd":
        """Build from a torch ``nn.Conv1d`` / ``nn.Conv2d`` (weight [out,
        in / groups, *k]: already this module's layout), sharing its
        parameters.  Zero padding only; ``padding="same"`` where it pads
        both sides alike."""
        if raw.padding_mode != "zeros":
            raise ValueError(f"padding_mode {raw.padding_mode!r}: the Dmx convs zero-pad")
        pad = raw.padding
        if pad == "valid":
            pad = 0
        elif pad == "same":
            span = [d * (k - 1) for d, k in zip(raw.dilation, raw.kernel_size)]
            if any(s % 2 for s in span):
                raise ValueError("padding='same' over an even span pads one side more")
            pad = tuple(s // 2 for s in span)
        mod = cls(raw.in_channels, raw.out_channels, raw.kernel_size, stride=raw.stride,
                  padding=pad, dilation=raw.dilation, groups=raw.groups,
                  bias=raw.bias is not None, device="meta")
        mod.weight = raw.weight
        mod.bias = raw.bias
        return mod


class Conv1d(_ConvNd):
    """Quantized 1d convolution."""

    _nd = 1


class Conv2d(_ConvNd):
    """Quantized 2d convolution."""

    _nd = 2


class ConvTranspose2d(_ConvNd):
    """Quantized transposed 2d convolution with the JAX package's weight and
    arithmetic: the weight [out, in / groups, kH, kW], flipped and its first
    two axes swapped, convolves the input dilated by the stride and padded
    by k - 1 - padding (+ output_padding after).  That is torch's
    ``conv_transpose2d`` where in_channels == out_channels and groups is 1,
    and is defined only where in_channels == out_channels * groups: the
    constructor refuses any other shape, where the JAX package raises at the
    call."""

    _nd = 2

    def __init__(self, *args, output_padding=0, **kwargs):
        self.output_padding = _pair(output_padding, 2)
        super().__init__(*args, **kwargs)
        if (self.in_channels != self.out_channels * self.groups
                or self.out_channels % self.groups):
            raise ValueError(
                f"ConvTranspose2d({self.in_channels}, {self.out_channels}, groups="
                f"{self.groups}): the JAX package's transposed conv computes only where "
                "in_channels == out_channels * groups (its weight [out, in / groups, k, k] "
                "is read as [in, out / groups, k, k])")

    def _conv(self, x, w):
        (kh, kw), (ph, pw), (oph, opw) = self.kernel_size, self.padding, self.output_padding
        (sh, sw) = self.stride
        B, C, H, W = x.shape
        xd = x.new_zeros(B, C, (H - 1) * sh + 1, (W - 1) * sw + 1)
        xd[:, :, ::sh, ::sw] = x
        # a negative pad crops, as lax's does
        xd = torch.nn.functional.pad(xd, (kw - 1 - pw, kw - 1 - pw + opw,
                                          kh - 1 - ph, kh - 1 - ph + oph))
        with _f32_convs(x):
            return torch.nn.functional.conv2d(xd, torch.flip(w, (-2, -1)).transpose(0, 1),
                                              None, 1, 0, self.dilation, self.groups)

    @classmethod
    def from_raw(cls, raw):
        raise TypeError("no raw module maps to ConvTranspose2d (the JAX package maps none)")


class MaxPool2d(DmxModule):
    """Max pooling over NCHW windows, -inf padding."""

    def __init__(self, kernel_size, stride=None, padding=0):
        self.kernel_size = _pair(kernel_size, 2)
        self.stride = _pair(stride if stride is not None else kernel_size, 2)
        self.padding = _pair(padding, 2)
        super().__init__()

    def _forward(self, _input):
        return torch.nn.functional.max_pool2d(_input, self.kernel_size, self.stride,
                                              self.padding)

    @classmethod
    def from_raw(cls, raw):
        return cls(raw.kernel_size, raw.stride, raw.padding)


class AvgPool2d(DmxModule):
    """Average pooling over NCHW windows, the zero padding counted."""

    def __init__(self, kernel_size, stride=None, padding=0):
        self.kernel_size = _pair(kernel_size, 2)
        self.stride = _pair(stride if stride is not None else kernel_size, 2)
        self.padding = _pair(padding, 2)
        super().__init__()

    def _forward(self, _input):
        return torch.nn.functional.avg_pool2d(_input, self.kernel_size, self.stride,
                                              self.padding, count_include_pad=True)

    @classmethod
    def from_raw(cls, raw):
        return cls(raw.kernel_size, raw.stride, raw.padding)


class AdaptiveAvgPool2d(DmxModule):
    """Mean over adaptive windows: row i of ``output_size`` covers
    [floor(i H / oh), ceil((i + 1) H / oh)), likewise the columns."""

    def __init__(self, output_size):
        self.output_size = _pair(output_size, 2)
        super().__init__()

    def _forward(self, _input):
        B, C, H, W = _input.shape
        oh, ow = self.output_size
        if H % oh == 0 and W % ow == 0:
            return _input.reshape(B, C, oh, H // oh, ow, W // ow).mean(dim=(3, 5))
        out = _input.new_zeros(B, C, oh, ow)
        for i in range(oh):
            h0, h1 = (i * H) // oh, -(-((i + 1) * H) // oh)
            for j in range(ow):
                w0, w1 = (j * W) // ow, -(-((j + 1) * W) // ow)
                out[:, :, i, j] = _input[:, :, h0:h1, w0:w1].mean(dim=(2, 3))
        return out

    @classmethod
    def from_raw(cls, raw):
        return cls(raw.output_size)


class _Activation(DmxModule):
    """Unary activation with an approximation hook."""

    def _raw_forward(self, _input):
        raise NotImplementedError

    def _forward(self, _input):
        return self.approx_forward((_input,))

    @classmethod
    def from_raw(cls, raw=None):
        return cls()


class ReLU(_Activation):
    def _raw_forward(self, x):
        return torch.relu(x)


class ReLU6(_Activation):
    def _raw_forward(self, x):
        return torch.clamp(x, 0.0, 6.0)


class SiLU(_Activation):
    def _raw_forward(self, x):
        return torch.nn.functional.silu(x)


class Tanh(_Activation):
    def _raw_forward(self, x):
        return rawnn.tanh(x)


class GELUBase(_Activation):
    """The base of every GELU flavour: ``jax.nn.gelu``'s tanh form where
    ``approximate`` is "tanh", else the exact (erfc) one (``rawnn.gelu``:
    its tanh is XLA's, bit for bit)."""

    approximate: str = "none"

    def _raw_forward(self, x):
        return rawnn.gelu(x, self.approximate == "tanh")


class GELU(GELUBase):
    def __init__(self, approximate: str = "none"):
        self.approximate = approximate
        super().__init__()

    @classmethod
    def from_raw(cls, raw=None):
        return cls(approximate=getattr(raw, "approximate", "none"))


class NewGELU(GELUBase):
    approximate = "tanh"


class FastGELU(GELUBase):
    def _raw_forward(self, x):
        return 0.5 * x * (1.0 + rawnn.tanh(x * 0.7978845608 * (1.0 + 0.044715 * x * x)))


class QuickGELU(GELUBase):
    def _raw_forward(self, x):
        return x * torch.sigmoid(1.702 * x)


class BloomGELU(GELUBase):
    approximate = "tanh"


class ClippedGELU(GELUBase):
    def __init__(self, min=-10, max=10):
        self.min, self.max = min, max
        super().__init__()

    def _raw_forward(self, x):
        return torch.clamp(rawnn.gelu(x, True), self.min, self.max)

    @classmethod
    def from_raw(cls, raw=None):
        if raw is not None and hasattr(raw, "min"):
            return cls(raw.min, raw.max)
        return cls()


class Softmax(DmxModule):
    """Softmax with an approximation hook."""

    def __init__(self, dim: int = -1):
        self.dim = dim
        super().__init__()

    def approximator_wrapper(self, inputs, approx_args, approx_kwargs, **wrapper_kwargs):
        """The vsimd wrapper's ``input_clamp`` clips the logits from below
        before the surrogate."""
        if "input_clamp" in wrapper_kwargs:
            inputs = [torch.clamp(x, min=wrapper_kwargs["input_clamp"]) for x in inputs]
        return self.approximator(*inputs, *approx_args, **approx_kwargs)

    def functional_forward(self, _input, dim=-1):
        return torch.softmax(_input, dim=dim)

    def _forward(self, _input):
        return self.approx_forward((_input,), dim=self.dim)

    @classmethod
    def from_raw(cls, raw=None):
        return cls(dim=getattr(raw, "dim", -1))


class Dropout(DmxModule):
    """Dropout: the identity at inference, the only mode ported so far."""

    def __init__(self, p: float = 0.0):
        self.p = p
        super().__init__()

    def _forward(self, _input):
        return _input

    @classmethod
    def from_raw(cls, raw=None):
        return cls(p=getattr(raw, "p", 0.0))


class LayerNorm(DmxModule):
    """LayerNorm computed in f32, with an approximation hook."""

    has_weight = True
    has_bias = True

    def __init__(self, normalized_shape: Union[int, Sequence[int]], eps: float = 1e-5,
                 elementwise_affine: bool = True, device=None):
        if isinstance(normalized_shape, int):
            normalized_shape = (normalized_shape,)
        self.normalized_shape = tuple(normalized_shape)
        self.eps = eps
        self.elementwise_affine = elementwise_affine
        self.has_weight = elementwise_affine
        self.has_bias = elementwise_affine
        super().__init__()
        if elementwise_affine:
            self.weight = nn.Parameter(torch.ones(self.normalized_shape, device=device))
            self.bias = nn.Parameter(torch.zeros(self.normalized_shape, device=device))
        else:
            self.weight = None
            self.bias = None

    def approximator_wrapper(self, inputs, approx_args, approx_kwargs, **wrapper_kwargs):
        """The vsimd wrapper's ``tile_size`` reaches the surrogate."""
        if "tile_size" in wrapper_kwargs:
            approx_kwargs = dict(approx_kwargs, tile_size=wrapper_kwargs["tile_size"])
        return self.approximator(*inputs, *approx_args, **approx_kwargs)

    def functional_forward(self, x, normalized_shape, weight, bias, eps):
        dims = tuple(range(x.ndim - len(normalized_shape), x.ndim))
        xf = x.to(torch.float32)
        mean = torch.mean(xf, dim=dims, keepdim=True)
        var = torch.mean(torch.square(xf - mean), dim=dims, keepdim=True)
        y = (xf - mean) * torch.rsqrt(var + eps)
        if weight is not None:
            y = y * weight.to(torch.float32)
        if bias is not None:
            y = y + bias.to(torch.float32)
        return y.to(x.dtype)

    def _forward(self, _input):
        w = self._weight if self.weight is not None else None
        b = self._bias if self.bias is not None else None
        return self.approx_forward((_input,), self.normalized_shape, w, b, self.eps)

    @classmethod
    def from_raw(cls, raw: nn.LayerNorm) -> "LayerNorm":
        affine = raw.weight is not None
        mod = cls(raw.normalized_shape, eps=raw.eps, elementwise_affine=affine, device="meta")
        if affine:
            mod.weight = raw.weight
            mod.bias = raw.bias if raw.bias is not None else nn.Parameter(
                torch.zeros_like(raw.weight)
            )
        return mod


class RMSNorm(DmxModule):
    """RMSNorm computed in f32, with an approximation hook."""

    has_weight = True

    def __init__(self, normalized_shape: Union[int, Sequence[int]], eps: float = 1e-6,
                 device=None):
        if isinstance(normalized_shape, int):
            normalized_shape = (normalized_shape,)
        self.normalized_shape = tuple(normalized_shape)
        self.eps = eps
        super().__init__()
        self.weight = nn.Parameter(torch.ones(self.normalized_shape, device=device))

    def functional_forward(self, x, normalized_shape, weight, eps):
        xf = x.to(torch.float32)
        ms = torch.mean(torch.square(xf), dim=-1, keepdim=True)
        y = xf * torch.rsqrt(ms + eps)
        if weight is not None:
            y = y * weight.to(torch.float32)
        return y.to(x.dtype)

    def _forward(self, _input):
        return self.approx_forward((_input,), self.normalized_shape, self._weight, self.eps)

    @classmethod
    def from_raw(cls, raw) -> "RMSNorm":
        """Build from ``rawnn.RMSNorm`` or torch's ``nn.RMSNorm`` (over its
        last axis only, as the Dmx module normalizes; eps None is torch's
        f32 machine epsilon; no affine weight, a weight of ones), sharing
        the weight."""
        if isinstance(raw, nn.RMSNorm):
            if len(raw.normalized_shape) != 1:
                raise ValueError("the Dmx RMSNorm normalizes over the last axis only")
            eps = raw.eps if raw.eps is not None else torch.finfo(torch.float32).eps
            mod = cls(raw.normalized_shape[0], eps=eps,
                      device="meta" if raw.weight is not None else None)
            if raw.weight is not None:
                mod.weight = raw.weight
            return mod
        mod = cls(raw.weight.shape[-1], eps=raw.eps, device="meta")
        mod.weight = raw.weight
        return mod


class GemmaRMSNorm(RMSNorm):
    """The (1 + weight) RMSNorm of Gemma; the weight starts at zero."""

    def __init__(self, normalized_shape: Union[int, Sequence[int]], eps: float = 1e-6,
                 device=None):
        super().__init__(normalized_shape, eps=eps, device=device)
        with torch.no_grad():
            self.weight.zero_()

    def functional_forward(self, x, normalized_shape, weight, eps):
        xf = x.to(torch.float32)
        ms = torch.mean(torch.square(xf), dim=-1, keepdim=True)
        y = xf * torch.rsqrt(ms + eps)
        if weight is not None:
            y = y * (1.0 + weight.to(torch.float32))
        return y.to(x.dtype)

    def approximator_wrapper(self, inputs, approx_args, approx_kwargs, **wrapper_kwargs):
        """The RMS_NORM surrogate multiplies by its weight argument, so it is
        handed 1 + w (w through the weight casts first, as the exact branch
        sees it)."""
        normalized_shape, weight, eps = approx_args
        if weight is not None:
            weight = 1.0 + weight.to(torch.float32)
        return self.approximator(*inputs, normalized_shape, weight, eps, **approx_kwargs)

    @classmethod
    def from_raw(cls, raw: rawnn.GemmaRMSNorm) -> "GemmaRMSNorm":
        mod = cls(raw.weight.shape[-1], eps=raw.eps, device="meta")
        mod.weight = raw.weight
        return mod


class BatchNorm2d(DmxModule):
    """BatchNorm over NCHW with the running-statistics logic of the JAX
    package: its own ``bn_training`` flag (False: the running statistics
    normalize; torch's ``train()`` / ``eval()`` leave it alone, as nnx's
    leave the JAX module's); with it set, or without running statistics,
    the batch's biased moments normalize, and in training the running
    mean and unbiased variance move by ``momentum`` (torch's convention:
    new = (1 - m) old + m batch)."""

    has_weight = True
    has_bias = True

    def __init__(self, num_features: int, eps: float = 1e-5, momentum: float = 0.1,
                 affine: bool = True, track_running_stats: bool = True, device=None):
        self.num_features = num_features
        self.eps = eps
        self.momentum = momentum
        self.affine = affine
        self.has_weight = affine
        self.has_bias = affine
        self.track_running_stats = track_running_stats
        self.bn_training = False
        super().__init__()
        if affine:
            self.weight = nn.Parameter(torch.ones(num_features, device=device))
            self.bias = nn.Parameter(torch.zeros(num_features, device=device))
        else:
            self.weight = None
            self.bias = None
        if track_running_stats:
            self.register_buffer("running_mean", torch.zeros(num_features, device=device))
            self.register_buffer("running_var", torch.ones(num_features, device=device))
            self.register_buffer("num_batches_tracked",
                                 torch.zeros((), dtype=torch.int32, device=device))
        else:
            self.running_mean = None
            self.running_var = None

    def _forward(self, _input):
        x = _input
        if self.bn_training or not self.track_running_stats:
            mean = torch.mean(x, dim=(0, 2, 3))
            var = torch.var(x, dim=(0, 2, 3), correction=0)
            if self.bn_training and self.track_running_stats:
                n = x.shape[0] * x.shape[2] * x.shape[3]
                m = self.momentum
                with torch.no_grad():
                    self.running_mean.copy_((1 - m) * self.running_mean + m * mean)
                    self.running_var.copy_((1 - m) * self.running_var
                                           + m * (var * n / max(n - 1, 1)))
                    self.num_batches_tracked.add_(1)
        else:
            mean, var = self.running_mean, self.running_var
        shape = (1, -1, 1, 1)
        y = (x - mean.reshape(shape)) * torch.rsqrt(var.reshape(shape) + self.eps)
        if self.affine:
            y = y * self._weight.reshape(shape) + self._bias.reshape(shape)
        return y

    @classmethod
    def from_raw(cls, raw: nn.BatchNorm2d) -> "BatchNorm2d":
        """Build from a torch ``nn.BatchNorm2d``, sharing its parameters and
        running statistics; its momentum is taken as it is (the same
        convention), in the running statistics' mode."""
        if raw.momentum is None:
            raise ValueError("momentum=None (a cumulative average): the Dmx BatchNorm2d "
                             "moves its statistics by a fixed momentum")
        mod = cls(raw.num_features, eps=raw.eps, momentum=raw.momentum, affine=raw.affine,
                  track_running_stats=raw.track_running_stats, device="meta")
        if raw.affine:
            mod.weight, mod.bias = raw.weight, raw.bias
        if raw.track_running_stats:
            mod.running_mean, mod.running_var = raw.running_mean, raw.running_var
            mod.num_batches_tracked = raw.num_batches_tracked
        return mod


class GroupNorm(DmxModule):
    """GroupNorm: each sample's channels in ``num_groups`` groups, each
    normalized by its biased moments, then the per-channel affine."""

    has_weight = True
    has_bias = True

    def __init__(self, num_groups: int, num_channels: int, eps: float = 1e-5,
                 affine: bool = True, device=None):
        self.num_groups = num_groups
        self.num_channels = num_channels
        self.eps = eps
        self.affine = affine
        self.has_weight = affine
        self.has_bias = affine
        super().__init__()
        if affine:
            self.weight = nn.Parameter(torch.ones(num_channels, device=device))
            self.bias = nn.Parameter(torch.zeros(num_channels, device=device))
        else:
            self.weight = None
            self.bias = None

    def _forward(self, _input):
        x = _input
        B, C = x.shape[0], x.shape[1]
        xg = x.reshape(B, self.num_groups, C // self.num_groups, *x.shape[2:])
        dims = tuple(range(2, xg.ndim))
        mean = torch.mean(xg, dim=dims, keepdim=True)
        var = torch.var(xg, dim=dims, keepdim=True, correction=0)
        y = ((xg - mean) * torch.rsqrt(var + self.eps)).reshape(x.shape)
        if self.affine:
            shape = (1, C) + (1,) * (x.ndim - 2)
            y = y * self._weight.reshape(shape) + self._bias.reshape(shape)
        return y

    @classmethod
    def from_raw(cls, raw: nn.GroupNorm) -> "GroupNorm":
        """Build from a torch ``nn.GroupNorm``, sharing its parameters."""
        mod = cls(raw.num_groups, raw.num_channels, eps=raw.eps, affine=raw.affine,
                  device="meta")
        if raw.affine:
            mod.weight, mod.bias = raw.weight, raw.bias
        return mod


class ApplyRotaryPosEmb(DmxModule):
    """RoPE application with four input casts (q, k, cos, sin) and two
    output casts (the rotated q and k)."""

    input_cast_names = ("q_cast", "k_cast", "cos_cast", "sin_cast")
    output_cast_names = ("q_embed_cast", "k_embed_cast")

    def _raw_forward(self, q, k, cos, sin, unsqueeze_dim=1):
        cos_e = cos.unsqueeze(unsqueeze_dim)
        sin_e = sin.unsqueeze(unsqueeze_dim)
        return q * cos_e + rotate_half(q) * sin_e, k * cos_e + rotate_half(k) * sin_e

    def _forward(self, q, k, cos, sin, unsqueeze_dim=1):
        return self.approx_forward((q, k, cos, sin), unsqueeze_dim)

    def forward(self, q, k, cos, sin, unsqueeze_dim=1):
        q = self.input_casts["q_cast"](q)
        k = self.input_casts["k_cast"](k)
        cos = self.input_casts["cos_cast"](cos)
        sin = self.input_casts["sin_cast"](sin)
        return self.output_casts(self._forward(q, k, cos, sin, unsqueeze_dim), output=True)

    @classmethod
    def from_raw(cls, raw=None):
        return cls()


class RotaryEmbedding(DmxModule):
    """The rotary cos / sin table generator (no cast: its single output
    cast name does not match its two outputs, as in the JAX package)."""

    def __init__(self, dim: int, max_position_embeddings: int = 2048, base: float = 10000.0,
                 attention_scaling: float = 1.0, device=None):
        self.dim = dim
        self.max_position_embeddings = max_position_embeddings
        self.base = base
        self.attention_scaling = attention_scaling
        super().__init__()
        self.register_buffer("inv_freq", rawnn.inv_freq(dim, base, device), persistent=False)

    def _forward(self, x, position_ids):
        return rawnn.rotary_cos_sin(self.inv_freq, position_ids, self.attention_scaling, x.dtype)

    def forward(self, x, position_ids):
        out = self._forward(x, position_ids)
        return self.output_casts(out, output=True) if len(self.output_casts) == 2 else out

    @classmethod
    def from_raw(cls, raw: rawnn.RotaryEmbedding) -> "RotaryEmbedding":
        mod = cls(raw.dim, raw.max_position_embeddings, raw.base, raw.attention_scaling,
                  device="meta")
        mod.inv_freq = raw.inv_freq  # shared
        return mod


class ScaledDotProductAttention(DmxModule):
    """Compound SDPA decomposed into quantizable sub-ops: actmatmul ->
    resadd(bias) -> mul(scale) -> softmax -> dropout -> actmatmul, with
    q/k/v/mask casts."""

    is_compound = True
    input_cast_names = (
        "query_states_cast",
        "key_states_cast",
        "value_states_cast",
        "attn_mask_cast",
    )

    def __init__(self, dropout_p: float = 0.0):
        super().__init__()
        for name in self.input_cast_names:
            self.input_casts[name].block_dim = -1
        self.resadd = ResAdd()
        self.actmatmul = ActActMatMul()
        self.softmax = Softmax(dim=-1)
        self.dropout = Dropout(p=dropout_p)
        self.mul = Mul()

    def forward(self, query, key, value, attn_mask=None, is_causal=False, scale=None,
                enable_gqa=False):
        query = self.input_casts["query_states_cast"](query)
        key = self.input_casts["key_states_cast"](key)
        value = self.input_casts["value_states_cast"](value)
        if attn_mask is not None and attn_mask.is_floating_point():
            attn_mask = self.input_casts["attn_mask_cast"](attn_mask)

        L, S = query.shape[-2], key.shape[-2]
        # the JAX package's default scale is an fp16 constant
        scale_factor = (
            float(torch.tensor(1.0 / math.sqrt(query.shape[-1]), dtype=torch.float16))
            if scale is None else scale
        )
        attn_bias = torch.zeros((L, S), dtype=query.dtype, device=query.device)
        if is_causal:
            if attn_mask is not None:
                raise ValueError("is_causal with an explicit attn_mask")
            causal = torch.ones((L, S), dtype=torch.bool, device=query.device).tril()
            attn_bias = attn_bias.masked_fill(~causal, -10000.0)
        if attn_mask is not None:
            if attn_mask.dtype == torch.bool:
                attn_bias = attn_bias.masked_fill(~attn_mask, -10000.0)
            else:
                attn_bias = self.resadd(attn_bias, attn_mask)
        if enable_gqa:
            key = torch.repeat_interleave(key, query.shape[-3] // key.shape[-3], dim=-3)
            value = torch.repeat_interleave(value, query.shape[-3] // value.shape[-3], dim=-3)

        attn_weight = self.actmatmul(query, key.transpose(-2, -1))
        attn_weight = self.resadd(attn_weight, attn_bias)
        attn_weight = self.mul(attn_weight, scale_factor)
        attn_weight = self.softmax(attn_weight)
        attn_weight = self.dropout(attn_weight)
        return self.actmatmul(attn_weight, value)

    @classmethod
    def from_raw(cls, raw=None):
        return cls(dropout_p=getattr(raw, "dropout_p", 0.0))
