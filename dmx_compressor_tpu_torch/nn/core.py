"""DmxModule: the quantization-aware module base.

Port of ``dmx_compressor_tpu/nn/core.py``.  A DmxModule wraps one logical op
with the co-design surface

    input casts -> _forward -> output casts -> caller-dtype realignment

and a weight pipeline (storage cast -> weight cast), which
``fold_weight_and_bias`` bakes into the parameters.  The smoothquant, OBC,
AFT, sparsity and plugin hooks of the JAX package are not ported yet: they
stay ``None`` (plugins: empty) and a module that finds one set raises.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import torch
from torch import nn

from ..functional.approximate import (
    Approximate,
    ApproximationFunction,
    NoApproximation,
    approx_blend,
)
from ..numerics.cast import CastTo, CastToDict
from ..numerics.format import Format, Same

_HOOKS_TODO = (
    "smoothquant / OBC / AFT / sparsity / plugin hooks arrive with the "
    "calibration/PTQ slice of the port"
)
_UNPORTED_KEYS = ("smoothquant_scale_format", "weight_sparseness", "state_dict_url")


class DmxModule(nn.Module):
    """nn.Module with the numerics / approximation co-design surface."""

    is_compound: bool = False
    functional_forward = None
    plugins: List[Any] = []
    # inference mode: an approximated op returns the surrogate value
    # directly, skipping the exact op whose only role is carrying gradients
    inference_mode: bool = False

    # cast topology, overridden per subclass
    ch_axis: Optional[int] = None  # input channel axis
    win_ch_axis: Optional[int] = None  # weight input-channel axis
    wout_ch_axis: Optional[int] = None  # weight output-channel axis
    has_accum: bool = False
    input_cast_names = ("input_cast",)
    output_cast_names = ("output_cast",)
    has_weight: bool = False
    has_bias: bool = False

    def __init__(self) -> None:
        super().__init__()
        self.align_boundary_dtype = True
        self.approximator = Approximate()
        self.smoothquant = None
        self.obc = None
        self.aft = None
        self.weight_sparsifier = None
        self.init_casts()

    def init_casts(self) -> None:
        self.input_casts = CastToDict(
            {
                name: CastTo(ch_axis=self.ch_axis if i == 0 else -1)
                for i, name in enumerate(self.input_cast_names)
            }
        )
        self.output_casts = CastToDict({name: CastTo() for name in self.output_cast_names})
        self.accum_cast = CastTo() if self.has_accum else None
        self.weight_storage_cast = CastTo(ch_axis=self.wout_ch_axis) if self.has_weight else None
        self.weight_cast = CastTo(ch_axis=self.wout_ch_axis) if self.has_weight else None
        self.bias_cast = CastTo() if self.has_bias else None

    def _check_hooks(self) -> None:
        if (
            self.smoothquant is not None
            or self.obc is not None
            or self.aft is not None
            or self.weight_sparsifier is not None
            or DmxModule.plugins
        ):
            raise NotImplementedError(_HOOKS_TODO)

    # ----------------------------------------------------------- configure

    def configure(self, config: Dict[str, Any]) -> None:
        """Apply a module config; accepts the legacy singular-key grammar
        (``input_format`` / ``output_format``)."""
        config = dict(config)
        for key in _UNPORTED_KEYS:
            if key in config:
                raise NotImplementedError(f"{key}: {_HOOKS_TODO}")
        if "input_format" in config:
            config.setdefault("input_formats", [config.pop("input_format")])
        if "output_format" in config:
            config.setdefault("output_formats", [config.pop("output_format")])
        for k in ("input_formats", "output_formats"):
            if k in config and isinstance(config[k], (list, tuple)):
                config[k] = [
                    Format.from_shorthand(f) if isinstance(f, str) else f for f in config[k]
                ]
        if "input_formats" in config:
            self.input_casts.set_format(config["input_formats"])
        if "pre_input_transform" in config:
            self.input_casts.set_pre_transform(config["pre_input_transform"])
        if "output_formats" in config:
            self.output_casts.set_format(config["output_formats"])
        if "pre_output_transform" in config:
            self.output_casts.set_pre_transform(config["pre_output_transform"])
        if self.accum_cast is not None and "accum_format" in config:
            self.accum_cast.set_format(config["accum_format"])
        if self.weight_storage_cast is not None and "weight_storage_format" in config:
            self.weight_storage_cast.set_format(config["weight_storage_format"])
        if self.weight_cast is not None and "weight_format" in config:
            self.weight_cast.set_format(config["weight_format"])
        if self.weight_cast is not None and "pre_weight_transform" in config:
            self.weight_cast.set_pre_transform(config["pre_weight_transform"])
        if self.bias_cast is not None and "bias_format" in config:
            self.bias_cast.set_format(config["bias_format"])
        if "approximation_function" in config:
            self.approximator.set_function(config["approximation_function"])

    # ------------------------------------------------------- weight pipeline

    def weight_hypernet(self, w: torch.Tensor) -> torch.Tensor:
        """storage cast -> weight cast."""
        if self.weight_storage_cast is not None:
            w = self.weight_storage_cast(w)
        if self.weight_cast is not None:
            w = self.weight_cast(w)
        return w

    @property
    def _weight(self) -> torch.Tensor:
        return self.weight_hypernet(self.weight)

    @property
    def _bias(self) -> Optional[torch.Tensor]:
        if getattr(self, "bias", None) is None:
            return None
        return self.bias_cast(self.bias) if self.bias_cast is not None else None

    def fold_weight_and_bias(self) -> None:
        """Bake the bias cast, then the weight storage cast, then the weight
        cast into the parameters, each cast SAME afterwards: the forward
        computes the same values.  A weight Parameter that another module
        shares (a head tied to the token embedding) is cast for both, as in
        the JAX package.  The sparsifier and SmoothQuant branches of the JAX
        package arrive with those hooks (``_check_hooks`` refuses them)."""
        self._check_hooks()
        with torch.no_grad():
            if getattr(self, "bias", None) is not None and self.bias_cast is not None and (
                    not isinstance(self.bias_format, Same)):
                self.bias.copy_(self.bias_cast(self.bias))
                self.bias_cast.set_format("SAME")
            for cast in (self.weight_storage_cast, self.weight_cast):
                if cast is not None and not isinstance(cast.format, Same):
                    self.weight.copy_(cast(self.weight))
                    cast.set_format("SAME")

    # ----------------------------------------------------------- forward

    def _forward(self, *args, **kwargs):
        raise NotImplementedError

    def approximator_wrapper(self, inputs, approx_args, approx_kwargs, **wrapper_kwargs):
        """Hook for input pre-processing before the surrogate."""
        return self.approximator(*inputs, *approx_args, **approx_kwargs)

    def approx_forward(self, inputs: tuple, *args, **kwargs):
        """Exact forward with value replacement by the approximation."""
        fn = self.approximator.function
        if DmxModule.inference_mode and not isinstance(fn, NoApproximation):
            return self.approximator_wrapper(inputs, args, kwargs, **fn.wrapper_params)
        if self.functional_forward is not None:
            exact = self.functional_forward(*inputs, *args, **kwargs)
        else:
            exact = self._raw_forward(*inputs, *args, **kwargs)
        if not isinstance(fn, NoApproximation):
            approx = self.approximator_wrapper(inputs, args, kwargs, **fn.wrapper_params)
            exact = approx_blend(exact, approx)
        return exact

    @property
    def approximation_function(self) -> ApproximationFunction:
        return self.approximator.function

    def forward(self, input: torch.Tensor, *args, **kwargs):
        self._check_hooks()
        _dtype = input.dtype
        _input, args2, kwargs2 = self.input_casts(input, *args, **kwargs)
        output = self.output_casts(self._forward(_input, *args2, **kwargs2), output=True)
        if self.align_boundary_dtype:
            output = (
                type(output)(a.to(_dtype) for a in output)
                if isinstance(output, (tuple, list))
                else output.to(_dtype)
            )
        return output

    # --------------------------------------------------------- format views

    @property
    def input_formats(self):
        return {k: cast.format for k, cast in self.input_casts.items()}

    @property
    def output_formats(self):
        return {k: cast.format for k, cast in self.output_casts.items()}

    @property
    def accum_format(self):
        return self.accum_cast.format if self.accum_cast is not None else None

    @property
    def weight_format(self):
        return self.weight_cast.format if self.weight_cast is not None else None

    @property
    def weight_storage_format(self):
        return self.weight_storage_cast.format if self.weight_storage_cast is not None else None

    @property
    def bias_format(self):
        return self.bias_cast.format if self.bias_cast is not None else None
