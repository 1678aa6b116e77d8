"""DmxModule: the quantization-aware module base.

Port of ``dmx_compressor_tpu/nn/core.py``.  A DmxModule wraps one logical op
with the co-design surface

    smoothquant input scale -> input casts -> (Hessian measurement)
    -> (approximation tuning) -> _forward -> output casts -> plugins
    -> flop counting -> caller-dtype realignment

and a weight pipeline

    sparsify -> smoothquant scale -> weight storage cast -> weight cast

which ``fold_weight_and_bias`` bakes into the parameters.  Every
``sparsifiable`` module carries a :class:`Sparsify` (dense until
configured) and every module with both channel axes an
:class:`ActivationWeightSmoothQuant` (idle until calibrated), as in the JAX
package; idle, neither adds an operation to a forward.  A module's state
dict round-trips through a ``file://`` URL (``state_dict_url``, a pickle of
numpy arrays under the port's own state-dict names).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Union

import torch
from torch import nn

from ..functional.approximate import (
    Approximate,
    ApproximationFunction,
    NoApproximation,
    approx_blend,
)
from ..layer_reconstruction import LayerReconstructionMixin
from ..numerics.cast import CastTo, CastToDict
from ..numerics.format import Format, Same
from ..numerics.smoothquant import ActivationWeightSmoothQuant
from ..perf_proxy import PerformanceProxyMixin
from ..plugins import PluginBase, PluginLayerData
from ..sparse import Dense, Sparsify
from ..utils.tracing import eager, try_set


def is_configurable(m) -> bool:
    return isinstance(m, DmxModule)


class DmxModule(PerformanceProxyMixin, LayerReconstructionMixin, nn.Module):
    """nn.Module with the numerics / sparsity / approximation co-design
    surface."""

    is_compound: bool = False
    functional_forward = None
    plugins: List[PluginBase] = []
    # inference mode: an approximated op returns the surrogate value
    # directly, skipping the exact op whose only role is carrying gradients
    inference_mode: bool = False
    # open Monitoring / RuntimeMeasurement contexts (utils/monitor.py): above
    # 0, the fused BASIC plans step aside so every monitored module is called
    monitors: int = 0
    # this module's tensor-parallel role (parallel.mesh.TPShard), set by
    # parallel.mesh.shard_state; None: unsharded
    tp_shard = None

    # cast topology, overridden per subclass
    ch_axis: Optional[int] = None  # input channel axis
    win_ch_axis: Optional[int] = None  # weight input-channel axis
    wout_ch_axis: Optional[int] = None  # weight output-channel axis
    has_accum: bool = False
    input_cast_names = ("input_cast",)
    output_cast_names = ("output_cast",)
    has_weight: bool = False
    has_bias: bool = False
    sparsifiable: bool = False  # a weight sparsifier attached

    def __init__(self) -> None:
        super().__init__()
        self.align_boundary_dtype = True
        self.state_dict_url = None
        self.approximator = Approximate()
        self.approximation_error = None
        self.aft = None
        self.obc = None
        self.init_casts()
        self.init_sparsifier()
        self.init_smoothquant()

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

    def init_sparsifier(self) -> None:
        self.weight_sparsifier = Sparsify() if self.sparsifiable else None

    def init_smoothquant(self, migration_strength: float = 0.5,
                         scale_format: Union[str, Format] = "SAME",
                         dynamic: bool = False) -> None:
        self.smoothquant = (
            ActivationWeightSmoothQuant(self.ch_axis, self.win_ch_axis, migration_strength,
                                        scale_format, dynamic)
            if self.ch_axis is not None and self.win_ch_axis is not None
            else None
        )

    # ----------------------------------------------------------- configure

    def configure(self, config: Dict[str, Any]) -> None:
        """Apply a module config; accepts the legacy singular-key grammar
        (``input_format`` / ``output_format``)."""
        config = dict(config)
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
        if self.smoothquant is not None and "smoothquant_scale_format" in config:
            self.smoothquant.set_scale_format(config["smoothquant_scale_format"])
        if self.weight_sparsifier is not None and "weight_sparseness" in config:
            self.weight_sparsifier.configure(sparseness=config["weight_sparseness"])
        if "approximation_function" in config:
            self.approximator.set_function(config["approximation_function"])
        if "state_dict_url" in config and config["state_dict_url"] != self.state_dict_url:
            self.load_state_dict_and_register_url(config["state_dict_url"])

    transform = configure

    def dmx_config(self, freeze: bool = False) -> "DmxModuleConfig":
        return DmxModuleConfig.from_module(self, freeze)

    # ---------------------------------------------------------- state dicts

    def load_state_dict_and_register_url(self, url: str) -> None:
        """Load the module's state from the pickle of numpy arrays at a
        ``file://`` URL (written by :meth:`save_state_dict_and_register_url`),
        in place and on the module's device, and record the URL.  The keys
        are the module's torch state-dict names; a pickle whose keys differ
        (one the JAX package wrote names nnx paths) raises ValueError naming
        the mismatch."""
        import pickle
        from urllib.parse import urlparse
        from urllib.request import url2pathname

        import numpy as np

        with open(url2pathname(urlparse(url).path), "rb") as f:
            flat = pickle.load(f)
        own = self.state_dict()
        if set(flat) != set(own):
            raise ValueError(
                f"state_dict_url {url}: its keys are not this module's state-dict names "
                f"(a pickle the JAX package wrote names nnx paths): missing "
                f"{sorted(set(own) - set(flat))}, unexpected {sorted(set(flat) - set(own))}")
        self.load_state_dict({k: torch.from_numpy(np.ascontiguousarray(v))
                              for k, v in flat.items()})
        self.state_dict_url = url

    def save_state_dict_and_register_url(self, parent_dir: str) -> None:
        """Write the module's state dict as a pickle of numpy arrays named
        by its md5 (``<md5>.pkl`` under ``parent_dir``) and record its
        ``file://`` URL as ``state_dict_url``."""
        import os
        import pickle
        import tempfile
        from pathlib import Path

        from ..utils.io import compute_md5

        fd, tmp = tempfile.mkstemp(dir=parent_dir, suffix=".pkl.tmp")
        with os.fdopen(fd, "wb") as f:
            pickle.dump({k: v.detach().cpu().numpy() for k, v in self.state_dict().items()}, f)
        file_name = os.path.join(parent_dir, f"{compute_md5(tmp)}.pkl")
        os.replace(tmp, file_name)
        self.state_dict_url = Path(os.path.abspath(file_name)).as_uri()

    # ------------------------------------------------------- weight pipeline

    @property
    def effective_weight(self) -> torch.Tensor:
        if self.weight_sparsifier is None:
            return self.weight
        return self.weight_sparsifier(self.weight)

    def weight_hypernet(self, w: torch.Tensor) -> torch.Tensor:
        """sparsify -> smoothquant scale -> storage cast -> weight cast."""
        if self.weight_sparsifier is not None:
            w = self.weight_sparsifier(w)
        if self.smoothquant is not None and not self.smoothquant.fused_to_weight:
            w = self.smoothquant.scale_weight(w)
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
        """Bake the bias cast, then the sparsifier, the unfused SmoothQuant
        scale, the weight storage cast and the weight cast into the
        parameters, each stage the identity afterwards (the sparsifier dense,
        the SmoothQuant marked fused, the casts SAME): the forward computes
        the same values.  A weight Parameter that another module shares (a
        head tied to the token embedding) changes for both, as in the JAX
        package."""
        with torch.no_grad():
            if getattr(self, "bias", None) is not None and self.bias_cast is not None and (
                    not isinstance(self.bias_format, Same)):
                self.bias.copy_(self.bias_cast(self.bias))
                self.bias_cast.set_format("SAME")
            if self.weight_sparsifier is not None and not isinstance(
                    self.weight_sparseness, Dense):
                self.weight.copy_(self.effective_weight)
                self.weight_sparsifier = Sparsify(sparseness=Dense())
            if self.smoothquant is not None and not self.smoothquant.fused_to_weight:
                self.weight.copy_(self.smoothquant.fuse_to_weight(self.weight))
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
            if isinstance(approx, tuple):
                try_set(self, "approximation_error",
                        [(a - e).detach() for a, e in zip(approx, exact)])
            else:
                try_set(self, "approximation_error", (approx - exact).detach())
            exact = approx_blend(exact, approx)
        return exact

    @property
    def approximation_function(self) -> ApproximationFunction:
        return self.approximator.function

    def forward(self, input: torch.Tensor, *args, **kwargs):
        _dtype = input.dtype
        sq = self.smoothquant
        if sq is not None:
            if sq.dynamic or sq.calibrating:
                self.update_smoothquant_scale(input)
            input_scaled = sq.scale_input(input)
        else:
            input_scaled = input
        _input, args2, kwargs2 = self.input_casts(input_scaled, *args, **kwargs)
        if self.obc is not None:
            self.obc.measure_hessian(_input)
        if self.aft is not None:
            self.aft.optimize(_input, *args2, **kwargs2)
        _output = self._forward(_input, *args2, **kwargs2)
        output = self.output_casts(_output, output=True)
        if DmxModule.plugins:
            data = PluginLayerData(
                input_before_cast=input, input_after_cast=_input,
                output_before_cast=_output, output_after_cast=output,
                mod=self, args=args2, kwargs=kwargs2,
            )
            plugins_copy = list(DmxModule.plugins)
            for p in plugins_copy:
                # a plugin's own calls of Dmx modules do not call it again
                DmxModule.plugins = [q for q in plugins_copy if q is not p]
                p.process_layer(data)
                DmxModule.plugins = list(plugins_copy)
        if self.flop_counter_enabled and eager():
            self.count_flops(input, output[0] if isinstance(output, (tuple, list)) else output)
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

    @property
    def weight_sparseness(self):
        return (self.weight_sparsifier.sparseness
                if self.weight_sparsifier is not None else None)

    @property
    def input_precision(self):
        return self.input_casts[self.input_cast_names[0]].get_precision()

    @property
    def weight_precision(self):
        return self.weight_cast.get_precision()

    @property
    def weight_storage_precision(self):
        return self.weight_storage_cast.get_precision()

    @property
    def weight_scale(self):
        return self.weight_cast.scale

    @property
    def weight_zero_point(self):
        return self.weight_cast.zero_point

    @property
    def weight_storage_scale(self):
        return self.weight_storage_cast.scale

    @property
    def weight_storage_zero_point(self):
        return self.weight_storage_cast.zero_point

    # -------------------------------------------------------------- export

    def to_compiler_graph(self):
        """The module's Q/DQ-annotated op graph for the downstream compiler
        (``transform/qdq.py``)."""
        from ..transform.qdq import module_compiler_graph

        return module_compiler_graph(self)


class DmxModuleConfig(dict):
    """Dict of a DmxModule's configurable surface: what differs from the
    defaults, or everything with ``freeze``; ``configure`` takes it back."""

    @classmethod
    def from_module(cls, module: DmxModule, freeze: bool = False):
        cc = cls(instance_of=module.__class__)
        if not isinstance(module, DmxModule):
            return cc

        def keep(value, default_type):
            return value is not None and (freeze or not isinstance(value, default_type))

        if module.input_formats is not None and (
                freeze or not all(isinstance(f, Same) for f in module.input_formats.values())):
            cc["input_formats"] = module.input_formats
        if module.output_formats is not None and (
                freeze or not all(isinstance(f, Same) for f in module.output_formats.values())):
            cc["output_formats"] = module.output_formats
        for key in ("accum_format", "weight_format", "weight_storage_format", "bias_format"):
            if keep(getattr(module, key), Same):
                cc[key] = getattr(module, key)
        if module.smoothquant is not None and keep(module.smoothquant.scale_cast.format, Same):
            cc["smoothquant_scale_format"] = module.smoothquant.scale_cast.format
        if keep(module.weight_sparseness, Dense):
            cc["weight_sparseness"] = module.weight_sparseness
        if freeze or not isinstance(module.approximation_function, NoApproximation):
            cc["approximation_function"] = module.approximation_function
        if module.state_dict_url is not None:
            cc["state_dict_url"] = module.state_dict_url
        return cc
