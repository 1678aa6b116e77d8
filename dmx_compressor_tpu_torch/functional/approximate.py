"""Approximation-function taxonomy: shorthand grammar and execution.

Port of ``dmx_compressor_tpu/functional/approximate.py``.  Shorthand grammar
``FUNC[algorithm]{wrapper_params}(extra_params)``.  A configured
approximation executes the vsimd surrogate of the same name in
``simd_ops.FUNCTIONS``.

Value replacement with the exact op's gradient is
``exact + (approx - exact).detach()``.
"""

from __future__ import annotations

import ast
import re
from typing import Any, Dict

from . import simd_ops

TORCH_FUNCTION_IDS = {
    "GELU": "gelu",
    "SILU": "silu",
    "RMS_NORM": "rms_norm",
    "LAYER_NORM": "layer_norm",
    "SOFTMAX": "softmax",
    "EXP": "exp",
}

CUSTOM_FUNCTION_IDS = {
    "QUICK_GELU": "quick_gelu",
    "APPLY_LLAMA_ROPE": "apply_rotary_pos_emb",
}


def string_to_kwargs(kwargs_string: str) -> Dict[str, Any]:
    """Parse ``"k1=v1, k2=v2"`` into a dict, literal values evaluated."""
    kwargs: Dict[str, Any] = {}
    if kwargs_string:
        for item in kwargs_string.split(","):
            key, value = item.split("=")
            value = value.strip()
            try:
                parsed = ast.literal_eval(value)
            except (ValueError, SyntaxError):
                parsed = value
            kwargs[key.strip()] = parsed
    return kwargs


def kwargs_to_string(**kwargs) -> str:
    return ", ".join(f"{key}={value}" for key, value in kwargs.items())


def approx_blend(exact, approx):
    """Value of ``approx``, gradient of ``exact``."""
    if isinstance(exact, tuple):
        return tuple(approx_blend(e, a) for e, a in zip(exact, approx))
    return exact + (approx - exact).detach()


class ApproximationFunction:
    """Abstract approximation algorithm."""

    def execute(self, *args, **kwargs):
        raise NotImplementedError

    @staticmethod
    def from_shorthand(sh: str) -> "ApproximationFunction":
        sh = sh.strip()
        if sh.startswith("NONE"):
            return NoApproximation.from_shorthand(sh)
        if sh.startswith(tuple(TORCH_FUNCTION_IDS)):
            return TorchFunctionApproximation.from_shorthand(sh)
        if sh.startswith(tuple(CUSTOM_FUNCTION_IDS)):
            return CustomFunctionApproximation.from_shorthand(sh)
        raise ValueError(f"unrecognized approximation function shorthand: {sh}")

    def __eq__(self, other):
        return isinstance(other, ApproximationFunction) and repr(self) == repr(other)

    def __hash__(self):
        return hash(repr(self))


class NoApproximation(ApproximationFunction):
    """No approximation."""

    def execute(self, *args, **kwargs):
        raise RuntimeError("NoApproximation is not supposed to be executed")

    @classmethod
    def from_shorthand(cls, sh):
        return cls()

    def __repr__(self):
        return "NONE"


_SH_RE = re.compile(r"(\w+)\[(\w+)\]\{(.*?)\}\((.*)\)")


Identity = NoApproximation  # the JAX package's alias


class _FunctionApproximation(ApproximationFunction):
    """Shared machinery for torch-function and custom-function surrogates."""

    _ids: Dict[str, str] = {}

    def __init__(self, func_id: str, algorithm: str = "vsimd",
                 wrapper_params: Dict[str, Any] = None,
                 extra_params: Dict[str, Any] = None):
        self.func_id = func_id
        self.func_name = self._ids[func_id]
        self.algorithm = algorithm
        self.wrapper_params = dict(wrapper_params or {})
        self.extra_params = dict(extra_params or {})

    @classmethod
    def from_shorthand(cls, sh):
        m = _SH_RE.fullmatch(sh.strip())
        if m is None:
            raise ValueError(f"malformed approximation shorthand: {sh!r}")
        return cls(
            func_id=m.group(1),
            algorithm=m.group(2),
            wrapper_params=string_to_kwargs(m.group(3)),
            extra_params=string_to_kwargs(m.group(4)),
        )

    def execute(self, *args, **kwargs):
        if self.algorithm not in ("vsimd", "experimental"):
            raise ValueError(
                f"unknown approximation algorithm {self.algorithm} for {self.func_id}"
            )
        return simd_ops.FUNCTIONS[self.func_name](*args, **kwargs, **self.extra_params)

    def __repr__(self):
        return (
            f"{self.func_id}[{self.algorithm}]"
            f"{{{kwargs_to_string(**self.wrapper_params)}}}"
            f"({kwargs_to_string(**self.extra_params)})"
        )


class TorchFunctionApproximation(_FunctionApproximation):
    """Surrogates for standard functional ops."""

    _ids = TORCH_FUNCTION_IDS


class CustomFunctionApproximation(_FunctionApproximation):
    """Surrogates for custom functions."""

    _ids = CUSTOM_FUNCTION_IDS


class Approximate:
    """Approximation operator container."""

    def __init__(self, function=None):
        self.function: ApproximationFunction = NoApproximation()
        if function is not None:
            self.set_function(function)

    def set_function(self, function) -> None:
        if not isinstance(function, ApproximationFunction):
            function = ApproximationFunction.from_shorthand(function)
        self.function = function

    def __call__(self, *args, **kwargs):
        return self.function.execute(*args, **kwargs)

    def __repr__(self):
        return f"Approximate(function={repr(self.function)})"


class Approximator:
    """Standalone approximation of a single tensor op, its error kept:
    ``approximation_error`` is the surrogate's first output minus the input
    it replaced, detached."""

    def __init__(self, function=None):
        if function is None:
            function = NoApproximation()
        if not isinstance(function, ApproximationFunction):
            function = ApproximationFunction.from_shorthand(function)
        self.function = function
        self.approximation_error = None

    def __call__(self, x):
        out = self.function.execute(x)
        out0 = out[0] if isinstance(out, tuple) else out
        if not isinstance(self.function, NoApproximation):
            from ..utils.tracing import try_set

            try_set(self, "approximation_error", (out0 - x).detach())
        return out0
