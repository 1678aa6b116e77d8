"""Post-training optimization recipes.

Port of ``dmx_compressor_tpu/advanced_recipe.py``.  A recipe is an ExitStack
of per-module context managers (``layer_reconstruction.py``) produced by a
hyperparameter generator: the user runs calibration batches through the
model inside ``applied_to`` and each module's state machine does the rest.
"""

from __future__ import annotations

from contextlib import ExitStack, contextmanager
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

from .numerics.observer import HistogramObserver


# ---------------------------------------------------------------------------
# hyperparameters
# ---------------------------------------------------------------------------


@dataclass
class DmxModuleQuantizerCalibrationHyperparams:
    """Per-cast calibration settings keyed like the cast dicts."""

    inputs: Optional[Dict[str, "CastCalibrationHyperparams"]] = None
    outputs: Optional[Dict[str, "CastCalibrationHyperparams"]] = None
    weight: Optional["CastCalibrationHyperparams"] = None
    weight_storage: Optional["CastCalibrationHyperparams"] = None


@dataclass
class CastCalibrationHyperparams:
    observer_cls: type = HistogramObserver
    qscheme_to_overload: Optional[str] = "per_tensor_affine"
    group_size: Optional[int] = None
    ch_axis: Optional[int] = None


@dataclass
class DmxModuleSmoothQuantHyperparams:
    migration_strength: float = 0.5
    fuse_to_weight: bool = False


@dataclass
class DmxModuleGPTQHyperparams:
    microblock_size: int = 1
    block_size: int = 128
    percdamp: float = 0.01


@dataclass
class DmxModuleApproximationFunctionTuningHyperparams:
    # (param_name, low, high) per searched parameter
    search_space: List[Tuple[str, float, float]] = field(default_factory=list)


@dataclass
class DmxModuleSLaNCHyperparams:
    position: str = "post_attn"  # post_attn | post_mlp | first
    mlp_type: str = "standard"  # standard | llama
    prev_ln_weight: Optional[object] = None
    v_proj: Optional[object] = None
    o_proj: Optional[object] = None
    fc1: Optional[object] = None
    fc2: Optional[object] = None
    gate_proj: Optional[object] = None
    up_proj: Optional[object] = None
    down_proj: Optional[object] = None
    device: Optional[object] = None


# ---------------------------------------------------------------------------
# recipes
# ---------------------------------------------------------------------------


class DmxBaseRecipe:
    """ExitStack of per-module context managers from a hyperparameter
    generator."""

    context_method: str = ""

    def __init__(self, hyperparam_generator: Callable):
        self.hyperparam_generator = hyperparam_generator

    @contextmanager
    def applied_to(self, model):
        hp_map = self.hyperparam_generator(model)
        with ExitStack() as stack:
            for module, hp in hp_map.items():
                stack.enter_context(getattr(module, self.context_method)(hp))
            yield model


class DmxQuantizerCalibrationRecipe(DmxBaseRecipe):
    context_method = "calibrating_quantizers"


class DmxSmoothQuantRecipe(DmxBaseRecipe):
    context_method = "calibrating_smoothquant"


class DmxGPTQRecipe(DmxBaseRecipe):
    context_method = "optimal_brain_compressing"


class DmxApproximationFunctionTuningRecipe(DmxBaseRecipe):
    context_method = "tuning_approximation_function"


class DmxSLaNCRecipe(DmxBaseRecipe):
    context_method = "slanc_tuning"


# ---------------------------------------------------------------------------
# generators over every Linear
# ---------------------------------------------------------------------------


def _linears(model):
    from .nn import modules as dmxnn
    from .transform.substitute import named_dmx_modules

    root = model.module if hasattr(model, "module") else model
    return [m for _, m in named_dmx_modules(root) if isinstance(m, dmxnn.Linear)]


def input_calibration_for_all_linears(observer_cls=HistogramObserver,
                                      qscheme="per_tensor_affine",
                                      group_size=None) -> Callable:
    """Generator: calibrate every Linear's input casts."""

    def gen(model):
        return {
            m: DmxModuleQuantizerCalibrationHyperparams(inputs={
                k: CastCalibrationHyperparams(observer_cls=observer_cls,
                                              qscheme_to_overload=qscheme,
                                              group_size=group_size)
                for k in m.input_casts.keys()
            })
            for m in _linears(model)
        }

    return gen


def smoothquant_for_all_linears(migration_strength: float = 0.5,
                                fuse_to_weight: bool = False) -> Callable:
    def gen(model):
        return {m: DmxModuleSmoothQuantHyperparams(migration_strength, fuse_to_weight)
                for m in _linears(model)}

    return gen


def gptq_for_all_linears(**kw) -> Callable:
    def gen(model):
        return {m: DmxModuleGPTQHyperparams(**kw) for m in _linears(model)}

    return gen
