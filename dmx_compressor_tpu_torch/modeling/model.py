"""Model-level API: DmxModel, DmxConfig, DmxConfigRule and the pipelines.

Port of ``dmx_compressor_tpu/modeling/model.py``.  ``DmxModel.from_raw``
substitutes a raw torch model's sub-modules with Dmx-aware ones;
``configure`` applies a :class:`DmxConfig` (a yaml file, a dict of module
configs) and rules through a queue that ``replay_configuration`` re-applies;
``freeze`` / ``thaw`` write and read the whole configuration as yaml that
round-trips with the JAX package's; ``compiled`` is ``torch.compile`` of the
model (or of a function over it), cached per target until the next
``configure``; ``counting_flops``, ``monitoring`` and ``measure_runtimes``
observe forwards; ``make_compiler_graphs`` and ``visualize_graph`` give the
export graphs; ``from_function`` intercepts a plain torch function.
"""

from __future__ import annotations

import re
from contextlib import ExitStack, contextmanager
from typing import Callable, Dict, Iterator, List, Optional, Tuple, Union

import torch
from torch import nn

from ..nn.core import DmxModule, DmxModuleConfig
from ..transform.substitute import named_dmx_modules, substitute_transform
from ..utils import io as uio


def _module_of(model) -> nn.Module:
    return model.module if isinstance(model, DmxModel) else model


class DmxConfig(dict):
    """{module_name -> DmxModuleConfig}, with a yaml round trip."""

    @classmethod
    def from_model(cls, model, freeze: bool = False) -> "DmxConfig":
        return cls({n: m.dmx_config(freeze) for n, m in named_dmx_modules(_module_of(model))})

    @classmethod
    def from_yaml(cls, fname: str) -> "DmxConfig":
        return cls(uio.load_config_file(fname))

    def to_yaml(self, fname: str) -> None:
        uio.save_config_file({k: dict(v) for k, v in self.items()}, fname)

    @property
    def module_names(self):
        return self.keys()


class DmxConfigRule:
    """Rule: (module_types, name_re) -> module_config."""

    def __init__(self, module_types=(), name_re: str = "",
                 module_config: Optional[Dict] = None) -> None:
        if not all(issubclass(mt, DmxModule) for mt in module_types):
            raise TypeError("module_types must be DmxModule subclasses")
        self.module_types = tuple(module_types)
        self.name_rule = re.compile(name_re)
        self.module_config = DmxModuleConfig(module_config or {})

    def names_in(self, model_or_config) -> List[str]:
        """The names the rule selects, in a model or in a DmxConfig."""
        config = (model_or_config if isinstance(model_or_config, DmxConfig)
                  else DmxConfig.from_model(model_or_config, freeze=True))
        return [
            n for n in config.module_names
            if any(issubclass(config[n]["instance_of"], mt) for mt in self.module_types)
            and self.name_rule.match(n)
        ]

    def apply_to(self, model_or_config) -> None:
        """Configure the selected modules of a model, or update the selected
        entries of a DmxConfig."""
        if isinstance(model_or_config, DmxConfig):
            for n in self.names_in(model_or_config):
                model_or_config[n].update(self.module_config)
            return
        for n, m in named_dmx_modules(_module_of(model_or_config)):
            if isinstance(m, self.module_types) and self.name_rule.match(n):
                m.configure(self.module_config)


# the JAX package's alias
DmxTransformation = DmxConfigRule


class DmxModel:
    """Wrapper turning a raw torch model into a configurable Dmx model."""

    def __init__(self, module: nn.Module):
        self._module = module
        self._dmx_configuration_queue: List[Tuple] = []
        self._compiled: Dict[int, Callable] = {}

    @classmethod
    def from_raw(cls, model: nn.Module, *rules, additional_mappings=None,
                 filter_fn=None) -> "DmxModel":
        if getattr(model, "tp_placement", None) is not None:
            raise ValueError("DmxModel.from_raw: the model is sharded (parallel.shard_state); "
                             "build its mode first, then shard it")
        module = substitute_transform(
            model, additional_mappings=additional_mappings, filter_fn=filter_fn
        )
        dm = cls(module)
        if rules:
            dm.configure(None, *rules)
        return dm

    @staticmethod
    def from_function(fn, example_args, rules=None):
        """Fake-quantize an arbitrary (un-authored) torch function by ATen-op
        interception: the functional counterpart of ``from_raw`` for code
        that is not written against the module zoo.  Returns a
        :class:`~dmx_compressor_tpu_torch.transform.intercept.QuantizedFunction`
        whose ``sites`` list addresses every intercepted op and whose
        ``configure({site: SiteRule})`` plays the role of config rules."""
        from ..transform.intercept import QuantizedFunction

        return QuantizedFunction(fn, example_args, rules)

    @property
    def module(self) -> nn.Module:
        return self._module

    def __call__(self, *args, **kwargs):
        return self._module(*args, **kwargs)

    def __getattr__(self, name):
        return getattr(self._module, name)

    # ------------------------------------------------------------- config

    def named_dmx_modules(self) -> Iterator[Tuple[str, DmxModule]]:
        return named_dmx_modules(self._module)

    @property
    def dmx_module_dict(self) -> Dict[str, DmxModule]:
        return dict(self.named_dmx_modules())

    def get_submodule(self, name: str) -> DmxModule:
        return self.dmx_module_dict[name]

    @property
    def op_set(self):
        return {type(m).__name__ for _, m in self.named_dmx_modules()}

    def configure(self, config: Optional[Union[str, Dict]], *rules: DmxConfigRule) -> "DmxModel":
        """Apply a DmxConfig (a yaml file name, or a dict of module configs
        by name) and/or rules; queued for ``replay_configuration``; drops
        every ``compiled`` callable."""
        self._dmx_configuration_queue.append((config, rules))
        self._apply_configuration(config, rules)
        self._compiled.clear()
        return self

    transform = configure

    def _apply_configuration(self, config, rules) -> None:
        if config is not None:
            if isinstance(config, str):
                config = DmxConfig.from_yaml(config)
            mods = self.dmx_module_dict
            for n, mc in config.items():
                if n in mods:
                    mods[n].configure(mc)
        for rule in rules:
            rule.apply_to(self._module)

    def replay_configuration(self) -> None:
        """Re-apply every queued configuration, in order."""
        for config, rules in self._dmx_configuration_queue:
            self._apply_configuration(config, rules)

    # ------------------------------------------------------- freeze / thaw

    @property
    def dmx_config(self) -> DmxConfig:
        return DmxConfig.from_model(self._module)

    def freeze(self, fname: str) -> None:
        """Write the whole configuration (every key of every module) as yaml."""
        DmxConfig.from_model(self._module, freeze=True).to_yaml(fname)

    def thaw(self, fname: str) -> "DmxModel":
        """Apply a frozen configuration."""
        return self.configure(fname)

    # -------------------------------------------------------------- modes

    def to_baseline_mode(self) -> "DmxModel":
        from .. import config_rules

        return self.configure(None, *config_rules.BASELINE)

    def to_basic_mode(self, sbfp_weight_storage: bool = False) -> "DmxModel":
        from .. import config_rules

        self.configure(None, *config_rules.BASIC)
        if sbfp_weight_storage:
            self.configure(None, *config_rules.SBFP_WEIGHT_STORAGE)
        return self

    def to_fp8_mode(self) -> "DmxModel":
        from .. import config_rules

        return self.configure(None, *config_rules.FP8)

    def fold_weights_and_biases(self) -> None:
        for _, m in self.named_dmx_modules():
            m.fold_weight_and_bias()

    def save_specific_layers_state_dict_and_register_urls(self, parent_dir: str,
                                                          layers: List[str]) -> None:
        """Each named module's state dict written under ``parent_dir`` and
        its ``file://`` URL recorded (``DmxModule.save_state_dict_and_register_url``),
        so a frozen configuration carries it."""
        mods = self.dmx_module_dict
        for n in layers:
            mods[n].save_state_dict_and_register_url(parent_dir)

    # ------------------------------------------------------------ compile

    def compiled(self, fn: Optional[Callable] = None, **options):
        """``torch.compile`` of ``fn`` (the model when None) over the current
        configuration, cached per target until the next ``configure``.

        ``options`` go to ``torch.compile``.  Inductor's
        ``emulate_precision_casts`` is on unless an option says otherwise:
        without it Inductor drops the round trip through float16 that a
        FLOAT16 cast's plain version makes, so a compiled cast would not be
        the cast.  A T2 launch (``ops/bfp_cast.py``) is an operator of the
        graph; the other kernels' launches, calls through ``ctypes``, break
        it and run as in eager.  Nothing here catches a compile error.
        Inside the compiled graph the modules write no diagnostic state
        (``utils/tracing.py``)."""
        target = fn if fn is not None else self._module
        key = id(target)
        if key not in self._compiled:
            if options.get("backend", "inductor") == "inductor":
                inductor = dict(options.get("options") or {})
                inductor.setdefault("emulate_precision_casts", True)
                options = {**options, "options": inductor}
            self._compiled[key] = torch.compile(target, **options)
        return self._compiled[key]

    # ------------------------------------------------------------- export

    def visualize_graph(self, file_name=None):
        """Graphviz dot text of every module's Q/DQ graph
        (``transform/visualize.py``); with ``file_name`` also written there."""
        from ..transform.visualize import visualize_graph

        return visualize_graph(self, file_name)

    def make_compiler_graphs(self):
        """The Q/DQ-annotated export graph of every module
        (``transform/qdq.py``); ``.skipped`` names the modules without one."""
        from ..transform.qdq import make_compiler_graph

        return make_compiler_graph(self._module)

    # -------------------------------------------------------- monitoring

    @contextmanager
    def counting_flops(self, zero: bool = True):
        """FLOP counting on every DmxModule within the context."""
        with ExitStack() as stack:
            for _, m in self.named_dmx_modules():
                stack.enter_context(m.counting_flops(zero))
            yield self

    @property
    def flops(self):
        return sum(m.flops or 0 for _, m in self.named_dmx_modules() if m.flop_counter)

    def monitoring(self, submodules: Optional[List[str]] = None):
        """Record the inputs and outputs of the DmxModules (``submodules``:
        by name; all when None) within the context."""
        from ..utils.monitor import Monitoring

        return Monitoring(self, submodules)

    def measure_runtimes(self, submodules: Optional[List[str]] = None):
        """Record the runtimes of the DmxModules within the context."""
        from ..utils.monitor import RuntimeMeasurement

        return RuntimeMeasurement(self, submodules)


class DmxPipelineMixin:
    """Pipeline-level configure / freeze / thaw."""

    def configure(self, config, *rules):
        self.model.configure(config, *rules)
        return self

    def freeze(self, fname):
        self.model.freeze(fname)

    def thaw(self, fname):
        self.model.thaw(fname)
        return self


class DmxSimplePipeline(DmxPipelineMixin):
    """preprocessor -> model -> postprocessor."""

    def __init__(self, preprocessor=None, model=None, postprocessor=None):
        self.preprocessor = preprocessor
        self.model = model
        self.postprocessor = postprocessor

    def __call__(self, x):
        if self.preprocessor is not None:
            x = self.preprocessor(x)
        x = self.model(x)
        if self.postprocessor is not None:
            x = self.postprocessor(x)
        return x


# the JAX package's legacy alias
Model = DmxSimplePipeline
