"""Model-level API: DmxModel and DmxConfigRule.

Port of ``dmx_compressor_tpu/modeling/model.py`` (the parts the serving path
and the PTQ recipes use).  ``DmxModel.from_raw`` substitutes a raw torch
model's sub-modules with Dmx-aware ones; ``configure`` applies module configs
and rules; ``counting_flops`` counts the Linear and conv FLOPs of forwards.
"""

from __future__ import annotations

import re
from contextlib import ExitStack, contextmanager
from typing import Dict, Iterator, Optional, Tuple

from torch import nn

from ..nn.core import DmxModule
from ..transform.substitute import named_dmx_modules, substitute_transform


class DmxConfigRule:
    """Rule: (module_types, name_re) -> module_config."""

    def __init__(self, module_types=(), name_re: str = "",
                 module_config: Optional[Dict] = None) -> None:
        if not all(issubclass(mt, DmxModule) for mt in module_types):
            raise TypeError("module_types must be DmxModule subclasses")
        self.module_types = tuple(module_types)
        self.name_rule = re.compile(name_re)
        self.module_config = dict(module_config or {})

    def apply_to(self, model: nn.Module) -> None:
        for n, m in named_dmx_modules(model):
            if isinstance(m, self.module_types) and self.name_rule.match(n):
                m.configure(self.module_config)


class DmxModel:
    """Wrapper turning a raw torch model into a configurable Dmx model."""

    def __init__(self, module: nn.Module):
        self._module = module

    @classmethod
    def from_raw(cls, model: nn.Module, *rules, additional_mappings=None,
                 filter_fn=None) -> "DmxModel":
        module = substitute_transform(
            model, additional_mappings=additional_mappings, filter_fn=filter_fn
        )
        dm = cls(module)
        if rules:
            dm.configure(None, *rules)
        return dm

    @property
    def module(self) -> nn.Module:
        return self._module

    def __call__(self, *args, **kwargs):
        return self._module(*args, **kwargs)

    def __getattr__(self, name):
        return getattr(self._module, name)

    def named_dmx_modules(self) -> Iterator[Tuple[str, DmxModule]]:
        return named_dmx_modules(self._module)

    @property
    def dmx_module_dict(self) -> Dict[str, DmxModule]:
        return dict(self.named_dmx_modules())

    def configure(self, config: Optional[Dict[str, Dict]], *rules: DmxConfigRule) -> "DmxModel":
        """Apply a {module_name: module_config} dict and/or rules."""
        if config is not None:
            mods = self.dmx_module_dict
            for n, mc in config.items():
                if n in mods:
                    mods[n].configure(mc)
        for rule in rules:
            rule.apply_to(self._module)
        return self

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
