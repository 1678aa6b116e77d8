"""Plugin hooks invoked from every DmxModule forward.

Port of ``dmx_compressor_tpu/plugins.py``.  Plugins observe each layer's
tensors before and after its casts (for error telemetry or logging) and may
transform the model when they are activated.
"""

from __future__ import annotations

from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Any, Dict, Tuple


@dataclass
class PluginLayerData:
    """Per-layer data handed to plugins."""

    input_before_cast: Any = None
    input_after_cast: Any = None
    output_before_cast: Any = None
    output_after_cast: Any = None
    mod: Any = None
    args: Tuple = ()
    kwargs: Dict = field(default_factory=dict)


class PluginBase:
    """Base plugin."""

    def process_model(self, model) -> None:
        """Input-independent model transform, run on activation."""

    def process_layer(self, data: PluginLayerData) -> None:
        """Called from every DmxModule forward with the layer's tensors."""


class ActivatePlugins:
    """Context manager activating plugins on a model."""

    def __init__(self, *plugins: PluginBase):
        self.plugins = list(plugins)

    @contextmanager
    def applied_to(self, model):
        from .nn.core import DmxModule

        for p in self.plugins:
            p.process_model(model)
        DmxModule.plugins = DmxModule.plugins + self.plugins
        try:
            yield model
        finally:
            DmxModule.plugins = [p for p in DmxModule.plugins if p not in self.plugins]
