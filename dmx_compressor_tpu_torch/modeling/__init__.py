"""Model-level API."""

from .model import (
    DmxConfig,
    DmxConfigRule,
    DmxModel,
    DmxPipelineMixin,
    DmxSimplePipeline,
    DmxTransformation,
    Model,
)
