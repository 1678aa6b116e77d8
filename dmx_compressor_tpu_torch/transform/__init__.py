"""Module-tree transforms."""

from .substitute import (
    DMX_AWARE_MAPPING,
    RAW_OP_MAPPING,
    default_mapping,
    named_dmx_modules,
    substitute_transform,
)
