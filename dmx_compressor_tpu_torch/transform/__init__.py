"""Module-tree transforms, the Q/DQ export graphs and functional interception."""

from .substitute import (
    DMX_AWARE_MAPPING,
    RAW_OP_MAPPING,
    default_mapping,
    named_dmx_modules,
    substitute_transform,
)
from .intercept import intercept, InterceptRules, SiteRule, QuantizedFunction
from .legacy import cast_input_output_transform, configure_graph, node_dict
