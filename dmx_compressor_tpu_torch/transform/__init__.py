"""Module-tree transforms."""

from .substitute import named_dmx_modules, substitute_transform
