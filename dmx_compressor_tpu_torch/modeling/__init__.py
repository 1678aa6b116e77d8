"""Model-level API."""

from .model import DmxConfigRule, DmxModel
