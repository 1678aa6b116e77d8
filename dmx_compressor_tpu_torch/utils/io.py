"""Config I/O: shorthand kwargs strings and yaml with custom tags.

Port of ``dmx_compressor_tpu/utils/io.py``.  Configs use the custom tags
``!Format``, ``!Sparseness``, ``!ApproximationFunction`` and ``!DmxModule``,
whose scalar payloads are the shorthand strings (a module type by its class
name), so a config file round-trips between the JAX package and the port:
each loads the other's file into its own types, and both dump the same
config to the same bytes.
"""

from __future__ import annotations

import ast
import hashlib
from typing import Any, Dict

import yaml


def compute_md5(file_name: str) -> str:
    hash_md5 = hashlib.md5()
    with open(file_name, "rb") as f:
        for chunk in iter(lambda: f.read(4096), b""):
            hash_md5.update(chunk)
    return hash_md5.hexdigest()


def string_to_kwargs(kwargs_string: str) -> Dict[str, Any]:
    """Parse ``"k1=v1, k2=v2"`` into a dict, each value a Python literal
    where it parses as one and the stripped string otherwise."""
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


def _format_constructor(loader, node):
    from ..numerics.format import Format

    return Format.from_shorthand(node.value)


def _sparseness_constructor(loader, node):
    from ..sparse import Sparseness

    return Sparseness.from_shorthand(node.value)


def _approximation_constructor(loader, node):
    from ..functional.approximate import ApproximationFunction

    return ApproximationFunction.from_shorthand(node.value)


def _dmx_module_constructor(loader, node):
    from .. import nn

    return getattr(nn, node.value)


def get_loader():
    class _Loader(yaml.SafeLoader):
        pass

    _Loader.add_constructor("!Format", _format_constructor)
    _Loader.add_constructor("!Sparseness", _sparseness_constructor)
    _Loader.add_constructor("!ApproximationFunction", _approximation_constructor)
    _Loader.add_constructor("!DmxModule", _dmx_module_constructor)
    return _Loader


def get_dumper():
    from ..functional.approximate import ApproximationFunction
    from ..numerics.format import Format
    from ..sparse import Sparseness

    class _Dumper(yaml.SafeDumper):
        def ignore_aliases(self, data):
            return True

    _Dumper.add_multi_representer(
        Format, lambda d, v: d.represent_scalar("!Format", repr(v))
    )
    _Dumper.add_multi_representer(
        Sparseness, lambda d, v: d.represent_scalar("!Sparseness", repr(v))
    )
    _Dumper.add_multi_representer(
        ApproximationFunction,
        lambda d, v: d.represent_scalar("!ApproximationFunction", repr(v)),
    )
    _Dumper.add_multi_representer(
        type, lambda d, v: d.represent_scalar("!DmxModule", v.__name__)
    )
    return _Dumper


def load_config_file(config_file: str):
    with open(config_file, "r") as f:
        return yaml.load(f, Loader=get_loader())


def load_config_str(config_str: str):
    return yaml.load(config_str, Loader=get_loader())


def save_config_file(config, config_file: str) -> None:
    with open(config_file, "w") as f:
        f.write(yaml.dump(config, Dumper=get_dumper()))


def dump_config_str(config) -> str:
    return yaml.dump(config, Dumper=get_dumper())
