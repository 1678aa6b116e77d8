"""Utilities: config I/O (``io``), trace-safe diagnostic state
(``tracing``), per-module monitoring (``monitor``) and the per-mode
benchmark harness (``benchmark``)."""

from .io import (
    compute_md5,
    kwargs_to_string,
    load_config_file,
    save_config_file,
    string_to_kwargs,
)
