"""Utilities: config I/O (``io``), trace-safe diagnostic state
(``tracing``), per-module monitoring (``monitor``), the per-mode
benchmark harness (``benchmark``), training checkpoints (``checkpoint``)
and model trees and braille masks (``visualization``)."""

from .checkpoint import (
    CheckpointManager,
    restore_checkpoint,
    restored_config,
    save_checkpoint,
)
from .io import (
    compute_md5,
    kwargs_to_string,
    load_config_file,
    save_config_file,
    string_to_kwargs,
)
