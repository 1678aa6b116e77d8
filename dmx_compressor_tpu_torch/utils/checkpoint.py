"""Training checkpoints: save / resume for quantized models.

Port of ``dmx_compressor_tpu/utils/checkpoint.py``, with ``torch.save`` /
``torch.load(weights_only=True)`` in place of orbax.  One checkpoint is a
directory holding three items:

- ``model.pt``: every parameter and buffer of the model by its state-dict
  name, quantizer state included (CastTo scale / zero point, observer
  statistics, SmoothQuant maxabs, sparsifier scores), as CPU tensors; the
  per-forward ``approximation_error`` and zero-size placeholders (an
  uncalibrated SmoothQuant's maxabs) are left out, so a model that has run
  a forward saves the same items as one that has not;
- ``opt.pt`` (optional): a ``torch.optim`` optimizer's ``state_dict()``, so
  QAT or fine-tuning resumes bit for bit;
- ``meta.json``: the step and the model's DmxConfig as yaml (None for a
  model without Dmx modules), so a restored model's formats, sparseness
  and approximations can be applied again without the code that set them.

Restoring writes into the live model's tensors in place, on their devices.
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Any, Dict, Optional, Tuple

import torch

__all__ = [
    "save_checkpoint",
    "restore_checkpoint",
    "restored_config",
    "CheckpointManager",
]

# per-forward diagnostics, recomputed every call: not checkpoint state
_TRANSIENT = ("approximation_error",)


def _module_of(model) -> torch.nn.Module:
    return model if isinstance(model, torch.nn.Module) else model.module


def _flat_tensors(model) -> Dict[str, torch.Tensor]:
    """The model's live parameters and buffers by state-dict name, without
    the transient diagnostics and zero-size placeholders."""
    flat = {}
    for k, v in _module_of(model).state_dict(keep_vars=True).items():
        if v is None or v.numel() == 0 or k.rsplit(".", 1)[-1] in _TRANSIENT:
            continue
        flat[k] = v
    return flat


def _config_yaml(model) -> Optional[str]:
    """The model's DmxConfig as yaml, or None where it has no Dmx module."""
    from ..modeling.model import DmxConfig
    from .io import dump_config_str

    cfg = DmxConfig.from_model(_module_of(model), freeze=False)
    if not cfg:
        return None
    return dump_config_str({k: dict(v) for k, v in cfg.items()})


def save_checkpoint(path: str, model, *, optimizer_state: Any = None, step: int = 0,
                    force: bool = True) -> str:
    """Write one checkpoint directory at ``path`` (replaced where ``force``,
    else an existing one raises).  ``model`` is a torch module or a
    ``DmxModel``; ``optimizer_state`` a ``torch.optim.Optimizer`` or its
    ``state_dict()``.  Returns the absolute path."""
    path = os.path.abspath(os.fspath(path))
    if os.path.exists(path) and not force:
        raise FileExistsError(f"checkpoint {path} exists (force=False)")
    tmp = f"{path}.tmp"
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    torch.save({k: v.detach().cpu() for k, v in _flat_tensors(model).items()},
               os.path.join(tmp, "model.pt"))
    if optimizer_state is not None:
        sd = (optimizer_state.state_dict() if isinstance(optimizer_state, torch.optim.Optimizer)
              else optimizer_state)
        torch.save(sd, os.path.join(tmp, "opt.pt"))
    with open(os.path.join(tmp, "meta.json"), "w") as f:
        json.dump({"step": int(step), "dmx_config_yaml": _config_yaml(model)}, f)
    shutil.rmtree(path, ignore_errors=True)
    os.replace(tmp, path)
    return path


def restore_checkpoint(path: str, model, *, optimizer_state: Any = None) -> Tuple[int, Any]:
    """Restore ``model`` in place from ``path``; returns (step, optimizer
    state).  Every saved item of the live model is copied into its tensor,
    on its device; a live item the checkpoint lacks, or one of another
    shape, raises.  Pass the live ``torch.optim.Optimizer`` as
    ``optimizer_state`` to resume it too (it is loaded in place and
    returned), or any value to get the saved ``state_dict()`` back."""
    path = os.path.abspath(os.fspath(path))
    saved = torch.load(os.path.join(path, "model.pt"), map_location="cpu", weights_only=True)
    live = _flat_tensors(model)
    missing = sorted(set(live) - set(saved))
    if missing:
        raise KeyError(f"checkpoint {path} lacks {missing}")
    with torch.no_grad():
        for k, v in live.items():
            if tuple(saved[k].shape) != tuple(v.shape):
                raise ValueError(f"checkpoint {path}: {k} has shape {tuple(saved[k].shape)}, "
                                 f"the model {tuple(v.shape)}")
            v.copy_(saved[k])
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    opt = None
    if optimizer_state is not None:
        opt = torch.load(os.path.join(path, "opt.pt"), map_location="cpu", weights_only=True)
        if isinstance(optimizer_state, torch.optim.Optimizer):
            optimizer_state.load_state_dict(opt)
            opt = optimizer_state
    return int(meta["step"]), opt


def restored_config(path: str):
    """The DmxConfig stored in the checkpoint (or None): apply it with
    ``DmxModel.configure``."""
    from ..modeling.model import DmxConfig
    from .io import load_config_str

    with open(os.path.join(os.path.abspath(os.fspath(path)), "meta.json")) as f:
        text = json.load(f).get("dmx_config_yaml")
    if not text:
        return None
    return DmxConfig(load_config_str(text))


class CheckpointManager:
    """Step-numbered training checkpoints with retention, on top of
    :func:`save_checkpoint`'s layout.

    >>> mgr = CheckpointManager(dir, max_to_keep=3)
    >>> mgr.save(step, model, optimizer_state=opt)
    >>> step, opt = mgr.restore_latest(model, optimizer_state=opt)
    """

    def __init__(self, directory: str, max_to_keep: int = 3):
        self.directory = os.path.abspath(os.fspath(directory))
        self.max_to_keep = max_to_keep
        os.makedirs(self.directory, exist_ok=True)

    def _step_dir(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{step:010d}")

    def steps(self):
        out = []
        for name in os.listdir(self.directory):
            if name.startswith("step_"):
                try:
                    out.append(int(name[5:]))
                except ValueError:
                    pass
        return sorted(out)

    def save(self, step: int, model, *, optimizer_state: Any = None) -> str:
        path = save_checkpoint(self._step_dir(step), model, optimizer_state=optimizer_state,
                               step=step)
        if self.max_to_keep:
            for s in self.steps()[: -self.max_to_keep]:
                shutil.rmtree(self._step_dir(s), ignore_errors=True)
        return path

    def restore_latest(self, model, *, optimizer_state: Any = None):
        steps = self.steps()
        if not steps:
            raise FileNotFoundError(f"no checkpoints under {self.directory}")
        return restore_checkpoint(self._step_dir(steps[-1]), model,
                                  optimizer_state=optimizer_state)
