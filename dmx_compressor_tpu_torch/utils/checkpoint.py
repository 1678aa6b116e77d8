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

A model sharded by ``parallel.shard_state`` (it carries ``tp_placement``)
takes the sharded half: ``model/`` is a ``torch.distributed.checkpoint``
directory that every rank writes its own shards into (``dcp.save``; each
sharded tensor wrapped as a ``DTensor`` on the model's mesh for the save
only, a replicated one written once; a sharded tensor's global form is the
ranks' local rows end to end, so a merged q/k/v whose KV head every rank
holds beside its own query heads saves that head on each), ``meta.json``
also records the placement, and an optimizer's state is saved per rank
(``opt_rank<r>.pt``).
It restores (``dcp.load``) into a model sharded the same way, each rank
reading its shards; another placement raises.  Every rank of the mesh
calls both.  The sharded half replaces orbax's per-shard writes; the
unsharded half (``torch.save``) is as above.
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


def _placement(model) -> Optional[Dict[str, tuple]]:
    return getattr(_module_of(model), "tp_placement", None)


def _dtensors(model, flat: Dict[str, torch.Tensor]):
    """The sharded half's state dict: each tensor on the mesh's device type
    (a CPU copy for a gloo mesh over the card), a sharded one as a DTensor
    of its shards; plus the staged copies that back them."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    module = _module_of(model)
    mesh, placement = module.tp_mesh, module.tp_placement
    names = mesh.mesh_dim_names
    out, staged = {}, {}
    for k, v in flat.items():
        local = v.detach()
        if local.device.type != mesh.device_type:
            local = local.to(mesh.device_type)
        staged[k] = local
        spec = tuple(placement.get(k, ()))
        if any(a is not None for a in spec):
            out[k] = DTensor.from_local(
                local, mesh, [Shard(spec.index(n)) if n in spec else Replicate() for n in names],
                run_check=False)
        else:
            out[k] = local
    return out, staged


def _meta(model, step: int) -> dict:
    meta = {"step": int(step), "dmx_config_yaml": _config_yaml(model)}
    placement = _placement(model)
    if placement is not None:
        meta["placement"] = {k: list(v) for k, v in placement.items()}
    return meta


def _opt_state(optimizer_state):
    return (optimizer_state.state_dict() if isinstance(optimizer_state, torch.optim.Optimizer)
            else optimizer_state)


def _save_sharded(path: str, model, optimizer_state, step: int, force: bool) -> str:
    import torch.distributed as dist
    import torch.distributed.checkpoint as dcp

    rank = dist.get_rank()
    if rank == 0:
        if os.path.exists(path) and not force:
            raise FileExistsError(f"checkpoint {path} exists (force=False)")
        shutil.rmtree(path, ignore_errors=True)
        os.makedirs(path)
    dist.barrier()
    sd, _ = _dtensors(model, _flat_tensors(model))
    dcp.save(sd, checkpoint_id=os.path.join(path, "model"))
    if optimizer_state is not None:
        torch.save(_opt_state(optimizer_state), os.path.join(path, f"opt_rank{rank}.pt"))
    if rank == 0:
        with open(os.path.join(path, "meta.json"), "w") as f:
            json.dump(_meta(model, step), f)
    dist.barrier()
    return path


def save_checkpoint(path: str, model, *, optimizer_state: Any = None, step: int = 0,
                    force: bool = True) -> str:
    """Write one checkpoint directory at ``path`` (replaced where ``force``,
    else an existing one raises).  ``model`` is a torch module or a
    ``DmxModel``; ``optimizer_state`` a ``torch.optim.Optimizer`` or its
    ``state_dict()``.  A sharded model takes the sharded half (every rank
    calls it).  Returns the absolute path."""
    path = os.path.abspath(os.fspath(path))
    if _placement(model) is not None:
        return _save_sharded(path, model, optimizer_state, step, force)
    if os.path.exists(path) and not force:
        raise FileExistsError(f"checkpoint {path} exists (force=False)")
    tmp = f"{path}.tmp"
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    torch.save({k: v.detach().cpu() for k, v in _flat_tensors(model).items()},
               os.path.join(tmp, "model.pt"))
    if optimizer_state is not None:
        torch.save(_opt_state(optimizer_state), os.path.join(tmp, "opt.pt"))
    with open(os.path.join(tmp, "meta.json"), "w") as f:
        json.dump(_meta(model, step), f)
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
    if _placement(model) is not None:
        return _restore_sharded(path, model, optimizer_state)
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


def _restore_sharded(path: str, model, optimizer_state) -> Tuple[int, Any]:
    import torch.distributed as dist
    import torch.distributed.checkpoint as dcp

    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    placement = {k: list(v) for k, v in _placement(model).items()}
    if meta.get("placement") != placement:
        raise ValueError(f"checkpoint {path} was not saved from a model sharded as this one is")
    live = _flat_tensors(model)
    sd, staged = _dtensors(model, live)
    dcp.load(sd, checkpoint_id=os.path.join(path, "model"))
    with torch.no_grad():
        for k, v in live.items():
            if staged[k].data_ptr() != v.data_ptr():
                v.copy_(staged[k])
    opt = None
    if optimizer_state is not None:
        opt = torch.load(os.path.join(path, f"opt_rank{dist.get_rank()}.pt"),
                         map_location="cpu", weights_only=True)
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
