"""Module-tree substitution: the graph-transform layer.

Port of ``dmx_compressor_tpu/transform/substitute.py``: walk the
``torch.nn.Module`` tree and replace raw modules with Dmx-aware ones in
place, driven by the same op-substitution table.  Parameters are shared by
construction (``from_raw``), and existing Dmx modules are left alone, so the
pass is idempotent.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterator, Optional, Tuple, Type

from torch import nn

from .. import rawnn
from ..nn import modules as dmxnn
from ..nn.core import DmxModule

# torch standard modules -> Dmx modules (JAX's rows for nnx's; torch's
# transposed conv, like nnx's, maps to nothing)
DMX_AWARE_MAPPING: Dict[Type, Callable] = {
    nn.Linear: dmxnn.Linear.from_raw,
    nn.Conv1d: dmxnn.Conv1d.from_raw,
    nn.Conv2d: dmxnn.Conv2d.from_raw,
    nn.Embedding: dmxnn.Embedding.from_raw,
    nn.LayerNorm: dmxnn.LayerNorm.from_raw,
    nn.RMSNorm: dmxnn.RMSNorm.from_raw,
    nn.BatchNorm2d: dmxnn.BatchNorm2d.from_raw,
    nn.GroupNorm: dmxnn.GroupNorm.from_raw,
    nn.Dropout: dmxnn.Dropout.from_raw,
}

# rawnn functional-op wrappers -> Dmx modules
RAW_OP_MAPPING: Dict[Type, Callable] = {
    rawnn.ResAdd: dmxnn.ResAdd.from_raw,
    rawnn.Mul: dmxnn.Mul.from_raw,
    rawnn.MatMul: dmxnn.ActActMatMul.from_raw,
    rawnn.TiedLinear: dmxnn.Linear.from_tied,
    rawnn.BAddBMM: dmxnn.BAddBMM.from_raw,
    rawnn.Exp: dmxnn.Exp.from_raw,
    rawnn.Softmax: dmxnn.Softmax.from_raw,
    rawnn.ReLU: dmxnn.ReLU.from_raw,
    rawnn.ReLU6: dmxnn.ReLU6.from_raw,
    rawnn.SiLU: dmxnn.SiLU.from_raw,
    rawnn.Tanh: dmxnn.Tanh.from_raw,
    rawnn.GELU: dmxnn.GELU.from_raw,
    rawnn.NewGELU: dmxnn.NewGELU.from_raw,
    rawnn.FastGELU: dmxnn.FastGELU.from_raw,
    rawnn.QuickGELU: dmxnn.QuickGELU.from_raw,
    rawnn.BloomGELU: dmxnn.BloomGELU.from_raw,
    rawnn.Dropout: dmxnn.Dropout.from_raw,
    rawnn.ScaledDotProductAttention: dmxnn.ScaledDotProductAttention.from_raw,
    rawnn.ApplyRotaryPosEmb: dmxnn.ApplyRotaryPosEmb.from_raw,
    rawnn.RotaryEmbedding: dmxnn.RotaryEmbedding.from_raw,
    rawnn.RMSNorm: dmxnn.RMSNorm.from_raw,
    rawnn.GemmaRMSNorm: dmxnn.GemmaRMSNorm.from_raw,
    rawnn.ClippedGELU: dmxnn.ClippedGELU.from_raw,
}


def default_mapping() -> Dict[Type, Callable]:
    mapping = dict(DMX_AWARE_MAPPING)
    mapping.update(RAW_OP_MAPPING)
    return mapping


def substitute_transform(
    model: nn.Module,
    additional_mappings: Optional[Dict[Type, Callable]] = None,
    filter_fn: Optional[Callable[[str], bool]] = None,
) -> nn.Module:
    """Substitute raw modules with Dmx-aware ones, in place.

    ``filter_fn`` receives the dotted path and may veto substitution.  When
    the root itself is mapped, the new module is returned.
    """
    mapping = default_mapping()
    if additional_mappings:
        mapping.update(additional_mappings)

    def convert(obj, path: str):
        fn = mapping.get(type(obj))
        if fn is not None and (filter_fn is None or filter_fn(path)):
            return fn(obj)
        return None

    root_sub = convert(model, "")
    if root_sub is not None:
        return root_sub

    def walk(parent: nn.Module, prefix: str):
        for name, child in list(parent.named_children()):
            path = f"{prefix}.{name}" if prefix else name
            if isinstance(child, DmxModule):
                continue  # idempotent: keep existing Dmx modules and their state
            sub = convert(child, path)
            if sub is not None:
                setattr(parent, name, sub)
            else:
                walk(child, path)

    walk(model, "")
    return model


def named_dmx_modules(model: nn.Module) -> Iterator[Tuple[str, DmxModule]]:
    """(dotted_path, module) over all DmxModules, compound children included."""
    for name, m in model.named_modules():
        if isinstance(m, DmxModule) and name:
            yield name, m
