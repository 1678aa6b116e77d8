"""Split-KV decode preparation: the base segment's BASIC casts, made once.

Port of ``decoder_layers`` and ``prepare_split_decode`` of
``dmx_compressor_tpu/ops/split_decode.py`` (the D-minor cache layout only).
With a prefill/decode split cache (ops/kv_cache.py ``SplitKVCache``) the
prefill segment does not change while decoding, so its BASIC k and v casts
are computed once, between prefill and decode (two T2 launches per layer on
the card), and a decode step casts only the tail.
"""

from __future__ import annotations

from typing import List, Optional

from .kv_cache import SplitKVCache

# attribute chains to the decoder layer stack, by family convention
_LAYER_PATHS = (
    ("model", "decoder", "layers"),  # OPT (HF layout)
    ("model", "layers"),
    ("transformer", "h"),
    ("decoder", "layers"),
    ("layers",),
)


def _attention_of(layer) -> Optional[object]:
    attn = getattr(layer, "self_attn", None) or getattr(layer, "attn", None)
    if attn is not None and hasattr(attn, "sdpa") and hasattr(attn, "head_dim"):
        return attn
    return None


def decoder_layers(model) -> List:
    """The model's decoder layers in order, or [] if the model follows none
    of the known layouts."""
    for path in _LAYER_PATHS:
        obj = model
        for attr in path:
            obj = getattr(obj, attr, None)
            if obj is None:
                break
        if obj is not None and hasattr(obj, "__len__"):
            layers = list(obj)
            if layers and all(_attention_of(layer) is not None for layer in layers):
                return layers
    return []


def prepare_split_decode(model, caches) -> None:
    """Install each split cache's base-segment BASIC casts after prefill.
    A no-op for other caches, for non-BASIC attention and for unknown
    model layouts."""
    from .basic_attention import basic_sdpa_shape, cast_k_rows, cast_v_sblocks

    for layer, cache in zip(decoder_layers(model), caches):
        if not isinstance(cache, SplitKVCache):
            continue
        attn = _attention_of(layer)
        p = basic_sdpa_shape(attn.sdpa, attn.head_dim, cache.tail_len)
        if p is None or cache.base_len % p.block != 0:
            continue
        cache.set_base_cast(cast_k_rows(cache.base_k, p.wl, p.block),
                            cast_v_sblocks(cache.base_v, p.block, p.wl), key=(p.wl, p.block))
