"""What the model families share: the embedding lookup with ``jnp.take``'s
semantics, the attention modules' frozen routing check, greedy prefill /
decode (bench.py:252-302) over any model called as
``model(ids, caches=, position_offset=)``, the encoder-decoder families'
greedy loop (T5's and Whisper's ``generate``), and the loading of a raw JAX
model's weights (the Llama topology's; OPT's and GPT-2's, with biases; T5's,
Whisper's and CLIP's)."""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from ..ops.flash_attention import sdpa_transparent


def take_rows(embed: nn.Module, idx: torch.Tensor) -> torch.Tensor:
    """``embed``'s rows at ``idx`` with ``jnp.take``'s default semantics: an
    index in [-n, n) wraps, any other gives a row of NaN."""
    n = embed.num_embeddings
    rows = embed(torch.remainder(idx, n))
    return rows.masked_fill(((idx < -n) | (idx >= n))[..., None], float("nan"))


class FrozenRouting:
    """Mixed into an attention module with an ``sdpa``: its routing's
    transparency check, asked on every call until :meth:`freeze_routing`
    (called by ``fuse_for_inference``, once the casts are fixed) stores
    it, so decode steps need not walk the casts."""

    sdpa_is_transparent = None

    def freeze_routing(self) -> None:
        self.sdpa_is_transparent = sdpa_transparent(self.sdpa)

    def _transparent(self) -> bool:
        if self.sdpa_is_transparent is None:
            return sdpa_transparent(self.sdpa)
        return self.sdpa_is_transparent


def greedy_token(logits_row: torch.Tensor) -> torch.Tensor:
    """Greedy choice with the JAX bench's tie rule: the LARGEST index among
    the maxima (``torch.argmax`` returns the first).  int32 [B]."""
    mx = torch.amax(logits_row, dim=-1, keepdim=True)
    idx = torch.arange(logits_row.shape[-1], device=logits_row.device)
    return torch.amax(torch.where(logits_row == mx, idx, -1), dim=-1).to(torch.int32)


@torch.no_grad()
def greedy_prefill(model: nn.Module, caches: List, ids: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Prefill at offset 0; returns (logits [B, T, V], first token [B])."""
    logits = model(ids, caches=caches, position_offset=0)
    return logits, greedy_token(logits[:, -1])


@torch.no_grad()
def greedy_decode(model: nn.Module, caches: List, tok: torch.Tensor, start: int,
                  n_steps: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``n_steps`` single-token steps from position ``start``; returns
    (tokens [B, n_steps], last-position logits [n_steps, B, V])."""
    toks, rows = [], []
    for i in range(n_steps):
        logits = model(tok[:, None], caches=caches, position_offset=start + i)
        rows.append(logits[:, -1])
        tok = greedy_token(logits[:, -1])
        toks.append(tok)
    return torch.stack(toks, dim=1), torch.stack(rows)


def load_jax_params(model: nn.Module, params: Dict[str, np.ndarray]) -> None:
    """Copy a raw JAX Llama-topology model's weights (Llama, Qwen3, Gemma)
    into the raw port model of its family, in place.

    ``params`` is the JAX model's flattened nnx state, dotted path -> numpy
    array (``model.layers.0.self_attn.q_proj.kernel`` ...).
    ``nnx.Linear.kernel`` [in, out] becomes ``weight`` [out, in];
    ``Embed.embedding`` and ``RMSNorm.weight`` are copied as they are, and
    ``rotary_emb.inv_freq`` into its buffer.  A tied head stays tied to
    ``embed_tokens`` (nnx may list the shared table under
    ``lm_head.embed_ref``).  Every parameter of the port must be covered,
    and every array must be used."""
    own = dict(model.named_parameters())
    buffers = dict(model.named_buffers())
    seen = set()
    with torch.no_grad():
        for path, arr in params.items():
            *mod, leaf = path.split(".")
            if mod == ["lm_head", "embed_ref"]:
                mod = ["model", "embed_tokens"]
            value = torch.tensor(np.asarray(arr, dtype=np.float32))
            if leaf == "inv_freq":
                name, target = path, buffers.get(path)
            else:
                if leaf == "kernel":
                    value = value.T
                elif leaf not in ("weight", "embedding"):
                    raise KeyError(f"{path}: unknown leaf {leaf!r}")
                name = ".".join(mod + ["weight"])
                target = own.get(name)
            if target is None:
                raise KeyError(f"{path}: no parameter {name} in the port model")
            if tuple(value.shape) != tuple(target.shape):
                raise ValueError(f"{path}: shape {tuple(value.shape)} != {tuple(target.shape)}")
            target.copy_(value)
            seen.add(name)
    missing = (set(own) | {b for b in buffers if b.endswith("inv_freq")}) - seen
    if missing:
        raise KeyError(f"parameters not in params: {sorted(missing)}")


def load_jax_biased_params(model: nn.Module, params: Dict[str, np.ndarray], embed: str) -> None:
    """Copy a raw JAX model with biased Linears and LayerNorms (OPT, GPT-2)
    into the raw port model of its family, in place.

    ``params`` is the JAX model's flattened nnx state, dotted path -> numpy
    array.  ``nnx.Linear.kernel`` [in, out] becomes ``weight`` [out, in],
    ``LayerNorm.scale`` and ``Embed.embedding`` become ``weight``, a
    ``bias`` stays ``bias``; the LM head stays tied to the embedding at the
    dotted path ``embed`` (nnx may list the shared table under the head's
    ``lm_head.embed_ref``).  Every parameter of the port must be covered,
    and every array must be used."""
    own = dict(model.named_parameters())
    seen = set()
    with torch.no_grad():
        for path, arr in params.items():
            *mod, leaf = path.split(".")
            if mod == ["lm_head", "embed_ref"]:
                mod = embed.split(".")
            name = ".".join(mod + ["bias" if leaf == "bias" else "weight"])
            if name not in own:
                raise KeyError(f"{path}: no parameter {name} in the port model")
            value = torch.tensor(np.asarray(arr, dtype=np.float32))
            if leaf == "kernel":
                value = value.T
            elif leaf not in ("bias", "scale", "embedding"):
                raise KeyError(f"{path}: unknown leaf {leaf!r}")
            if tuple(value.shape) != tuple(own[name].shape):
                raise ValueError(f"{path}: shape {tuple(value.shape)} != {tuple(own[name].shape)}")
            own[name].copy_(value)
            seen.add(name)
    missing = set(own) - seen
    if missing:
        raise KeyError(f"parameters not in params: {sorted(missing)}")


@torch.no_grad()
def seq2seq_greedy(model: nn.Module, caches: List, enc: torch.Tensor, ids: torch.Tensor,
                   n_new: int, enc_mask: Optional[torch.Tensor] = None,
                   eos_token_id: Optional[int] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """An encoder-decoder model's greedy loop over its encoder output
    ``enc``: the start ids [B, T0] prefilled into ``caches`` at offset 0,
    then ``n_new - 1`` single-token steps, each through ``model.decode(ids,
    enc, caches=, position_offset=[, enc_mask=])``.  The choice is
    ``torch.argmax`` (the first index among maxima: ``jnp.argmax`` in the
    JAX package's ``generate``); after ``eos_token_id`` a row repeats it.
    Returns (tokens [B, n_new] int32, each step's last-position logits
    [n_new, B, V])."""
    kw = {} if enc_mask is None else {"enc_mask": enc_mask}
    T0 = ids.shape[1]
    logits = model.decode(ids, enc, caches=caches, position_offset=0, **kw)
    tok = torch.argmax(logits[:, -1], dim=-1)
    done = None if eos_token_id is None else tok == eos_token_id
    toks, rows = [tok], [logits[:, -1]]
    for i in range(n_new - 1):
        logits = model.decode(tok[:, None], enc, caches=caches, position_offset=T0 + i, **kw)
        tok = torch.argmax(logits[:, -1], dim=-1)
        if done is not None:
            tok = torch.where(done, eos_token_id, tok)
            done = done | (tok == eos_token_id)
        toks.append(tok)
        rows.append(logits[:, -1])
    return torch.stack(toks, dim=1).to(torch.int32), torch.stack(rows)


@torch.no_grad()
def seq2seq_generate(model: nn.Module, encoder_input, decoder_start_ids, max_new_tokens: int,
                     eos_token_id: Optional[int] = None,
                     quantized_cache: bool = False) -> torch.Tensor:
    """Greedy seq2seq generation, the JAX package's ``generate`` of T5 and
    Whisper: encode once, prefill the start ids [B, T0] into fresh caches
    of T0 + ``max_new_tokens`` slots (int8 with ``quantized_cache``), then
    decode greedily (:func:`seq2seq_greedy`).  Runs where the model's
    parameters are.  Returns [B, T0 + max_new_tokens] int32 token ids."""
    dev = next(model.parameters()).device
    x = torch.as_tensor(np.asarray(encoder_input) if not torch.is_tensor(encoder_input)
                        else encoder_input).to(dev)
    ids = torch.as_tensor(np.asarray(decoder_start_ids, dtype=np.int32)
                          if not torch.is_tensor(decoder_start_ids)
                          else decoder_start_ids).to(device=dev, dtype=torch.int32)
    B, T0 = ids.shape
    caches = model.init_cache(B, T0 + max_new_tokens, quantized=quantized_cache, device=dev)
    toks, _ = seq2seq_greedy(model, caches, model.encode(x), ids, max_new_tokens,
                             eos_token_id=eos_token_id)
    return torch.cat([ids, toks], dim=1)


def load_jax_seq2seq_params(model: nn.Module, params: Dict[str, np.ndarray],
                            aliases: Dict[str, str], buffers: Tuple[str, ...] = (),
                            as_is: Tuple[str, ...] = ()) -> None:
    """Copy a raw JAX encoder-decoder model's weights (T5, Whisper; and
    CLIP's two towers) into the raw port model of its family, in place.

    ``params`` is the JAX model's flattened nnx state, dotted path -> numpy
    array.  ``nnx.Linear.kernel`` [in, out] becomes ``weight`` [out, in];
    ``LayerNorm.scale``, ``Embed.embedding`` and a Dmx module's ``weight``
    become ``weight``, a ``bias`` stays ``bias``.  ``aliases`` maps the
    module path under which nnx lists a shared table to the port module
    that owns its Parameter (written once, read by every site); the paths
    in ``buffers`` (fixed tables) are copied into the port buffer
    ``<path>.weight``, those in ``as_is`` (a bare ``nnx.Param``) into the
    port Parameter of the same path; a Dmx module's cast state is not a
    weight and is skipped.  Every parameter and listed buffer of the port must be
    covered, and every weight array used."""
    own = dict(model.named_parameters())  # a shared Parameter once
    bufs = {f"{b}.weight": dict(model.named_buffers())[f"{b}.weight"] for b in buffers}
    seen = set()
    with torch.no_grad():
        for path, arr in params.items():
            *mod, leaf = path.split(".")
            if any(p.endswith(("_cast", "_casts")) or p in ("smoothquant", "weight_sparsifier")
                   for p in mod):
                continue
            value = torch.tensor(np.asarray(arr, dtype=np.float32))
            if path in buffers:
                name, target = f"{path}.weight", bufs[f"{path}.weight"]
            elif path in as_is:
                name, target = path, own.get(path)
            else:
                prefix = ".".join(mod)
                mod = aliases.get(prefix, prefix).split(".")
                if leaf == "kernel":
                    value = value.T
                elif leaf not in ("weight", "bias", "scale", "embedding"):
                    raise KeyError(f"{path}: unknown leaf {leaf!r}")
                name = ".".join(mod + ["bias" if leaf == "bias" else "weight"])
                target = own.get(name)
            if target is None:
                raise KeyError(f"{path}: no parameter {name} in the port model")
            if tuple(value.shape) != tuple(target.shape):
                raise ValueError(f"{path}: shape {tuple(value.shape)} != {tuple(target.shape)}")
            target.copy_(value)
            seen.add(name)
    missing = (set(own) | set(bufs)) - seen
    if missing:
        raise KeyError(f"parameters not in params: {sorted(missing)}")
