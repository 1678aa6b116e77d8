"""What the decoder families share: the embedding lookup with ``jnp.take``'s
semantics, the attention modules' frozen routing check, greedy prefill /
decode (bench.py:252-302) over any model called as
``model(ids, caches=, position_offset=)``, and the loading of a raw JAX
model's weights (the Llama topology's; OPT's and GPT-2's, with biases)."""

from __future__ import annotations

from typing import Dict, List, Tuple

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
