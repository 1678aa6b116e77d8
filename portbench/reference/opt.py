"""OPT's forward in plain PyTorch (HF ``modeling_opt``, pre-LN): learned
positions at +2, LayerNorm, biased linears, ReLU MLP, tied head.

Modes: ``weights`` (BFP16_64 weights, float activations), scored without a
cache (``score_logits``)."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .. import weights as W
from ..families import opt as fam
from . import numerics as N
from .common import causal_attention, quantized_weight

EPS = 1e-5


def _linears(p, mode, dtype):
    """Each linear's (weight, bias) as served: BFP16_64 weights, and biases
    through their BFP32_1 cast, folded at packing."""
    out = {}
    for n in ("self_attn.out_proj", "fc1", "fc2"):
        out[n] = (quantized_weight(p[f"{n}.weight"], mode, dtype),
                  N.float_man(p[f"{n}.bias"]).to(dtype))
    # q, k and v as one product (the same values; one summation order fewer
    # for the reference to differ from the program by)
    qkv = [f"self_attn.{n}_proj" for n in "qkv"]
    out["qkv"] = (quantized_weight(torch.cat([p[f"{n}.weight"] for n in qkv]), mode, dtype),
                  N.float_man(torch.cat([p[f"{n}.bias"] for n in qkv])).to(dtype))
    return out


def _embed(top, ids, dtype):
    pos = torch.arange(ids.shape[-1], device=ids.device) + 2
    return (top["model.decoder.embed_tokens.weight"][ids.long()]
            + top["model.decoder.embed_positions.weight"][pos]).to(dtype)


def _layer(x, lin, p, H, D, dtype):
    """One decoder layer with packed weights over one window [T, d]."""
    T = x.shape[0]

    def f(n, a):
        w, b = lin[n]
        return a @ w.T + b

    a = F.layer_norm(x, (x.shape[-1],), p["self_attn_layer_norm.weight"].to(dtype),
                     p["self_attn_layer_norm.bias"].to(dtype), EPS)
    q, k, v = (t.view(T, H, D).transpose(0, 1) for t in f("qkv", a).chunk(3, dim=-1))
    o = causal_attention(q, k, v, D ** -0.5, dtype)
    x = x + f("self_attn.out_proj", o.transpose(0, 1).reshape(T, H * D))
    a = F.layer_norm(x, (x.shape[-1],), p["final_layer_norm.weight"].to(dtype),
                     p["final_layer_norm.bias"].to(dtype), EPS)
    return x + f("fc2", torch.relu(f("fc1", a)))


def _head(top, x, dtype):
    h = F.layer_norm(x, (x.shape[-1],), top["model.decoder.final_layer_norm.weight"].to(dtype),
                     top["model.decoder.final_layer_norm.bias"].to(dtype), EPS)
    head = quantized_weight(top["model.decoder.embed_tokens.weight"], "weights", dtype)
    return (h @ head.T).float()


@torch.no_grad()
def score_logits(cfg, mode, seed, rows, device, dtype=torch.float32, on_logits=None):
    """Logits of each row of ids [T] through the forward without a cache
    (``weights``: packed weights, float activations), handed to
    ``on_logits(i, logits [T, V])``; layer by layer over all rows, each
    layer's weights made again from the seed."""
    if mode != "weights":
        raise ValueError(f"opt reference: scoring in mode {mode!r} not written")
    H, _, D = fam.heads(cfg)
    top = W.top(fam, cfg, seed, device)
    xs = [_embed(top, r, dtype) for r in rows]
    for i in range(cfg["num_hidden_layers"]):
        p = W.layer(fam, cfg, seed, i, device)
        lin = _linears(p, mode, dtype)
        for j, x in enumerate(xs):
            xs[j] = _layer(x, lin, p, H, D, dtype)
        del p, lin
    for j, x in enumerate(xs):
        on_logits(j, _head(top, x, dtype))
