"""Qwen3's forward in plain PyTorch (HF ``modeling_qwen3``): RMSNorm, q / k
RMSNorm over the head dim before RoPE, GQA, SiLU-gated MLP, tied head.
Modes: ``weights`` (BFP16_64 weights, float activations)."""

from __future__ import annotations

import torch

from .. import weights as W
from ..families import qwen3 as fam
from .common import causal_attention, quantized_weight


def _rms(x, w, eps, dtype):
    xf = x.to(torch.float32)
    y = xf * torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    return (y * w).to(dtype)


def _rotate_half(x):
    h = x.shape[-1] // 2
    return torch.cat([-x[..., h:], x[..., :h]], dim=-1)


def _rope(cfg, T, device):
    D = cfg["head_dim"]
    i = torch.arange(0, D, 2, dtype=torch.float32, device=device)
    inv = 1.0 / (cfg["rope_theta"] ** (i / D))
    f = torch.arange(T, dtype=torch.float32, device=device)[:, None] * inv[None, :]
    emb = torch.cat([f, f], dim=-1)
    return torch.cos(emb), torch.sin(emb)


@torch.no_grad()
def score_logits(cfg, mode, seed, rows, device, dtype=torch.float32, on_logits=None):
    """Logits of each row of ids [T] (no cache, as scoring runs), handed to
    ``on_logits(i, logits [T, V])`` one row at a time; layer by layer over
    all rows, each layer's weights made again from the seed."""
    if mode != "weights":
        raise ValueError(f"qwen3 reference: mode {mode!r} not written")
    H, Hkv, D = fam.heads(cfg)
    eps, m = cfg["rms_norm_eps"], cfg["intermediate_size"]
    top = W.top(fam, cfg, seed, device)
    emb = top["model.embed_tokens.weight"]
    xs = [emb[r.long()].to(dtype) for r in rows]
    for i in range(cfg["num_hidden_layers"]):
        p = W.layer(fam, cfg, seed, i, device)
        wq, wk, wv, wo, wg, wu, wd = (quantized_weight(p[f"{n}.weight"], mode, dtype) for n in (
            "self_attn.q_proj", "self_attn.k_proj", "self_attn.v_proj", "self_attn.o_proj",
            "mlp.gate_proj", "mlp.up_proj", "mlp.down_proj"))
        for j, x in enumerate(xs):
            T = x.shape[0]
            cos, sin = _rope(cfg, T, device)
            a = _rms(x, p["input_layernorm.weight"], eps, dtype)
            q = _rms((a @ wq.T).view(T, H, D), p["self_attn.q_norm.weight"], eps, dtype)
            k = _rms((a @ wk.T).view(T, Hkv, D), p["self_attn.k_norm.weight"], eps, dtype)
            v = (a @ wv.T).view(T, Hkv, D)
            q, k, v = q.transpose(0, 1), k.transpose(0, 1), v.transpose(0, 1)
            q = (q * cos + _rotate_half(q) * sin).to(dtype)
            k = (k * cos + _rotate_half(k) * sin).to(dtype)
            k, v = (t.repeat_interleave(H // Hkv, dim=0) for t in (k, v))
            o = causal_attention(q, k, v, D ** -0.5, dtype).transpose(0, 1).reshape(T, H * D)
            x = x + o @ wo.T
            a = _rms(x, p["post_attention_layernorm.weight"], eps, dtype)
            g, u = a @ wg.T, a @ wu.T
            xs[j] = x + (torch.nn.functional.silu(g) * u) @ wd.T
        del p
    head = quantized_weight(emb, mode, dtype)
    for j, x in enumerate(xs):
        on_logits(j, (_rms(x, top["model.norm.weight"], eps, dtype) @ head.T).float())
