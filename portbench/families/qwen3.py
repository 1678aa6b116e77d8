"""Qwen3 (``dmx_compressor_tpu_torch.models.qwen3``: the Llama classes with
per-head q / k RMSNorm): RMSNorm, RoPE, GQA, SiLU-gated MLP, no biases, the
head tied to the token embedding."""

from __future__ import annotations


def port_model(cfg: dict, device):
    from dmx_compressor_tpu_torch.models.qwen3 import Qwen3Config, Qwen3ForCausalLM

    pc = Qwen3Config(vocab_size=cfg["vocab_size"], hidden_size=cfg["hidden_size"],
                     intermediate_size=cfg["intermediate_size"],
                     num_hidden_layers=cfg["num_hidden_layers"],
                     num_attention_heads=cfg["num_attention_heads"],
                     num_key_value_heads=cfg["num_key_value_heads"], head_dim=cfg["head_dim"],
                     max_position_embeddings=cfg["max_position_embeddings"],
                     rms_norm_eps=cfg["rms_norm_eps"], rope_theta=cfg["rope_theta"],
                     tie_word_embeddings=cfg["tie_word_embeddings"])
    return Qwen3ForCausalLM(pc, device=device)


def top_spec(cfg):
    d = cfg["hidden_size"]
    return [("model.embed_tokens.weight", (cfg["vocab_size"], d), "w"),
            ("model.norm.weight", (d,), "scale")]


def layer_spec(cfg):
    d, m = cfg["hidden_size"], cfg["intermediate_size"]
    H, Hkv, D = heads(cfg)
    return [("self_attn.q_proj.weight", (H * D, d), "w"),
            ("self_attn.k_proj.weight", (Hkv * D, d), "w"),
            ("self_attn.v_proj.weight", (Hkv * D, d), "w"),
            ("self_attn.o_proj.weight", (d, H * D), "w"),
            ("self_attn.q_norm.weight", (D,), "scale"),
            ("self_attn.k_norm.weight", (D,), "scale"),
            ("mlp.gate_proj.weight", (m, d), "w"),
            ("mlp.up_proj.weight", (m, d), "w"),
            ("mlp.down_proj.weight", (d, m), "w"),
            ("input_layernorm.weight", (d,), "scale"),
            ("post_attention_layernorm.weight", (d,), "scale")]


def layer_prefix(i: int) -> str:
    return f"model.layers.{i}."


def heads(cfg):
    return cfg["num_attention_heads"], cfg["num_key_value_heads"], cfg["head_dim"]


def linears(cfg):
    """(K, N, launches a forward): merged q/k/v, o_proj, merged gate/up and
    down_proj a layer, then the tied head."""
    d, m, L = cfg["hidden_size"], cfg["intermediate_size"], cfg["num_hidden_layers"]
    H, Hkv, D = heads(cfg)
    return [(d, (H + 2 * Hkv) * D, L), (H * D, d, L), (d, 2 * m, L), (m, d, L),
            (d, cfg["vocab_size"], 1)]
