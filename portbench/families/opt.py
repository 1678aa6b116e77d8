"""OPT (``dmx_compressor_tpu_torch.models.opt``): pre-LN, learned positions,
ReLU MLP, biased linears, the head tied to the token embedding."""

from __future__ import annotations


def port_model(cfg: dict, device):
    from dmx_compressor_tpu_torch.models.opt import OPTConfig, OPTForCausalLM

    pc = OPTConfig(vocab_size=cfg["vocab_size"], hidden_size=cfg["hidden_size"],
                   ffn_dim=cfg["ffn_dim"], num_hidden_layers=cfg["num_hidden_layers"],
                   num_attention_heads=cfg["num_attention_heads"],
                   max_position_embeddings=cfg["max_position_embeddings"],
                   do_layer_norm_before=cfg["do_layer_norm_before"])
    return OPTForCausalLM(pc, device=device)


def top_spec(cfg):
    d = cfg["hidden_size"]
    return [("model.decoder.embed_tokens.weight", (cfg["vocab_size"], d), "w"),
            ("model.decoder.embed_positions.weight", (cfg["max_position_embeddings"] + 2, d), "w"),
            ("model.decoder.final_layer_norm.weight", (d,), "scale"),
            ("model.decoder.final_layer_norm.bias", (d,), "shift")]


def layer_spec(cfg):
    d, f = cfg["hidden_size"], cfg["ffn_dim"]
    spec = []
    for p in ("q_proj", "k_proj", "v_proj", "out_proj"):
        spec += [(f"self_attn.{p}.weight", (d, d), "w"), (f"self_attn.{p}.bias", (d,), "w")]
    spec += [("fc1.weight", (f, d), "w"), ("fc1.bias", (f,), "w"),
             ("fc2.weight", (d, f), "w"), ("fc2.bias", (d,), "w")]
    for n in ("self_attn_layer_norm", "final_layer_norm"):
        spec += [(f"{n}.weight", (d,), "scale"), (f"{n}.bias", (d,), "shift")]
    return spec


def layer_prefix(i: int) -> str:
    return f"model.decoder.layers.{i}."


def heads(cfg):
    """(query heads, KV heads, head_dim)."""
    h = cfg["num_attention_heads"]
    return h, h, cfg["hidden_size"] // h


def linears(cfg):
    """(K, N, launches a forward) of the packed linears as the port runs them:
    merged q/k/v, out_proj, fc1, fc2 a layer, then the tied head."""
    d, f, L = cfg["hidden_size"], cfg["ffn_dim"], cfg["num_hidden_layers"]
    return [(d, 3 * d, L), (d, d, L), (d, f, L), (f, d, L), (d, cfg["vocab_size"], 1)]
