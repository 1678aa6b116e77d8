"""Rank bodies of tests/test_torch_parallel.py: one gloo world on the CPU.

Imports no JAX (each spawned rank re-imports this module; JAX with 8
virtual devices would cost seconds a rank).  :func:`run_world` spawns
``world`` ranks over a ``FileStore`` in a temporary directory; each rank
runs every case of :data:`CASES` named in the request, in order, and
writes its results with ``torch.save``; the parent reads them back.  The
parent computes JAX's values and the comparisons.
"""

from __future__ import annotations

import contextlib
import datetime
import logging
import os
import time

import numpy as np
import torch

COLLECTIVE_TIMEOUT = 120  # seconds a rank waits in a collective for its peers
WORLD_TIMEOUT = 600  # seconds a world may run (~65 s on its own)

# a world's own configs: widths whose shards keep whole BFP blocks at tp 2
# (128 wide, heads of 64, MLP 256); the vocabularies divide by 2
OPT_FIELDS = dict(vocab_size=256, hidden_size=128, ffn_dim=256, num_hidden_layers=2,
                  num_attention_heads=2, max_position_embeddings=64)
GPT2_FIELDS = dict(vocab_size=256, n_embd=128, n_layer=2, n_head=2, n_positions=64)
CLIP_VISION = dict(hidden_size=128, intermediate_size=256, num_hidden_layers=1,
                   num_attention_heads=2, image_size=32, patch_size=8)
CLIP_TEXT = dict(vocab_size=256, hidden_size=128, intermediate_size=256, num_hidden_layers=1,
                 num_attention_heads=2, max_position_embeddings=16)
CLIP_PROJ = 64
# the Llama topology at tp 2 (query heads of 32 or 64, 2 a rank): GQA with
# its KV heads sliced (Llama, Qwen3 2 of 4), MQA with its one KV head
# replicated (Gemma), and 3 KV heads under 6 query heads, which divide
# neither way (Mistral: its attention stays replicated, logged)
LLAMA_FIELDS = dict(vocab_size=256, hidden_size=128, intermediate_size=256, num_hidden_layers=1,
                    num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=64)
QWEN3_FIELDS = dict(LLAMA_FIELDS, head_dim=32, tie_word_embeddings=True)
GEMMA_FIELDS = dict(LLAMA_FIELDS, num_key_value_heads=1, head_dim=32)
MISTRAL_FIELDS = dict(LLAMA_FIELDS, hidden_size=192, num_attention_heads=6, num_key_value_heads=3,
                      sliding_window=4)
WHISPER_FIELDS = dict(vocab_size=256, num_mel_bins=16, d_model=128, encoder_layers=1,
                      decoder_layers=1, encoder_attention_heads=2, decoder_attention_heads=2,
                      encoder_ffn_dim=256, decoder_ffn_dim=256, max_source_positions=16,
                      max_target_positions=32)
T5_FIELDS = dict(vocab_size=256, d_model=64, d_kv=16, d_ff=128, num_layers=1,
                 num_decoder_layers=1, num_heads=4)
FIELDS = {"opt": OPT_FIELDS, "gpt2": GPT2_FIELDS, "llama": LLAMA_FIELDS, "qwen3": QWEN3_FIELDS,
          "gemma": GEMMA_FIELDS, "mistral": MISTRAL_FIELDS, "whisper": WHISPER_FIELDS,
          "t5": T5_FIELDS}
# test_serving.py's CFG and test_checkpoint.py's _tiny_opt
ENGINE_FIELDS = dict(vocab_size=97, hidden_size=64, ffn_dim=128, num_hidden_layers=2,
                     num_attention_heads=4, max_position_embeddings=64)
CKPT_FIELDS = dict(vocab_size=128, hidden_size=32, ffn_dim=64, num_hidden_layers=2,
                   num_attention_heads=2, max_position_embeddings=64)
# the engine over LlamaConfig.tiny() (4 query heads over 2 KV heads of 16:
# 2 over 1 a rank); the sharded checkpoint over Llamas in weights mode: at
# tp 2 an MQA one, whose merged q/k/v holds its query heads' shard beside
# its one KV head, replicated; at tp 4 8 query heads of 32 over 2 KV heads,
# which ranks 0-1 and 2-3 hold in pairs (widths that keep whole blocks at tp 4)
LLAMA_ENGINE_FIELDS = dict(vocab_size=512, hidden_size=64, intermediate_size=128,
                           num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
                           max_position_embeddings=64)
LLAMA_CKPT_FIELDS = dict(LLAMA_FIELDS, vocab_size=128, num_key_value_heads=1)
LLAMA_PAIRS_FIELDS = dict(LLAMA_FIELDS, vocab_size=128, hidden_size=256, num_attention_heads=8,
                          num_key_value_heads=2)
# case -> (config fields, mesh shape) of the Llama checkpoint round trips
LLAMA_CKPT_CASES = {"mqa_tp2": (LLAMA_CKPT_FIELDS, (2, 2)),
                    "gqa_tp4": (LLAMA_PAIRS_FIELDS, (1, 4))}
FAMILIES = ("opt", "gpt2", "clip", "llama", "qwen3", "gemma", "mistral", "whisper", "t5",
            "lenet")
MODES = ("basic", "weights")
# (query heads, KV heads) of a rank's attention modules at tp 2
HEADS = {"opt": [(1, 1)], "gpt2": [(1, 1)], "clip": [(1, 1)], "llama": [(2, 1)],
         "qwen3": [(2, 1)], "gemma": [(2, 1)], "mistral": [(6, 3)], "whisper": [(1, 1)],
         "t5": [(4, 4)], "lenet": []}


def _classes(family):
    from dmx_compressor_tpu_torch.models import gemma, gpt2, llama, mistral, opt, qwen3, t5, whisper

    return {"opt": (opt.OPTConfig, opt.OPTForCausalLM, opt.load_jax_params),
            "gpt2": (gpt2.GPT2Config, gpt2.GPT2LMHeadModel, gpt2.load_jax_params),
            "llama": (llama.LlamaConfig, llama.LlamaForCausalLM, llama.load_jax_params),
            "qwen3": (qwen3.Qwen3Config, qwen3.Qwen3ForCausalLM, qwen3.load_jax_params),
            "gemma": (gemma.GemmaConfig, gemma.GemmaForCausalLM, gemma.load_jax_params),
            "mistral": (mistral.MistralConfig, mistral.MistralForCausalLM,
                        mistral.load_jax_params),
            "whisper": (whisper.WhisperConfig, whisper.WhisperForConditionalGeneration,
                        whisper.load_jax_params),
            "t5": (t5.T5Config, t5.T5ForConditionalGeneration, t5.load_jax_params)}[family]


def port_config(family, **over):
    from dmx_compressor_tpu_torch.models.clip import CLIPConfig, CLIPTextConfig, CLIPVisionConfig

    if family == "clip":
        return CLIPConfig(vision=CLIPVisionConfig(**CLIP_VISION), text=CLIPTextConfig(**CLIP_TEXT),
                          projection_dim=CLIP_PROJ)
    return _classes(family)[0](**{**FIELDS[family], **over})


def port_model(family, params=None, cfg=None, seed=0):
    """The raw port model on the CPU, the JAX model's weights loaded where
    ``params`` (its flat nnx state) is given."""
    from dmx_compressor_tpu_torch.models import clip, lenet

    if family == "lenet":
        m, load = lenet.LeNet5(device="cpu", seed=seed), lenet.load_jax_params
    elif family == "clip":
        m, load = clip.CLIPModel(cfg or port_config(family), device="cpu", seed=seed), \
            clip.load_jax_params
    else:
        _, cls, load = _classes(family)
        m = cls(cfg or port_config(family), device="cpu", seed=seed)
    if params is not None:
        load(m, params)
    return m


def build_mode(model, mode):
    """BASIC (``to_basic_mode``: fake-quant, T2's plain casts), weights
    mode (``build_weights_mode``: packed BFP16_64, B1's plain version) or
    the baseline (``to_baseline_mode``); "raw" as it is."""
    from dmx_compressor_tpu_torch.modeling.model import DmxModel
    from dmx_compressor_tpu_torch.ops.compress import build_weights_mode, set_inference_mode

    if mode == "basic":
        set_inference_mode(False)
        DmxModel.from_raw(model).to_basic_mode()
    elif mode == "weights":
        build_weights_mode(model)
    elif mode == "baseline":
        set_inference_mode(False)
        DmxModel.from_raw(model).to_baseline_mode()
    return model


def model_args(family, inputs, mesh=None):
    """The forward's inputs as tensors: the whole batch, or this rank's dp
    share of it where ``mesh`` is given."""
    from dmx_compressor_tpu_torch.parallel import host_local_batch

    names = {"clip": ("ids", "px"), "whisper": ("feats", "ids"), "t5": ("enc_ids", "ids"),
             "lenet": ("px",)}.get(family, ("ids",))
    return tuple(torch.from_numpy(inputs[n]) if mesh is None else host_local_batch(inputs[n], mesh)
                 for n in names)


def forward(family, model, inputs):
    """The whole batch's logits (CLIP's per image)."""
    with torch.no_grad():
        out = model(*model_args(family, inputs))
    return out[0] if family == "clip" else out


# --------------------------------------------------------------------------
# the cases: each takes (ctx, request) and returns a picklable result
# --------------------------------------------------------------------------


def case_forwards(ctx, req):
    """Every family in BASIC and weights mode, sharded over dp 2 x tp 2:
    each rank's logits for its dp share of the batch (CLIP: the whole
    batch's logits, and its dp share's image and text features), beside
    the port's unsharded forward of the whole batch; the placement, the
    groups of keys that share a tensor, and what ``shard_state`` logged."""
    from dmx_compressor_tpu_torch.parallel import make_mesh, shard_state

    mesh = make_mesh((2, 2), ("dp", "tp"))
    out = {}
    for family in FAMILIES:
        inputs = req["inputs"][family]
        for mode in MODES:
            ref = build_mode(port_model(family, req["params"][family]), mode)
            full = forward(family, ref, inputs)
            m = build_mode(port_model(family, req["params"][family]), mode)
            ids = {}
            for k, v in m.state_dict(keep_vars=True).items():
                ids.setdefault(id(v), []).append(k)
            with _logged() as messages:
                placement = shard_state(m, mesh)
            with torch.no_grad():
                if family == "clip":
                    got = m(*model_args(family, inputs))[0]
                    px, ids_local = model_args(family, inputs, mesh)[::-1]
                    feats = (m.get_image_features(px), m.get_text_features(ids_local))
                    want = (ref.get_image_features(torch.from_numpy(inputs["px"])),
                            ref.get_text_features(torch.from_numpy(inputs["ids"])))
                    extra = dict(img_feat=feats[0], txt_feat=feats[1], img_full=want[0],
                                 txt_full=want[1])
                else:
                    got = m(*model_args(family, inputs, mesh))
                    extra = {}
            heads = sorted({(x.num_heads, getattr(x, "num_kv_heads", x.num_heads))
                            for x in m.modules() if hasattr(x, "num_heads")
                            and hasattr(x, "head_dim")})
            out[(family, mode)] = dict(
                local=got, full=full, coord=tuple(mesh.get_coordinate()), heads=heads,
                sharded=sorted(k for k, v in placement.items() if any(a is not None for a in v)),
                placement=placement, shared=[g for g in ids.values() if len(g) > 1],
                messages=messages, **extra)
    return out


def case_blocks(ctx, req):
    """Tensor-parallel shards keep whole BFP blocks: a packed [64, 512]
    weight sharded over tp 4 along its rows (mantissas and exponents
    together) and along its columns (128 a shard, two blocks of 64); each
    rank's shards unpack to its slice of the whole unpacked weight."""
    from dmx_compressor_tpu_torch.ops.bfp_pack import PackedBFP, bfp_pack, bfp_unpack
    from dmx_compressor_tpu_torch.parallel.mesh import NamedSharding, P, make_mesh

    mesh = make_mesh((1, 4), ("dp", "tp"))
    w = torch.from_numpy(req["w"])
    p = bfp_pack(w, 8, 64)
    whole = bfp_unpack(p)
    out = {}
    for spec in (P("tp", None), P(None, "tp")):
        sh = NamedSharding(mesh, spec)
        exp_spec = sh  # the exponents [64, 512 / 64] shard along the same dim
        part = PackedBFP(sh.local(p.mantissa), exp_spec.local(p.exponent), p.precision,
                         p.block_size)
        out[spec] = dict(local=bfp_unpack(part), want=sh.local(whole),
                         shape=tuple(part.mantissa.shape), exp_shape=tuple(part.exponent.shape))
    return out


def case_scale(ctx, req):
    """A calibrated per-out-channel weight-cast scale shards with its out dim
    (rules as JAX's test gives them)."""
    from dmx_compressor_tpu_torch.nn import modules as dmxnn
    from dmx_compressor_tpu_torch.numerics.observer import MinMaxObserver
    from dmx_compressor_tpu_torch.parallel.mesh import P, make_mesh, shard_state

    torch.manual_seed(0)
    lin = dmxnn.Linear(64, 32)
    lin.weight_cast.set_format("XP[8,0](CSN)")
    lin.weight_cast.enable_calibration(True, observer_cls=MinMaxObserver,
                                       qscheme_to_overload="per_channel_symmetric", ch_axis=0)
    lin(torch.ones(2, 64))
    lin.weight_cast.enable_calibration(False)
    full_scale = lin.weight_cast.scale.detach().clone()
    x = torch.from_numpy(req["x"])
    with torch.no_grad():
        want = lin(x)
    mesh = make_mesh((1, 4), ("dp", "tp"))
    placement = shard_state(lin, mesh, rules=((r"weight_cast\.scale$", P("tp")),
                                              (r"weight_cast\.zero_point$", P("tp")),
                                              (r"weight$", P("tp", None)), (r".*", P())))
    with torch.no_grad():
        got = lin(x)
    return dict(scale=lin.weight_cast.scale.detach().clone(), full_scale=full_scale,
                placement=placement, got=got, want=want, rank=ctx["rank"])


class _Records(logging.Handler):
    def __init__(self):
        super().__init__(logging.WARNING)
        self.messages = []

    def emit(self, record):
        self.messages.append(record.getMessage())


@contextlib.contextmanager
def _logged():
    """The warnings ``parallel.mesh`` logs within the block."""
    handler = _Records()
    logger = logging.getLogger("dmx_compressor_tpu_torch.parallel.mesh")
    logger.addHandler(handler)
    try:
        yield handler.messages
    finally:
        logger.removeHandler(handler)


def case_fallback(ctx, req):
    """``rules_for_model`` lists exact paths first; an indivisible dim logs
    "fallback" and stays replicated; a unit that cannot be cut exactly stays
    replicated, logged, and computes the unsharded values (tp 4): 3 query
    heads, an MLP whose row linear's 32 local inputs cut BFP blocks of 64,
    SmoothQuant state on a row linear, 3 KV heads under 12 query heads; a
    model sharded twice, and a rank outside the mesh, raise ValueError."""
    from torch import nn

    from dmx_compressor_tpu_torch.modeling.model import DmxModel
    from dmx_compressor_tpu_torch.parallel.mesh import (
        TRANSFORMER_RULES,
        P,
        make_mesh,
        rules_for_model,
        shard_state,
    )

    out = {}
    m = port_model("opt", cfg=port_config("opt", **FALLBACK_FIELDS["opt"]))
    DmxModel.from_raw(m)
    rules = rules_for_model(m)
    out["exact_first"] = [pat for pat, _ in rules[:-len(TRANSFORMER_RULES)]]
    mesh = make_mesh((1, 4), ("dp", "tp"))
    out["mesh_shape"] = dict(zip(mesh.mesh_dim_names, mesh.shape))
    bare = nn.ModuleDict({"q_proj": nn.Linear(16, 6)})  # 6 % 4 != 0
    with _logged() as messages:
        placement = shard_state(bare, mesh, rules=((r".*q_proj.*weight$", P("tp", None)),
                                                   (r".*", P())))
    out["messages"] = messages
    out["bare_placement"] = placement
    out["bare_shape"] = tuple(bare["q_proj"].weight.shape)
    ids = torch.from_numpy(fallback_ids(req["inputs"]))
    replicated = {}
    for case, (family, mode, unit) in FALLBACK_CASES.items():
        models = []
        for _ in range(2):
            m = port_model(family, req["fallback_params"][family],
                           port_config(family, **FALLBACK_FIELDS[family]))
            build_mode(m, mode)
            if case == "smoothquant":
                _calibrate_smoothquant(m, ids)
            models.append(m)
        with _logged() as messages:
            placement = shard_state(models[1], mesh)
        with torch.no_grad():
            got = models[1](ids)
            err = (got - models[0](ids)).abs().max().item()
        replicated[case] = dict(messages=messages, err=err, got=got,
                                unit={k: v for k, v in placement.items() if k.startswith(unit)},
                                sharded=sorted(k for k, v in placement.items() if any(v)))
    out["replicated"] = replicated
    errors = {}
    try:
        shard_state(models[1], mesh)
        errors["sharded"] = None
    except ValueError as e:
        errors["sharded"] = str(e)
    half = make_mesh((1, 2), ("dp", "tp"))
    try:
        shard_state(port_model("opt", cfg=port_config("opt", **FALLBACK_FIELDS["opt"])), half)
        errors["outside"] = None
    except ValueError as e:
        errors["outside"] = str(e)
    out["errors"] = errors
    return out


def fallback_ids(inputs):
    """The fallback cases' tokens (their vocabulary of 64)."""
    return inputs["opt"]["ids"] % 64


# case -> (family, mode, the unit's key prefix) of test_unshardable_raises_value_error
FALLBACK_CASES = {"heads": ("opt", "raw", "model.decoder.layers.0.self_attn."),
                  "block": ("opt", "weights", "model.decoder.layers.0.fc"),
                  "smoothquant": ("opt", "baseline", "model.decoder.layers.0.fc"),
                  "kv_heads": ("llama", "raw", "model.layers.0.self_attn.")}
FALLBACK_FIELDS = {
    # 3 heads of 32; the MLP's 32 local features at tp 4 (a block of 64 cut
    # where packed); the vocabulary of 64
    "opt": dict(vocab_size=64, hidden_size=96, ffn_dim=128, num_hidden_layers=1,
                num_attention_heads=3, max_position_embeddings=64),
    # 12 query heads of 8 over 3 KV heads
    "llama": dict(vocab_size=64, hidden_size=96, intermediate_size=128, num_hidden_layers=1,
                  num_attention_heads=12, num_key_value_heads=3, max_position_embeddings=64),
}


def _calibrate_smoothquant(model, ids):
    """SmoothQuant state (unfused) on each layer's fc2, from one forward."""
    from dmx_compressor_tpu_torch.advanced_recipe import DmxModuleSmoothQuantHyperparams

    hp = DmxModuleSmoothQuantHyperparams(migration_strength=0.5, fuse_to_weight=False)
    fc2 = [layer.fc2 for layer in model.model.decoder.layers]
    with contextlib.ExitStack() as stack:
        for lin in fc2:
            stack.enter_context(lin.calibrating_smoothquant(hp))
        with torch.no_grad():
            model(ids)


def _mlp_apply(p, h):
    return torch.tanh(h @ p["w"] + p["b"])


def case_pipeline(ctx, req):
    """``pipeline_forward`` at (pp 4), (dp 2, pp 2) and (pp 1) over JAX
    test's MLP layers; its gradients at pp 4; BASIC OPT decoder layers at
    pp 4."""
    from dmx_compressor_tpu_torch.parallel import make_mesh, pipeline_forward, stack_layer_states

    out = {}
    layers = [{k: torch.from_numpy(v) for k, v in lay.items()} for lay in req["mlp_layers"]]
    x = torch.from_numpy(req["mlp_x"])
    for shape, names, dp in (((4,), ("pp",), None), ((2, 2), ("dp", "pp"), "dp"),
                             ((1,), ("pp",), None)):
        mesh = make_mesh(shape, names)
        if mesh.get_coordinate() is None:
            continue
        y = pipeline_forward(stack_layer_states(layers), x, _mlp_apply, mesh,
                             num_microbatches=4, dp_axis=dp)
        out[shape] = y
    glayers = [{k: torch.from_numpy(v) for k, v in lay.items()} for lay in req["grad_layers"]]
    params = {k: v.clone().requires_grad_(True) for k, v in stack_layer_states(glayers).items()}
    mesh = make_mesh((4,), ("pp",))
    y = pipeline_forward(params, torch.from_numpy(req["grad_x"]), _mlp_apply, mesh,
                         num_microbatches=4)
    torch.sum(y ** 2).backward()
    out["grads"] = {k: v.grad for k, v in params.items()}
    out["quantized"] = _pipeline_quantized(req, mesh)
    return out


def _pipeline_quantized(req, mesh):
    from torch.func import functional_call

    from dmx_compressor_tpu_torch.modeling.model import DmxModel
    from dmx_compressor_tpu_torch.models.opt import OPTConfig, OPTDecoderLayer
    from dmx_compressor_tpu_torch.parallel import pipeline_forward, stack_layer_states

    cfg = OPTConfig.tiny()
    layers = []
    for flat in req["opt_layers"]:
        layer = OPTDecoderLayer(cfg, "cpu")
        load_layer(layer, flat)
        DmxModel.from_raw(layer).to_basic_mode()
        layers.append(layer)
    x = torch.from_numpy(req["opt_x"])
    with torch.no_grad():
        seq = x
        for layer in layers:
            seq = layer(seq)
        stacked = stack_layer_states([dict(layer.state_dict()) for layer in layers])
        y = pipeline_forward(stacked, x, lambda p, h: functional_call(layers[0], p, (h,)), mesh,
                             num_microbatches=4)
    return dict(y=y, seq=seq)


def load_layer(layer, flat):
    """A raw JAX OPT decoder layer's flat params into a raw port layer:
    kernels transposed, LayerNorm scales as weights."""
    own = dict(layer.named_parameters())
    with torch.no_grad():
        for path, arr in flat.items():
            *mod, leaf = path.split(".")
            v = torch.from_numpy(np.asarray(arr, np.float32))
            if leaf == "kernel":
                v = v.T
            name = ".".join(mod + ["bias" if leaf == "bias" else "weight"])
            own.pop(name).copy_(v)
    if own:
        raise KeyError(f"not loaded: {sorted(own)}")


def case_ring(ctx, req):
    """``ring_attention`` at (sp 4) and (dp 2, sp 2), causal and not; its
    gradients at sp 4, causal."""
    from dmx_compressor_tpu_torch.parallel import make_mesh, ring_attention

    q, k, v = (torch.from_numpy(a) for a in req["qkv"])
    out = {}
    for shape, names, dp in (((4,), ("sp",), None), ((2, 2), ("dp", "sp"), "dp")):
        mesh = make_mesh(shape, names)
        for causal in (False, True):
            out[(shape, causal)] = ring_attention(q, k, v, mesh, causal=causal, dp_axis=dp)
    gq, gk, gv = (torch.from_numpy(a).requires_grad_(True) for a in req["grad_qkv"])
    mesh = make_mesh((4,), ("sp",))
    torch.sum(ring_attention(gq, gk, gv, mesh, causal=True) ** 2).backward()
    out["grads"] = (gq.grad, gk.grad, gv.grad)
    return out


def case_engine(ctx, req):
    """The continuous-batching engine over OPT sharded tp 2 (each dp replica
    serves the same requests, in lockstep within its tp group), beside the
    unsharded engine."""
    from dmx_compressor_tpu_torch.models.opt import OPTConfig
    from dmx_compressor_tpu_torch.parallel import make_mesh, shard_state
    from dmx_compressor_tpu_torch.serving.engine import ContinuousBatchingEngine

    cfg = OPTConfig(**ENGINE_FIELDS)

    def serve(model):
        eng = ContinuousBatchingEngine(model, max_slots=2, max_len=48, prompt_buckets=(8, 16))
        rids = [eng.submit(p, max_new_tokens=4) for p in req["prompts"]]
        results = {r.request_id: r for r in eng.run(burst=2)}
        return [results[r].tokens for r in rids]

    plain = serve(port_model("opt", req["engine_params"], cfg))
    m = port_model("opt", req["engine_params"], cfg)
    shard_state(m, make_mesh((2, 2), ("dp", "tp")))
    return dict(sharded=serve(m), plain=plain,
                cache_heads=m.init_cache(1, 8, device="cpu")[0].k.shape[1])


def case_checkpoint(ctx, req):
    """A sharded save (each rank its shards, ``torch.distributed.checkpoint``)
    restored into a model sharded the same way: placement and values kept,
    logits bit for bit."""
    from dmx_compressor_tpu_torch.models.opt import OPTConfig
    from dmx_compressor_tpu_torch.parallel import make_mesh, shard_state
    from dmx_compressor_tpu_torch.utils.checkpoint import restore_checkpoint, save_checkpoint

    cfg = OPTConfig(**CKPT_FIELDS)
    mesh = make_mesh((2, 2), ("dp", "tp"))
    m = port_model("opt", req["ckpt_params"], cfg)
    placement = shard_state(m, mesh, warn_on_fallback=False)
    save_checkpoint(os.path.join(req["dir"], "ck"), m, step=1)
    m2 = port_model("opt", None, cfg, seed=1)
    placement2 = shard_state(m2, mesh, warn_on_fallback=False)
    step, _ = restore_checkpoint(os.path.join(req["dir"], "ck"), m2)
    ids = torch.from_numpy(req["ckpt_ids"])
    with torch.no_grad():
        a, b = m(ids), m2(ids)
    sd1, sd2 = m.state_dict(), m2.state_dict()
    return dict(step=step, same_placement=placement == placement2 == m2.tp_placement,
                values_equal=all(torch.equal(sd1[k], sd2[k]) for k in sd1),
                logits_equal=torch.equal(a, b), logits=b,
                n_sharded=sum(any(x is not None for x in v) for v in placement.values()))


def case_engine_llama(ctx, req):
    """The engine over a tiny Llama sharded tp 2 (2 query heads over 1 KV
    head a rank), beside the unsharded engine."""
    from dmx_compressor_tpu_torch.models.llama import LlamaConfig
    from dmx_compressor_tpu_torch.parallel import make_mesh, shard_state
    from dmx_compressor_tpu_torch.serving.engine import ContinuousBatchingEngine

    cfg = LlamaConfig(**LLAMA_ENGINE_FIELDS)

    def serve(model):
        eng = ContinuousBatchingEngine(model, max_slots=2, max_len=48, prompt_buckets=(8, 16))
        rids = [eng.submit(p, max_new_tokens=4) for p in req["prompts"]]
        results = {r.request_id: r for r in eng.run(burst=2)}
        return [results[r].tokens for r in rids]

    plain = serve(port_model("llama", req["llama_engine_params"], cfg))
    m = port_model("llama", req["llama_engine_params"], cfg)
    shard_state(m, make_mesh((2, 2), ("dp", "tp")))
    caches = m.init_cache(2, 8, device="cpu", per_row=True)
    return dict(sharded=serve(m), plain=plain, cache_heads=caches[0].k.shape[1])


def case_checkpoint_llama(ctx, req):
    """The sharded checkpoint of Llamas in weights mode (LLAMA_CKPT_CASES),
    each restored into a model of other weights sharded the same way: an
    MQA one at tp 2, and 2 KV heads held in pairs at tp 4."""
    from dmx_compressor_tpu_torch.models.llama import LlamaConfig
    from dmx_compressor_tpu_torch.ops.compress import build_weights_mode
    from dmx_compressor_tpu_torch.parallel import make_mesh, shard_state
    from dmx_compressor_tpu_torch.utils.checkpoint import restore_checkpoint, save_checkpoint

    ids = torch.from_numpy(req["ckpt_ids"])
    out = {}
    for case, (fields, shape) in LLAMA_CKPT_CASES.items():
        cfg = LlamaConfig(**fields)
        mesh = make_mesh(shape, ("dp", "tp"))
        path = os.path.join(req["dir"], f"ck_{case}")
        models, placements = [], []
        for seed in (0, 1):
            m = port_model("llama", cfg=cfg, seed=seed)
            build_weights_mode(m)
            placements.append(shard_state(m, mesh))
            models.append(m)
        save_checkpoint(path, models[0], step=2)
        step, _ = restore_checkpoint(path, models[1])
        with torch.no_grad():
            a, b = models[0](ids), models[1](ids)
        sd1, sd2 = models[0].state_dict(), models[1].state_dict()
        attn = models[0].model.layers[0].self_attn
        out[case] = dict(
            step=step, same_placement=placements[0] == placements[1] == models[1].tp_placement,
            values_equal=all(torch.equal(sd1[k], sd2[k]) for k in sd1),
            logits_equal=torch.equal(a, b), logits=b,
            qkv_shape=tuple(attn.qkv_merged.weight_mantissa.shape),
            qkv_spec=placements[0]["model.layers.0.self_attn.qkv_merged.weight_mantissa"],
            heads=(attn.num_heads, attn.num_kv_heads))
    return out


def case_placement(ctx, req):
    """The placement where a part's blocks meet tp otherwise than in equal
    shares.  At tp 4, 8 query heads over 2 KV heads (raw): a rank keeps KV
    head ``r // 2``, so the ranks' KV rows differ and k_proj is sharded;
    the logits equal the unsharded model's.  At tp 1 every column-parallel
    tensor keeps the spec JAX's rules give it: OPT's q_proj, and an MQA
    Llama's k_proj (raw) and merged q/k/v (weights mode)."""
    from dmx_compressor_tpu_torch.models.llama import LlamaConfig
    from dmx_compressor_tpu_torch.parallel import make_mesh, shard_state

    ids = torch.from_numpy(req["ckpt_ids"])
    cfg = LlamaConfig(**LLAMA_PAIRS_FIELDS)
    ref, m = (port_model("llama", cfg=cfg) for _ in range(2))
    mesh = make_mesh((1, 4), ("dp", "tp"))
    placement = shard_state(m, mesh)
    r = mesh.get_coordinate()[1]
    attn = m.model.layers[0].self_attn
    k_full = ref.model.layers[0].self_attn.k_proj.weight
    D = attn.head_dim
    with torch.no_grad():
        err = (m(ids) - ref(ids)).abs().max().item()
    pairs = dict(k_spec=placement["model.layers.0.self_attn.k_proj.weight"],
                 q_spec=placement["model.layers.0.self_attn.q_proj.weight"],
                 heads=(attn.num_heads, attn.num_kv_heads),
                 k_rows=torch.equal(attn.k_proj.weight, k_full[r // 2 * D:(r // 2 + 1) * D]),
                 err=err)
    one = make_mesh((4, 1), ("dp", "tp"))
    opt = port_model("opt")
    mqa = LlamaConfig(**LLAMA_CKPT_FIELDS)
    raw, packed = port_model("llama", cfg=mqa), build_mode(port_model("llama", cfg=mqa), "weights")
    key = "model.layers.0.self_attn."
    tp1 = dict(q_spec=shard_state(opt, one)["model.decoder.layers.0.self_attn.q_proj.weight"],
               k_spec=shard_state(raw, one)[key + "k_proj.weight"],
               qkv_spec=shard_state(packed, one)[key + "qkv_merged.weight_mantissa"])
    return {"kv_pairs_tp4": pairs, "tp1": tp1}


def case_observer(ctx, req):
    """A calibrating cast on a rank-local activation (fc2's input, row
    parallel at tp 2) observes the whole activation: its MinMax statistics
    equal the unsharded model's."""
    from dmx_compressor_tpu_torch.modeling.model import DmxModel
    from dmx_compressor_tpu_torch.numerics.observer import MinMaxObserver
    from dmx_compressor_tpu_torch.parallel import make_mesh, shard_state

    ids = torch.from_numpy(req["inputs"]["opt"]["ids"])
    stats = []
    for shard in (False, True):
        m = port_model("opt", req["params"]["opt"])
        DmxModel.from_raw(m).to_baseline_mode()
        cast = m.model.decoder.layers[0].fc2.input_casts["input_cast"]
        cast.set_format("XP[8,0](CSN)")
        cast.enable_calibration(True, observer_cls=MinMaxObserver)
        if shard:
            shard_state(m, make_mesh((2, 2), ("dp", "tp")))
        with torch.no_grad():
            m(ids)
        stats.append((cast.observer.min_val.clone(), cast.observer.max_val.clone()))
    return stats


def case_row_grad(ctx, req):
    """A standalone row-parallel linear (tp 2) whose input arrives whole:
    its input's gradient is summed over the group and its weight shard's
    gradient is this rank's columns of the unsharded one, raw and Dmx."""
    from torch import nn

    from dmx_compressor_tpu_torch.nn.modules import Linear
    from dmx_compressor_tpu_torch.parallel import make_mesh, shard_state

    x0 = torch.from_numpy(req["x"][:, :16])
    g = torch.from_numpy(req["w"][:3, :8])
    out = {}
    for kind, cls in (("raw", nn.Linear), ("dmx", Linear)):
        grads = []
        for shard in (False, True):
            torch.manual_seed(0)
            m = nn.ModuleDict({"fc2": cls(16, 8)})
            if shard:
                shard_state(m, make_mesh((2, 2), ("dp", "tp")))
            x = x0.clone().requires_grad_(True)
            (m["fc2"](x) * g).sum().backward()
            grads.append(dict(x=x.grad, w=m["fc2"].weight.grad, b=m["fc2"].bias.grad))
        out[kind] = grads
    out["tp_rank"] = make_mesh((2, 2), ("dp", "tp")).get_coordinate()[1]
    return out


def case_distributed(ctx, req):
    """``initialize`` is a no-op for one process; ``pod_mesh`` puts dp over
    nodes (2 ranks a node here) and tp within; ``host_local_batch`` gives
    each rank its dp share."""
    from dmx_compressor_tpu_torch.parallel import host_local_batch, initialize, pod_mesh
    from dmx_compressor_tpu_torch.parallel.comm import stages_through_host

    initialize(num_processes=1)
    mesh = pod_mesh(ranks_per_node=2)
    return dict(shape=dict(zip(mesh.mesh_dim_names, mesh.shape)),
                coord=tuple(mesh.get_coordinate()),
                local=host_local_batch(np.arange(8), mesh),
                staged=stages_through_host(torch.zeros(1), mesh.get_group("tp")))


CASES = {name[5:]: fn for name, fn in globals().items() if name.startswith("case_")}


def _rank_main(rank, world, tmp, names):
    torch.set_num_threads(1)
    import torch.distributed as dist

    # a peer that died leaves this rank's collective to time out, not hang
    dist.init_process_group("gloo", store=dist.FileStore(os.path.join(tmp, "store"), world),
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=COLLECTIVE_TIMEOUT))
    req = torch.load(os.path.join(tmp, "request.pt"), weights_only=False)
    req["dir"] = tmp
    # a case that raises ends this process, and the spawn context then ends
    # the world and raises the traceback in join_world
    results = {name: CASES[name]({"rank": rank, "world": world}, req) for name in names}
    torch.save(results, os.path.join(tmp, f"rank{rank}.pt"))
    dist.destroy_process_group()


def start_world(world: int, tmp: str, request: dict, names):
    """Spawn ``world`` gloo ranks running the cases ``names`` over
    ``request``, without waiting; :func:`join_world` collects them."""
    import torch.multiprocessing as mp

    torch.save(request, os.path.join(tmp, "request.pt"))
    return mp.start_processes(_rank_main, args=(world, tmp, list(names)), nprocs=world,
                              join=False, start_method="spawn")


def join_world(ctx, world: int, tmp: str) -> list:
    """Each rank's results.  A rank that failed raises here, with its
    traceback; a world still running after WORLD_TIMEOUT is killed and
    raises."""
    deadline = time.monotonic() + WORLD_TIMEOUT
    while not ctx.join(timeout=1):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            raise AssertionError(f"the gloo world ran past {WORLD_TIMEOUT} s")
    return [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False)
            for r in range(world)]


def run_world(world: int, tmp: str, request: dict, names) -> list:
    return join_world(start_world(world, tmp, request, names), world, tmp)
