"""Parallelism on the CPU: the port's rank-local shards against the JAX
package's placements (tests/test_parallel.py, test_serving.py's and
test_checkpoint.py's sharded cases), at JAX's tolerances.

One gloo world of 4 ranks (tests/torch_parallel.py, spawned once for the
module over a FileStore) runs every case of the port and returns its
results; the JAX values are computed here, on the 8-device CPU mesh where
JAX shards.  The cases: every family's forward (OPT, GPT-2, CLIP, Llama,
Qwen3, Gemma, Mistral, Whisper, T5, LeNet-5) in BASIC and weights mode
under dp 2 x tp 2 (widths whose shards keep whole BFP blocks: 128 wide,
heads of 32 or 64; GQA whose KV heads divide over tp, MQA whose one KV head
is replicated, and a GQA that divides neither way, replicated and logged);
whole BFP blocks and per-channel scales on the shards; the rule generator
and the fallback log; ``pipeline_forward`` at (pp 4), (dp 2, pp 2) and (pp
1), its gradients and BASIC OPT decoder layers; ``ring_attention`` at (sp
4) and (dp 2, sp 2) and its gradients; the engine over tp 2 (OPT and
Llama); the sharded checkpoint round trip (OPT, an MQA Llama at tp 2 and a
Llama whose 2 KV heads ranks hold in pairs at tp 4); the placements at tp 1
and of KV heads held in pairs; the units that cannot be cut exactly
(replicated and logged, against JAX) and the inputs ``shard_state`` still
refuses.
World 8 (pp 8, sp 8) is left out.
"""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from dmx_compressor_tpu.functional.approximate import NoApproximation as JNoApprox
from dmx_compressor_tpu.modeling.model import DmxModel as JDmxModel
from dmx_compressor_tpu.models import clip as jclip
from dmx_compressor_tpu.models import gemma as jgemma
from dmx_compressor_tpu.models import gpt2 as jgpt2
from dmx_compressor_tpu.models import lenet as jlenet
from dmx_compressor_tpu.models import llama as jllama
from dmx_compressor_tpu.models import mistral as jmistral
from dmx_compressor_tpu.models import opt as jopt
from dmx_compressor_tpu.models import qwen3 as jqwen3
from dmx_compressor_tpu.models import t5 as jt5
from dmx_compressor_tpu.models import whisper as jwhisper
from dmx_compressor_tpu.nn.core import DmxModule as JDmxModule
from dmx_compressor_tpu.ops.compress import compress_for_inference as j_compress
from dmx_compressor_tpu.parallel import mesh as jmesh

from dmx_compressor_tpu_torch.modeling.model import DmxModel
from dmx_compressor_tpu_torch.nn.core import DmxModule
from dmx_compressor_tpu_torch.ops.compress import build_weights_mode
from dmx_compressor_tpu_torch.parallel import mesh as tmesh
from test_torch_opt import flat_params
import torch_parallel as tpar

ATOL = 2e-3  # JAX's bar for sharded forwards (test_parallel.py)
SEEDS = {f: i for i, f in enumerate(tpar.FAMILIES)}
# family -> (JAX config, JAX model)
JAX_CLASSES = {"opt": (jopt.OPTConfig, jopt.OPTForCausalLM),
               "gpt2": (jgpt2.GPT2Config, jgpt2.GPT2LMHeadModel),
               "llama": (jllama.LlamaConfig, jllama.LlamaForCausalLM),
               "qwen3": (jqwen3.Qwen3Config, jqwen3.Qwen3ForCausalLM),
               "gemma": (jgemma.GemmaConfig, jgemma.GemmaForCausalLM),
               "mistral": (jmistral.MistralConfig, jmistral.MistralForCausalLM),
               "whisper": (jwhisper.WhisperConfig, jwhisper.WhisperForConditionalGeneration),
               "t5": (jt5.T5Config, jt5.T5ForConditionalGeneration)}
# family -> (keys holding these must be sharded on a rank, keys holding
# these must stay replicated, what shard_state must log), at dp 2 x tp 2
EXPECT = {
    "opt": (["fc1", "lm_head", "self_attn."], [], []),
    "gpt2": (["c_fc", "lm_head", "attn.c_attn"], [], []),
    "clip": (["fc1", "self_attn."], [], []),
    "llama": (["mlp.", "self_attn.", "lm_head", "embed_tokens"], [], []),
    "qwen3": (["mlp.", "self_attn.q", "lm_head"], ["q_norm", "k_norm"], []),
    "gemma": (["mlp.", "self_attn.q", "lm_head"], ["self_attn.k_proj", "self_attn.v_proj"], []),
    "mistral": (["mlp.", "lm_head"], ["self_attn."], ["3 KV heads"]),
    "whisper": (["fc1", "self_attn.", "encoder_attn.", "embed_tokens"], ["conv1", "conv2"], []),
    "t5": (["decoder.embed_tokens", "shared"],
           [".q.", ".k.", ".v.", ".o.", ".wi", ".wo", "relative_attention_bias"], []),
    "lenet": ([], ["fc", "conv"], ["cut blocks of 64"]),
}


@pytest.fixture(autouse=True)
def _restore_inference_mode():
    prev = (DmxModule.inference_mode, JDmxModule.inference_mode)
    yield
    DmxModule.inference_mode, JDmxModule.inference_mode = prev


def jax_model(family, seed=None, cfg=None):
    seed = SEEDS[family] if seed is None else seed
    if family == "lenet":
        return jlenet.LeNet5(rngs=nnx.Rngs(seed))
    if family == "clip":
        cfg = jclip.CLIPConfig(vision=jclip.CLIPVisionConfig(**tpar.CLIP_VISION),
                               text=jclip.CLIPTextConfig(**tpar.CLIP_TEXT),
                               projection_dim=tpar.CLIP_PROJ)
        return jclip.CLIPModel(cfg, rngs=nnx.Rngs(seed))
    jcfg, jcls = JAX_CLASSES[family]
    return jcls(cfg or jcfg(**tpar.FIELDS[family]), rngs=nnx.Rngs(seed))


def jax_mode(jm, mode):
    jdm = JDmxModel.from_raw(jm)
    jdm.to_basic_mode()
    if mode == "weights":
        for _, m in jdm.named_dmx_modules():
            m.input_casts.set_format(["SAME"] * len(m.input_casts))
            m.output_casts.set_format(["SAME"] * len(m.output_casts))
            m.approximator.function = JNoApprox()
        # the payload path (f32 products), not the bf16 dequant cache, as the
        # port's other weights-mode tests build JAX's
        prev = os.environ.get("DMX_DECODE_FUSED")
        os.environ["DMX_DECODE_FUSED"] = "1"
        try:
            j_compress(jdm)
        finally:
            if prev is None:
                del os.environ["DMX_DECODE_FUSED"]
            else:
                os.environ["DMX_DECODE_FUSED"] = prev
        JDmxModule.inference_mode = True
    else:
        JDmxModule.inference_mode = False
    return jm


def _mlp_layers(L, D, seed=0):
    rs = np.random.RandomState(seed)
    return [{"w": (rs.randn(D, D) * 0.3).astype(np.float32),
             "b": (rs.randn(D) * 0.1).astype(np.float32)} for _ in range(L)]


def _inputs():
    rng = np.random.default_rng(7)
    out = {}
    for family in tpar.FAMILIES:
        out[family] = {"ids": rng.integers(0, 256, (4, 8)).astype(np.int64)}
    out["clip"]["ids"] = rng.integers(0, tpar.CLIP_TEXT["vocab_size"], (4, 8)).astype(np.int64)
    out["clip"]["px"] = rng.standard_normal(
        (4, 3, tpar.CLIP_VISION["image_size"], tpar.CLIP_VISION["image_size"])
    ).astype(np.float32)
    w = tpar.WHISPER_FIELDS
    out["whisper"]["feats"] = rng.standard_normal(
        (4, w["num_mel_bins"], 2 * w["max_source_positions"])).astype(np.float32)
    out["whisper"]["ids"] = out["whisper"]["ids"][:, :4]
    out["t5"]["enc_ids"] = rng.integers(0, 256, (4, 6)).astype(np.int64)
    out["t5"]["ids"] = out["t5"]["ids"][:, :3]
    out["lenet"]["px"] = rng.standard_normal((4, 1, 28, 28)).astype(np.float32)
    return out


def _engine_cfg():
    return jopt.OPTConfig(**tpar.ENGINE_FIELDS)


def _llama_engine_model():
    return jllama.LlamaForCausalLM(jllama.LlamaConfig(**tpar.LLAMA_ENGINE_FIELDS),
                                   rngs=nnx.Rngs(0))


def _prompts():
    rng = np.random.default_rng(0)
    return [rng.integers(1, tpar.ENGINE_FIELDS["vocab_size"], (n,)).astype(np.int32)
            for n in (5, 9, 3)]


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    rs = np.random.RandomState
    req = {
        "params": {f: flat_params(jax_model(f)) for f in tpar.FAMILIES},
        "inputs": _inputs(),
        "w": np.random.default_rng(0).standard_normal((64, 512)).astype(np.float32),
        "x": np.random.default_rng(1).standard_normal((3, 64)).astype(np.float32),
        "mlp_layers": _mlp_layers(8, 16),
        "mlp_x": rs(1).randn(8, 16).astype(np.float32),
        "grad_layers": _mlp_layers(4, 8, seed=2),
        "grad_x": rs(3).randn(8, 8).astype(np.float32),
        "opt_layers": [flat_params(jopt.OPTDecoderLayer(jopt.OPTConfig.tiny(), rngs=nnx.Rngs(i)))
                       for i in range(4)],
        "opt_x": rs(0).randn(4, 8, jopt.OPTConfig.tiny().hidden_size).astype(np.float32),
        "engine_params": flat_params(jopt.OPTForCausalLM(_engine_cfg(), rngs=nnx.Rngs(0))),
        "llama_engine_params": flat_params(_llama_engine_model()),
        "prompts": _prompts(),
        "ckpt_params": flat_params(jopt.OPTForCausalLM(
            jopt.OPTConfig(**tpar.CKPT_FIELDS), rngs=nnx.Rngs(0))),
        "ckpt_ids": np.random.default_rng(0).integers(0, 128, (2, 9)).astype(np.int64),
        "fallback_params": {f: flat_params(_fallback_model(f)) for f in ("opt", "llama")},
    }
    r = rs(0)
    req["qkv"] = [r.randn(2, 4, 32, 16).astype(np.float32) for _ in range(3)]
    r = rs(1)
    req["grad_qkv"] = [r.randn(1, 2, 16, 8).astype(np.float32) for _ in range(3)]
    tmp = str(tmp_path_factory.mktemp("gloo4"))
    ctx = tpar.start_world(4, tmp, req, list(tpar.CASES))
    try:
        refs = _jax_refs(req)  # while the ranks run
    finally:
        results = tpar.join_world(ctx, 4, tmp)
    return req, results, refs


def _fallback_model(family):
    jcfg, jcls = JAX_CLASSES[family]
    return jcls(jcfg(**tpar.FALLBACK_FIELDS[family]), rngs=nnx.Rngs(0))


def _jax_fallback(case, inputs):
    """JAX's unsharded forward of a fallback case's model, in its mode (the
    SmoothQuant case calibrated as ``tpar._calibrate_smoothquant`` does)."""
    from dmx_compressor_tpu.advanced_recipe import DmxModuleSmoothQuantHyperparams

    family, mode, _ = tpar.FALLBACK_CASES[case]
    jm = _fallback_model(family)
    ids = jnp.asarray(tpar.fallback_ids(inputs), jnp.int32)
    if mode == "weights":
        jax_mode(jm, mode)
    elif mode == "baseline":
        JDmxModule.inference_mode = False
        JDmxModel.from_raw(jm).to_baseline_mode()
        hp = DmxModuleSmoothQuantHyperparams(migration_strength=0.5, fuse_to_weight=False)
        for layer in jm.model.decoder.layers:
            with layer.fc2.calibrating_smoothquant(hp):
                jm(ids)
    return np.asarray(jm(ids))


def _jax_refs(req):
    """JAX's values for every case (eager: tiny models compile faster op by
    op than as one program)."""
    from dmx_compressor_tpu.parallel.sequence import ring_attention as j_ring
    from dmx_compressor_tpu.rawnn import ScaledDotProductAttention

    refs = {}
    for family in tpar.FAMILIES:
        for mode in tpar.MODES:
            refs[(family, mode)] = _jax_forward(family, mode, req["inputs"][family])
    for case in tpar.FALLBACK_CASES:
        refs[("fallback", case)] = _jax_fallback(case, req["inputs"])
    layers = [jopt.OPTDecoderLayer(jopt.OPTConfig.tiny(), rngs=nnx.Rngs(i)) for i in range(4)]
    JDmxModule.inference_mode = False
    for layer in layers:
        JDmxModel.from_raw(layer).to_basic_mode()

    h = jnp.asarray(req["opt_x"])
    for layer in layers:
        h = layer(h)
    refs["quantized"] = np.asarray(h)
    q, k, v = (jnp.asarray(a) for a in req["qkv"])
    for causal in (False, True):
        refs[("exact", causal)] = np.asarray(ScaledDotProductAttention()(q, k, v,
                                                                          is_causal=causal))
        for shape, names in (((4,), ("sp",)), ((2, 2), ("dp", "sp"))):
            refs[(shape, causal)] = np.asarray(j_ring(
                q, k, v, jmesh.make_mesh(shape, names), causal=causal,
                dp_axis="dp" if len(shape) == 2 else None))
    args = tuple(jnp.asarray(a) for a in req["grad_qkv"])
    refs["ring_grads"] = [np.asarray(g) for g in jax.grad(
        lambda a: jnp.sum(ScaledDotProductAttention()(*a, is_causal=True) ** 2))(args)]
    jm = jopt.OPTForCausalLM(_engine_cfg(), rngs=nnx.Rngs(0))
    refs["engine"] = [_jax_ref_generate(jm, p, 4) for p in req["prompts"]]
    jm = _llama_engine_model()
    refs["engine_llama"] = [_jax_ref_generate(jm, p, 4) for p in req["prompts"]]
    return refs


# ---------------------------------------------------------------------------
# meshes and rules
# ---------------------------------------------------------------------------


def test_mesh_and_rules(world):
    _, res, _ = world
    assert res[0]["fallback"]["mesh_shape"] == {"dp": 1, "tp": 4}
    assert tmesh.spec_for_path("model.decoder.layers.0.self_attn.q_proj.weight") == ("tp", None)
    assert tmesh.spec_for_path("model.decoder.layers.0.self_attn.out_proj.weight") == (None, "tp")
    assert tmesh.spec_for_path("model.decoder.layers.0.self_attn_layer_norm.weight") == ()
    assert tmesh.spec_for_path("transformer.h.0.attn.c_attn.weight") == ("tp", None)
    assert tmesh.spec_for_path("transformer.h.0.attn.c_proj.weight") == (None, "tp")
    assert tmesh.spec_for_path("transformer.h.0.mlp.c_fc.bias") == ("tp",)


def _port_mode(family, mode):
    m = tpar.port_model(family)
    if mode == "basic":
        DmxModel.from_raw(m).to_basic_mode()
    else:
        build_weights_mode(m)
    return m


@pytest.mark.parametrize("mode", tpar.MODES)
@pytest.mark.parametrize("family", tpar.FAMILIES)
def test_port_rules_give_jax_specs(family, mode):
    """Every state-dict key of the port's model gets the spec JAX's rules
    give the same path (JAX's nnx paths, ``.value`` dropped, are the port's
    keys in both modes); the merged projections (the port's addition, JAX
    leaves them replicated) are column parallel.  Every JAX path of a
    weight-like leaf has its key in the port.  A tensor several keys share
    (a tied or shared table, a merged projection's input casts) is placed by
    the key whose module path JAX's state lists it under."""
    pm = _port_mode(family, mode)
    port_keys = set(pm.state_dict())
    jm = _jax_built(family, mode)
    jpaths = {jmesh._path_str(p).replace("..value", "").replace(".value", "")
              for p, _ in jax.tree_util.tree_flatten_with_path(nnx.split(jm)[1])[0]}
    for key in sorted(port_keys):
        want = tuple(jmesh.spec_for_path(key))
        got = tuple(tmesh.spec_for_path(key))
        if any(m in key for m in ("qkv_merged", "gateup_merged")) and key.rsplit(".", 1)[-1] in (
                "weight_mantissa", "weight_exponent", "bias"):
            assert got[0] == "tp", key
            continue
        assert got == want, (key, got, want)
    weights = {p for p in jpaths if p.rsplit(".", 1)[-1] in (
        "weight", "bias", "weight_mantissa", "weight_exponent")}
    assert weights - port_keys == set()
    groups = {}
    for k, v in pm.state_dict(keep_vars=True).items():
        groups.setdefault(id(v), []).append(k)
    jmods = {p.rsplit(".", 1)[0] for p in jpaths}
    checked = 0
    for group in (g for g in groups.values() if len(g) > 1):
        listed = jmods & {k.rsplit(".", 1)[0] for k in group}
        if listed:
            assert listed == {tmesh.canonical_key(group).rsplit(".", 1)[0]}, group
            checked += 1
    if family == "t5" or (mode == "basic" and family in ("qwen3", "gemma", "opt", "gpt2",
                                                         "whisper")):  # a shared table
        assert checked > 0


# ---------------------------------------------------------------------------
# sharded forwards
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _jax_built(family, mode):
    """The JAX model of the family's seed in ``mode`` (built once for the
    module: the rules test reads its state, the forward runs it)."""
    return jax_mode(jax_model(family), mode)


def _jax_forward(family, mode, inputs):
    """JAX's unsharded forward: BASIC as one program (its many small casts
    compile faster so than op by op), weights mode eager."""
    jm = _jax_built(family, mode)
    JDmxModule.inference_mode = mode == "weights"
    names = {"clip": ("ids", "px"), "whisper": ("feats", "ids"), "t5": ("enc_ids", "ids"),
             "lenet": ("px",)}.get(family, ("ids",))
    args = [jnp.asarray(inputs[n], jnp.int32 if "ids" in n else jnp.float32) for n in names]

    def run(m, *a):
        if family == "clip":  # the logits per image, and the image and text features
            return m(*a)[0], m.get_image_features(a[1]), m.get_text_features(a[0])
        return m(*a)

    out = (nnx.jit(run) if mode == "basic" else run)(jm, *args)
    if family == "clip":
        return np.asarray(out[0]), (np.asarray(out[1]), np.asarray(out[2]))
    return np.asarray(out), None


@pytest.mark.parametrize("mode", tpar.MODES)
@pytest.mark.parametrize("family", tpar.FAMILIES)
def test_sharded_forward_matches_single_device(world, family, mode):
    """dp 2 x tp 2: each rank's output equals the port's unsharded forward
    and JAX's (at JAX's 2e-3); its attention holds its local heads (query
    and KV); what JAX's rules shard is sharded, what cannot be cut exactly
    stays replicated and is logged; every key of a shared table is placed
    as JAX places the table's canonical path."""
    req, res, refs = world
    want, feats = refs[(family, mode)]
    must_shard, must_replicate, must_log = EXPECT[family]
    for rank in range(4):
        r = res[rank]["forwards"][(family, mode)]
        assert r["heads"] == tpar.HEADS[family]
        np.testing.assert_allclose(r["full"].numpy(), want, atol=ATOL)
        if family == "clip":
            np.testing.assert_allclose(r["local"].numpy(), want, atol=ATOL)
            dp = r["coord"][0]
            for got, full, j in ((r["img_feat"], r["img_full"], feats[0]),
                                 (r["txt_feat"], r["txt_full"], feats[1])):
                np.testing.assert_allclose(got.numpy(), full[2 * dp:2 * dp + 2].numpy(),
                                           atol=ATOL)
                np.testing.assert_allclose(got.numpy(), j[2 * dp:2 * dp + 2], atol=ATOL)
        else:
            dp = r["coord"][0]
            np.testing.assert_allclose(r["local"].numpy(), r["full"][2 * dp:2 * dp + 2].numpy(),
                                       atol=ATOL)
            np.testing.assert_allclose(r["local"].numpy(), want[2 * dp:2 * dp + 2], atol=ATOL)
        for part in must_shard:
            assert any(part in k for k in r["sharded"]), (part, r["sharded"])
        for part in must_replicate:
            assert not any(part in k for k in r["sharded"]), (part, r["sharded"])
        if not must_shard:
            assert r["sharded"] == []
        for text in must_log:
            assert any("fallback" in m and text in m for m in r["messages"]), r["messages"]
        for group in r["shared"]:
            specs = {r["placement"][k] for k in group}
            assert len(specs) == 1, group
            got = specs.pop()
            if any(got):
                assert tuple(jmesh.spec_for_path(tmesh.canonical_key(group)))[0] == got[0], group


def test_observer_on_a_sharded_activation_sees_it_whole(world):
    """The statistics equal the unsharded model's (up to fc1's f32 product
    over another width) and are the same on both ranks of a tp group, whose
    local activations differ."""
    _, res, _ = world
    for rank in range(4):
        (min0, max0), (min1, max1) = res[rank]["observer"]
        np.testing.assert_allclose(min1.numpy(), min0.numpy(), rtol=1e-6)
        np.testing.assert_allclose(max1.numpy(), max0.numpy(), rtol=1e-6)
        assert max0.item() > 0
        assert torch.equal(max1, res[rank ^ 1]["observer"][1][1])


@pytest.mark.parametrize("kind", ["raw", "dmx"])
def test_row_parallel_whole_input_gradients(world, kind):
    """A standalone row-parallel linear fed a whole input: the input's
    gradient equals the unsharded one on every rank (summed over the tp
    group), the weight shard's is its columns of the unsharded gradient
    and the bias's is whole."""
    _, res, _ = world
    for rank in range(4):
        r = res[rank]["row_grad"]
        full, shard = r[kind]
        t = r["tp_rank"]
        np.testing.assert_allclose(shard["x"].numpy(), full["x"].numpy(), atol=1e-6)
        np.testing.assert_allclose(shard["w"].numpy(), full["w"][:, 8 * t:8 * (t + 1)].numpy(),
                                   atol=1e-6)
        np.testing.assert_allclose(shard["b"].numpy(), full["b"].numpy(), atol=1e-6)


def test_distributed_helpers(world):
    _, res, _ = world
    for rank in range(4):
        r = res[rank]["distributed"]
        assert r["shape"] == {"dp": 2, "tp": 2} and r["coord"] == (rank // 2, rank % 2)
        np.testing.assert_array_equal(r["local"].numpy(), np.arange(4) + 4 * (rank // 2))
        assert not r["staged"]  # CPU tensors: gloo moves them itself


def test_tp_sharding_preserves_bfp_blocks(world):
    """A BFP64-blocked [64, 512] weight over tp 4 along its input features
    keeps whole blocks (128 a shard); unpacking a shard is bit-exact."""
    _, res, _ = world
    for rank in range(4):
        r = res[rank]["blocks"][tmesh.P(None, "tp")]
        assert r["shape"] == (64, 128) and r["exp_shape"] == (64, 2)
        assert torch.equal(r["local"], r["want"])


def test_packed_bfp_sharding_colocates_scales(world):
    """Packed mantissas and exponents shard together along the out dim;
    each shard unpacks to its rows of the unsharded reconstruction."""
    _, res, _ = world
    for rank in range(4):
        r = res[rank]["blocks"][tmesh.P("tp", None)]
        assert r["shape"] == (16, 512) and r["exp_shape"] == (16, 8)
        assert torch.equal(r["local"], r["want"])


def test_per_channel_scale_shards_with_out_dim(world):
    _, res, _ = world
    for rank in range(4):
        r = res[rank]["scale"]
        assert r["full_scale"].shape[0] == 32
        assert r["scale"].shape[0] == 8
        assert torch.equal(r["scale"], r["full_scale"][8 * rank:8 * rank + 8])
        assert r["placement"]["weight_cast.scale"] == ("tp",)
        assert r["placement"]["weight"] == ("tp", None)
        # the standalone column-parallel Linear gathers its outputs
        np.testing.assert_array_equal(r["got"].numpy(), r["want"].numpy())


def test_rules_for_model_generator_and_fallback_warning(world):
    _, res, _ = world
    r = res[0]["fallback"]
    assert any("q_proj" in pat for pat in r["exact_first"])
    assert any("fallback" in msg for msg in r["messages"])
    assert r["bare_shape"] == (6, 16) and r["bare_placement"]["q_proj.weight"] == ()


@pytest.mark.parametrize("case", list(tpar.FALLBACK_CASES))
def test_unshardable_raises_value_error(world, case):
    """What the port cannot cut exactly no longer raises, as JAX computes
    it: the unit (the attention or the MLP) stays replicated on every rank
    of tp 4, its keys unsharded, the warning names it and the reason, and
    the forward equals the port's unsharded one and JAX's (at 2e-3).  Cases: 3 query heads; an MLP
    whose row linear's 32 local inputs cut BFP blocks of 64; SmoothQuant
    state on a row linear; 3 KV heads under 12 query heads (neither divides
    the other).  The rest of the model still shards (the "heads" case's
    MLP).  The name is kept from when these raised ValueError;
    test_shard_state_still_raises holds what still does."""
    _, res, refs = world
    reason = {"heads": "3 query heads", "block": "cut blocks of 64",
              "smoothquant": "smoothquant", "kv_heads": "3 KV heads"}[case]
    unit = tpar.FALLBACK_CASES[case][2]
    for rank in range(4):
        r = res[rank]["fallback"]["replicated"][case]
        assert any("fallback" in m and unit.rstrip(".").rsplit(".", 1)[0] in m and reason in m
                   for m in r["messages"]), r["messages"]
        assert r["unit"] and all(v == () for v in r["unit"].values())
        assert r["err"] <= 1e-5
        np.testing.assert_allclose(r["got"].numpy(), refs[("fallback", case)], atol=ATOL)
    if case == "heads":
        assert any(".fc1." in k for k in res[0]["fallback"]["replicated"][case]["sharded"])


@pytest.mark.parametrize("case", ["sharded", "outside"])
def test_shard_state_still_raises(world, case):
    """``shard_state`` refuses a model sharded already and a rank outside
    the mesh (ranks 2 and 3 of a (1, 2) mesh over 4)."""
    _, res, _ = world
    ranks = range(4) if case == "sharded" else (2, 3)
    for rank in ranks:
        msg = res[rank]["fallback"]["errors"][case]
        assert msg is not None and ("sharded already" if case == "sharded"
                                    else "not in the mesh") in msg
    if case == "outside":
        assert res[0]["fallback"]["errors"][case] is None


# ---------------------------------------------------------------------------
# pipeline and sequence parallelism
# ---------------------------------------------------------------------------


def _seq(layers, x):
    for p in layers:
        x = np.tanh(x @ p["w"] + p["b"])
    return x


@pytest.mark.parametrize("shape", [(4,), (2, 2), (1,)])
def test_pipeline_forward_matches_sequential(world, shape):
    req, res, _ = world
    want = _seq(req["mlp_layers"], req["mlp_x"])
    ranks = range(1) if shape == (1,) else range(4)
    for rank in ranks:
        np.testing.assert_allclose(res[rank]["pipeline"][shape].numpy(), want, atol=1e-6)


def test_pipeline_gradients_match_sequential(world):
    req, res, _ = world
    layers = [{k: jnp.asarray(v) for k, v in lay.items()} for lay in req["grad_layers"]]
    params = jax.tree.map(lambda *xs: jnp.stack(xs), *layers)
    x = jnp.asarray(req["grad_x"])

    def loss_seq(params):
        def body(h, p):
            return jnp.tanh(h @ p["w"] + p["b"]), None

        y, _ = jax.lax.scan(body, x, params)
        return jnp.sum(y ** 2)

    g_seq = jax.grad(loss_seq)(params)
    for k in ("w", "b"):
        got = sum(res[rank]["pipeline"]["grads"][k] for rank in range(4))
        np.testing.assert_allclose(got.numpy(), np.asarray(g_seq[k]), atol=1e-5)


def test_pipeline_quantized_decoder_layers(world):
    """BASIC OPT decoder layers at pp 4 equal the sequential BASIC layers,
    the port's and JAX's, at 2e-3."""
    _, res, refs = world
    ref = refs["quantized"]
    for rank in range(4):
        q = res[rank]["pipeline"]["quantized"]
        np.testing.assert_allclose(q["y"].numpy(), np.asarray(ref), atol=ATOL)
        np.testing.assert_allclose(q["y"].numpy(), q["seq"].numpy(), atol=ATOL)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("shape", [(4,), (2, 2)])
def test_ring_attention_matches_exact_sdpa(world, shape, causal):
    _, res, refs = world
    for rank in range(4):
        got = res[rank]["ring"][(shape, causal)].numpy()
        np.testing.assert_allclose(got, refs[("exact", causal)], atol=2e-6)
        np.testing.assert_allclose(got, refs[(shape, causal)], atol=2e-6)


def test_ring_attention_gradients_match_exact(world):
    _, res, refs = world
    for i in range(3):
        got = sum(res[rank]["ring"]["grads"][i] for rank in range(4))
        np.testing.assert_allclose(got.numpy(), refs["ring_grads"][i], atol=1e-5)


# ---------------------------------------------------------------------------
# the engine and checkpoints over sharded parameters
# ---------------------------------------------------------------------------


def _jax_ref_generate(model, prompt, n_new, max_len=48):
    caches = model.init_cache(1, max_len)
    logits = model(jnp.asarray(prompt[None], jnp.int32), caches=caches, position_offset=0)
    out = [int(jnp.argmax(logits[0, -1]))]
    for i in range(n_new - 1):
        logits = model(jnp.asarray([[out[-1]]], jnp.int32), caches=caches,
                       position_offset=int(prompt.size) + i)
        out.append(int(jnp.argmax(logits[0, -1])))
    return out


def test_engine_with_tp_sharded_params(world):
    """Each tp rank runs the same engine over its shard in lockstep; the
    tokens equal the unsharded engine's and JAX's isolated generation (the
    vocabulary of 97 does not divide tp 2: it stays replicated, logged)."""
    _, res, refs = world
    want = refs["engine"]
    for rank in range(4):
        r = res[rank]["engine"]
        assert r["cache_heads"] == 2
        assert r["plain"] == want
        assert r["sharded"] == want


def test_sharded_roundtrip_preserves_placement(world):
    _, res, _ = world
    for rank in range(4):
        r = res[rank]["checkpoint"]
        assert r["step"] == 1
        assert r["same_placement"] and r["n_sharded"] > 0
        assert r["values_equal"] and r["logits_equal"]
        assert torch.isfinite(r["logits"]).all()


def test_engine_with_tp_sharded_llama(world):
    """The engine over a tiny Llama sharded tp 2 (2 query heads over 1 KV
    head a rank, the row caches [B, 1, S, D]): its tokens equal the
    unsharded engine's and JAX's isolated generation."""
    _, res, refs = world
    for rank in range(4):
        r = res[rank]["engine_llama"]
        assert r["cache_heads"] == 1
        assert r["plain"] == refs["engine_llama"]
        assert r["sharded"] == refs["engine_llama"]


@pytest.mark.parametrize("case", list(tpar.LLAMA_CKPT_CASES))
def test_sharded_roundtrip_llama(world, case):
    """Llamas in weights mode: an MQA one at tp 2 (a rank's merged q/k/v,
    64 rows of its query heads beside the one KV head's 32 + 32) and one at
    tp 4 whose 2 KV heads ranks hold in pairs (64 + 32 + 32).  The merged
    q/k/v is sharded as a whole, the restore keeps the placement, and
    values and logits come back bit for bit."""
    _, res, _ = world
    heads = {"mqa_tp2": (2, 1), "gqa_tp4": (2, 1)}[case]
    for rank in range(4):
        r = res[rank]["checkpoint_llama"][case]
        assert r["step"] == 2 and r["qkv_shape"][0] == 128 and r["heads"] == heads
        assert r["qkv_spec"] == ("tp", None) and r["same_placement"]
        assert r["values_equal"] and r["logits_equal"]
        assert torch.isfinite(r["logits"]).all()


@pytest.mark.parametrize("case", ["kv_pairs_tp4", "tp1"])
def test_placement_where_heads_meet_tp(world, case):
    """A part is sharded where the ranks' rows of it differ: 2 KV heads at
    tp 4 (ranks 0-1 keep head 0, ranks 2-3 head 1; the logits equal the
    unsharded model's); and at tp 1 every column-parallel tensor keeps
    JAX's spec (P('tp', None)), plain, MQA or merged."""
    _, res, _ = world
    for rank in range(4):
        r = res[rank]["placement"][case]
        if case == "tp1":
            assert r == dict(q_spec=("tp", None), k_spec=("tp", None), qkv_spec=("tp", None))
            continue
        assert r["k_spec"] == ("tp", None) and r["q_spec"] == ("tp", None)
        assert r["heads"] == (2, 1) and r["k_rows"]
        assert r["err"] <= 1e-5
