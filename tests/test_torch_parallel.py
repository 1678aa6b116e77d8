"""Parallelism on the CPU: the port's rank-local shards against the JAX
package's placements (tests/test_parallel.py, test_serving.py's and
test_checkpoint.py's sharded cases), at JAX's tolerances.

One gloo world of 4 ranks (tests/torch_parallel.py, spawned once for the
module over a FileStore) runs every case of the port and returns its
results; the JAX values are computed here, on the 8-device CPU mesh where
JAX shards.  The cases: OPT, GPT-2 and CLIP forwards in BASIC and weights
mode under dp 2 x tp 2 (widths whose shards keep whole BFP blocks: 128
wide, heads of 64, MLP 256); whole BFP blocks and per-channel scales on the
shards; the rule generator and the fallback log; ``pipeline_forward`` at
(pp 4), (dp 2, pp 2) and (pp 1), its gradients and BASIC OPT decoder
layers; ``ring_attention`` at (sp 4) and (dp 2, sp 2) and its gradients;
the engine over tp 2; the sharded checkpoint round trip; and the inputs
the port refuses (a head count that does not divide tp, an uncovered
family).  World 8 (pp 8, sp 8) is left out.
"""

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
from dmx_compressor_tpu.models import gpt2 as jgpt2
from dmx_compressor_tpu.models import opt as jopt
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
SEEDS = {"opt": 0, "gpt2": 1, "clip": 2}


@pytest.fixture(autouse=True)
def _restore_inference_mode():
    prev = (DmxModule.inference_mode, JDmxModule.inference_mode)
    yield
    DmxModule.inference_mode, JDmxModule.inference_mode = prev


def jax_model(family, seed=None):
    seed = SEEDS[family] if seed is None else seed
    if family == "opt":
        return jopt.OPTForCausalLM(jopt.OPTConfig(**tpar.OPT_FIELDS), rngs=nnx.Rngs(seed))
    if family == "gpt2":
        return jgpt2.GPT2LMHeadModel(jgpt2.GPT2Config(**tpar.GPT2_FIELDS), rngs=nnx.Rngs(seed))
    cfg = jclip.CLIPConfig(vision=jclip.CLIPVisionConfig(**tpar.CLIP_VISION),
                           text=jclip.CLIPTextConfig(**tpar.CLIP_TEXT),
                           projection_dim=tpar.CLIP_PROJ)
    return jclip.CLIPModel(cfg, rngs=nnx.Rngs(seed))


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
    return out


def _engine_cfg():
    return jopt.OPTConfig(**tpar.ENGINE_FIELDS)


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
        "prompts": _prompts(),
        "ckpt_params": flat_params(jopt.OPTForCausalLM(
            jopt.OPTConfig(**tpar.CKPT_FIELDS), rngs=nnx.Rngs(0))),
        "ckpt_ids": np.random.default_rng(0).integers(0, 128, (2, 9)).astype(np.int64),
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


def _jax_refs(req):
    """JAX's values for every case (eager: tiny models compile faster op by
    op than as one program)."""
    from dmx_compressor_tpu.parallel.sequence import ring_attention as j_ring
    from dmx_compressor_tpu.rawnn import ScaledDotProductAttention

    refs = {}
    for family in tpar.FAMILIES:
        for mode in tpar.MODES:
            refs[(family, mode)] = _jax_forward(family, mode, req["inputs"][family])
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
    keys in both modes); the merged q/k/v (the port's addition, JAX leaves
    it replicated) is column parallel.  Every JAX path of a weight-like
    leaf has its key in the port."""
    port_keys = set(_port_mode(family, mode).state_dict())
    jm = jax_mode(jax_model(family), mode)
    jpaths = {jmesh._path_str(p).replace("..value", "").replace(".value", "")
              for p, _ in jax.tree_util.tree_flatten_with_path(nnx.split(jm)[1])[0]}
    for key in sorted(port_keys):
        want = tuple(jmesh.spec_for_path(key))
        got = tuple(tmesh.spec_for_path(key))
        if "qkv_merged" in key and key.rsplit(".", 1)[-1] in ("weight_mantissa",
                                                              "weight_exponent", "bias"):
            assert got[0] == "tp", key
            continue
        assert got == want, (key, got, want)
    weights = {p for p in jpaths if p.rsplit(".", 1)[-1] in (
        "weight", "bias", "weight_mantissa", "weight_exponent")}
    assert weights - port_keys == set()


# ---------------------------------------------------------------------------
# sharded forwards
# ---------------------------------------------------------------------------


def _jax_forward(family, mode, inputs):
    jm = jax_mode(jax_model(family), mode)
    ids = jnp.asarray(inputs["ids"], jnp.int32)
    if family == "clip":
        px = jnp.asarray(inputs["px"])
        return np.asarray(jm(ids, px)[0]), (np.asarray(jm.get_image_features(px)),
                                            np.asarray(jm.get_text_features(ids)))
    return np.asarray(jm(ids)), None


@pytest.mark.parametrize("mode", tpar.MODES)
@pytest.mark.parametrize("family", tpar.FAMILIES)
def test_sharded_forward_matches_single_device(world, family, mode):
    """dp 2 x tp 2: each rank's output equals the port's unsharded forward
    and JAX's (at JAX's 2e-3); its attention holds its one local head."""
    req, res, refs = world
    want, feats = refs[(family, mode)]
    for rank in range(4):
        r = res[rank]["forwards"][(family, mode)]
        assert r["heads"] == [1]
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
        # the vocabulary, the q/k/v and the MLP are sharded, not replicated
        assert any("fc1" in k or "c_fc" in k for k in r["sharded"])
        if family != "clip":
            assert any(k.startswith("lm_head") for k in r["sharded"])


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


@pytest.mark.parametrize("case", ["heads", "family"])
def test_unshardable_raises_value_error(world, case):
    """The port cannot split a head (3 heads at tp 4), and refuses a family
    it does not cover (Llama) instead of sharding it wrong."""
    _, res, _ = world
    msg = res[0]["fallback"]["errors"][case]
    assert msg is not None
    assert ("3 heads" in msg) if case == "heads" else ("llama" in msg)


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
