"""The whole slice on the CPU: the tiny OPT of the JAX package carried into the
port with ``load_jax_params``, then the weights-mode serving pipeline on both
sides (from_raw -> to_basic_mode -> SAME casts / NoApproximation ->
compress_for_inference -> int8 KV cache -> greedy prefill and decode).

The JAX side is built with ``DMX_DECODE_FUSED=1`` so its packed linears keep
the int8 payload and compute in f32 (``bfp_linear`` -> ``bfp_linear_ref`` on
the CPU), as the port does everywhere."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch
from flax import nnx

from dmx_compressor_tpu.functional.approximate import NoApproximation as JNoApprox
from dmx_compressor_tpu.modeling.model import DmxModel as JDmxModel
from dmx_compressor_tpu.models.opt import OPTConfig as JOPTConfig
from dmx_compressor_tpu.models.opt import OPTForCausalLM as JOPT
from dmx_compressor_tpu.models import positions as jpos
from dmx_compressor_tpu.ops.compress import compress_for_inference as j_compress

from dmx_compressor_tpu_torch.modeling.model import DmxModel
from dmx_compressor_tpu_torch.models.opt import (
    OPTConfig,
    OPTForCausalLM,
    greedy_decode,
    greedy_prefill,
    load_jax_params,
)
from dmx_compressor_tpu_torch.models import positions as tpos
from dmx_compressor_tpu_torch.nn.core import DmxModule
from dmx_compressor_tpu_torch.ops.compress import PackedBFPLinear, build_weights_mode

torch.set_num_threads(2)

SEED = 0  # model seed; its JAX top-1/top-2 margins are asserted below
B, T, CAP, STEPS = 2, 8, 32, 8
LOGIT_TOL = 1e-4


@pytest.fixture(autouse=True)
def _restore_port_inference_mode():
    prev = DmxModule.inference_mode
    yield
    DmxModule.inference_mode = prev


def jgreedy(row):
    mx = jnp.max(row, axis=-1, keepdims=True)
    idx = jnp.arange(row.shape[-1], dtype=jnp.int32)
    return jnp.max(jnp.where(row == mx, idx, -1), axis=-1).astype(jnp.int32)


def flat_params(model):
    return {
        ".".join(str(p) for p in path): np.asarray(v.get_value())
        for path, v in nnx.to_flat_state(nnx.state(model))
    }


def prompt():
    return np.random.default_rng(1).integers(0, JOPTConfig.tiny().vocab_size, (B, T)).astype(np.int32)


@pytest.fixture(scope="module")
def pair():
    """Both weights-mode pipelines, prefilled and decoded once."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("DMX_DECODE_FUSED", "1")
        jm = JOPT(JOPTConfig.tiny(), rngs=nnx.Rngs(SEED))
        params = flat_params(jm)
        jdm = JDmxModel.from_raw(jm)
        jdm.to_basic_mode()
        for _, m in jdm.named_dmx_modules():
            m.input_casts.set_format(["SAME"] * len(m.input_casts))
            m.output_casts.set_format(["SAME"] * len(m.output_casts))
            m.approximator.function = JNoApprox()
        j_compress(jdm)
    ids = prompt()
    jc = jm.init_cache(B, CAP, quantized=True)
    jlogits = jm(jnp.asarray(ids), caches=jc, position_offset=0)
    jcache_after_prefill = [
        (np.asarray(c.k_q.value), np.asarray(c.v_q.value),
         np.asarray(c.k_scale.value), np.asarray(c.v_scale.value)) for c in jc
    ]
    jrows = [jlogits[:, -1]]
    tok = jgreedy(jlogits[:, -1])
    jtoks = [tok]
    for i in range(STEPS - 1):
        lg = jm(tok[:, None], caches=jc, position_offset=T + i)
        jrows.append(lg[:, -1])
        tok = jgreedy(lg[:, -1])
        jtoks.append(tok)

    tm = OPTForCausalLM(OPTConfig.tiny(), device="cpu")
    load_jax_params(tm, params)
    tdm = build_weights_mode(tm)
    tc = tm.init_cache(B, CAP, quantized=True, device="cpu")
    tlogits, ttok = greedy_prefill(tm, tc, torch.from_numpy(ids))
    tcache_after_prefill = [(c.k_q.clone(), c.v_q.clone(), c.k_scale.clone(), c.v_scale.clone())
                            for c in tc]
    ttoks, _ = greedy_decode(tm, tc, ttok, T, STEPS - 1)
    return dict(
        jm=jm, tm=tm, tdm=tdm, params=params,
        jlogits=np.asarray(jlogits), tlogits=tlogits.numpy(),
        jcache=jcache_after_prefill, tcache=tcache_after_prefill,
        jtoks=np.stack([np.asarray(t) for t in jtoks], 1),
        ttoks=torch.cat([ttok[:, None], ttoks], 1).numpy(),
        jrows=np.stack([np.asarray(r) for r in jrows]),
    )


def _packed_modules(jm, tm):
    for jl, tl in zip(jm.model.decoder.layers, tm.model.decoder.layers):
        yield jl.self_attn.qkv_merged, tl.self_attn.qkv_merged
        yield jl.self_attn.out_proj, tl.self_attn.out_proj
        yield jl.fc1, tl.fc1
        yield jl.fc2, tl.fc2
    yield jm.lm_head, tm.lm_head


def test_packed_weights_equal_bit_for_bit(pair):
    n = 0
    for jp, tp in _packed_modules(pair["jm"], pair["tm"]):
        assert isinstance(tp, PackedBFPLinear)
        assert jp.weight_bf16 is None  # DMX_DECODE_FUSED keeps the int8 payload
        np.testing.assert_array_equal(tp.weight_mantissa.numpy(),
                                      np.asarray(jp.weight_mantissa.get_value()))
        np.testing.assert_array_equal(tp.weight_exponent.numpy(),
                                      np.asarray(jp.weight_exponent.get_value()))
        if jp.bias is not None:
            np.testing.assert_array_equal(tp.bias.detach().numpy().view(np.uint32),
                                          np.asarray(jp.bias.get_value()).view(np.uint32))
        n += 1
    assert n == 4 * OPTConfig.tiny().num_hidden_layers + 1
    # merged q/k/v: one projection of 3*d outputs, originals released
    attn = pair["tm"].model.decoder.layers[0].self_attn
    assert attn.qkv_merged.out_features == 3 * OPTConfig.tiny().hidden_size
    assert attn.q_proj.weight_mantissa is None


def test_sdpa_transparency_frozen_at_compress(pair):
    """compress_for_inference freezes the routing's transparency check (True
    in weights mode); before it, attend asks the casts (False in BASIC mode,
    as the JAX package's sdpa_transparent says)."""
    from dmx_compressor_tpu.ops.flash_attention import sdpa_transparent as j_transparent
    from dmx_compressor_tpu_torch.ops.flash_attention import sdpa_transparent

    assert all(l.self_attn.sdpa_is_transparent is True for l in pair["tm"].model.decoder.layers)
    jm = JOPT(JOPTConfig.tiny(), rngs=nnx.Rngs(1))
    tm = OPTForCausalLM(OPTConfig.tiny(), device="cpu")
    JDmxModel.from_raw(jm).to_basic_mode()
    DmxModel.from_raw(tm).to_basic_mode()
    attn = tm.model.decoder.layers[0].self_attn
    assert attn.sdpa_is_transparent is None
    assert sdpa_transparent(attn.sdpa) is False
    assert j_transparent(jm.model.decoder.layers[0].self_attn.sdpa) is False


def test_int8_cache_after_prefill(pair):
    """The int8 payloads are equal bit for bit.  The scales (amax / 127) are
    held to rtol 1e-6: the K/V they come from are f32 matmul outputs, which
    XLA:CPU and torch sum in different orders (a few ulp apart); the
    quantizer itself is bit-exact on equal inputs (test_torch_kernels)."""
    for (jk, jv, jks, jvs), (tk, tv, tks, tvs) in zip(pair["jcache"], pair["tcache"]):
        # the JAX cache is [B, H, D, S]; the port's is [B, H, S, D]
        np.testing.assert_array_equal(tk.numpy(), np.swapaxes(jk, -1, -2))
        np.testing.assert_array_equal(tv.numpy(), np.swapaxes(jv, -1, -2))
        np.testing.assert_allclose(tks.numpy(), jks, rtol=1e-6, atol=0)
        np.testing.assert_allclose(tvs.numpy(), jvs, rtol=1e-6, atol=0)
        assert np.abs(tk[:, :, :T].numpy()).max() > 0 and not tk[:, :, T:].any()
        assert not tks[:, :, T:].any()


def test_prefill_logits_match(pair):
    np.testing.assert_allclose(pair["tlogits"], pair["jlogits"], atol=LOGIT_TOL, rtol=0)


def test_greedy_decode_tokens_identical(pair):
    top2 = np.sort(pair["jrows"], axis=-1)[..., -2:]
    margins = top2[..., 1] - top2[..., 0]
    assert margins.min() > LOGIT_TOL, f"near-tie in the JAX run: {margins.min()}"
    assert pair["ttoks"].shape == (B, STEPS)
    np.testing.assert_array_equal(pair["ttoks"], pair["jtoks"])


def test_raw_and_baseline_models_match_jax_without_cache():
    """The raw port model and its BASELINE Dmx model (modular compound SDPA,
    unpacked Linears) against the JAX ones, no cache."""
    jm = JOPT(JOPTConfig.tiny(), rngs=nnx.Rngs(3))
    tm = OPTForCausalLM(OPTConfig.tiny(), device="cpu")
    load_jax_params(tm, flat_params(jm))
    ids = prompt()
    want = np.asarray(jm(jnp.asarray(ids)))
    with torch.no_grad():
        np.testing.assert_allclose(tm(torch.from_numpy(ids)).numpy(), want, atol=LOGIT_TOL)
        JDmxModel.from_raw(jm).to_baseline_mode()
        tdm = DmxModel.from_raw(tm).to_baseline_mode()
        want = np.asarray(jm(jnp.asarray(ids)))
        np.testing.assert_allclose(tdm(torch.from_numpy(ids)).numpy(), want, atol=LOGIT_TOL)
    assert tm.lm_head.weight is tm.model.decoder.embed_tokens.weight  # still tied
    assert {"Linear", "Embedding", "LayerNorm", "ResAdd", "ReLU", "ScaledDotProductAttention",
            "ActActMatMul", "Softmax", "Mul", "Dropout"} <= {
        type(m).__name__ for _, m in tdm.named_dmx_modules()}


def test_load_jax_params_rejects_missing_and_unknown(pair):
    tm = OPTForCausalLM(OPTConfig.tiny(), device="cpu")
    params = dict(pair["params"])
    params.pop("model.decoder.final_layer_norm.bias")
    with pytest.raises(KeyError):
        load_jax_params(tm, params)
    params = dict(pair["params"], **{"model.decoder.nope.kernel": np.zeros((2, 2))})
    with pytest.raises(KeyError):
        load_jax_params(tm, params)


def test_fp_cache_decode_matches_jax():
    """The full-precision cache of the raw models: prefill through
    flash_attention on both sides; decode through the port's flash_decode
    (B4's plain version on the CPU) against the JAX package's modular
    SDPA."""
    jm = JOPT(JOPTConfig.tiny(), rngs=nnx.Rngs(5))
    tm = OPTForCausalLM(OPTConfig.tiny(), device="cpu")
    load_jax_params(tm, flat_params(jm))
    ids = prompt()
    jc = jm.init_cache(B, CAP)
    tc = tm.init_cache(B, CAP, device="cpu")
    with torch.no_grad():
        for step in range(3):
            x = ids if step == 0 else ids[:, step - 1:step]
            off = 0 if step == 0 else T + step - 1
            want = np.asarray(jm(jnp.asarray(x), caches=jc, position_offset=off))
            got = tm(torch.from_numpy(x), caches=tc, position_offset=off).numpy()
            np.testing.assert_allclose(got, want, atol=LOGIT_TOL)


@pytest.mark.parametrize("offset", [0, 5, [3, 0, 7]])
def test_positions_and_causal_mask_match_jax(offset):
    T_, S_ = 4, 12
    joff = jnp.asarray(offset, jnp.int32) if isinstance(offset, list) else offset
    toff = torch.tensor(offset, dtype=torch.int32) if isinstance(offset, list) else offset
    jp, jrow = jpos.resolve_positions(T_, joff)
    tp, trow = tpos.resolve_positions(T_, toff)
    assert jrow == trow
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(tpos.causal_mask(T_, S_, toff, torch.float32).numpy(),
                                  np.asarray(jpos.causal_mask(T_, S_, joff, jnp.float32)))
