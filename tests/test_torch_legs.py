"""The JAX bench's SBFP leg and fp32 baseline leg, end to end on the CPU, and
the kernel routing of all three serving modes.

The tiny OPT of the JAX package is carried into the port with
``load_jax_params``; both sides then build the same serving configuration
(bench.py:_build_host) and run greedy prefill and decode:

- SBFP: every Linear, the tied LM head included, stores its weight as
  SBFP12_16 and is packed into a PackedSBFPLinear; int8 KV cache.  The JAX
  side is built with ``DMX_DECODE_FUSED=1`` so its packed linears compute in
  f32 from the payload (without it they round activations to bf16,
  compress.py:310-315), as the port does everywhere.
- baseline: BASELINE rules (every cast SAME), plain Linears, f32 KV cache.
  The JAX side runs its modular SDPA at decode, and once more with its
  flash-decode gate forced on, so that its interpret-mode kernel B4 stands
  on the other side.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch
from flax import nnx

from dmx_compressor_tpu import DmxConfigRule as JDmxConfigRule
from dmx_compressor_tpu import nn as jdmxnn
from dmx_compressor_tpu.modeling.model import DmxModel as JDmxModel
from dmx_compressor_tpu.models.opt import OPTConfig as JOPTConfig
from dmx_compressor_tpu.models.opt import OPTForCausalLM as JOPT
from dmx_compressor_tpu.ops import flash_decode as jfd
from dmx_compressor_tpu.ops.compress import compress_for_inference as j_compress

from dmx_compressor_tpu_torch.modeling.model import DmxConfigRule as TDmxConfigRule
from dmx_compressor_tpu_torch.modeling.model import DmxModel as TDmxModel
from dmx_compressor_tpu_torch.models import opt as topt
from dmx_compressor_tpu_torch.nn import modules as tdmxnn
from dmx_compressor_tpu_torch.models.opt import (
    OPTConfig,
    OPTForCausalLM,
    greedy_decode,
    greedy_prefill,
    load_jax_params,
)
from dmx_compressor_tpu_torch.nn.core import DmxModule
from dmx_compressor_tpu_torch.ops import compress as tcompress
from dmx_compressor_tpu_torch.ops.bfp_linear import sbfp_tensor_cores
from dmx_compressor_tpu_torch.ops.compress import (
    SBFP12_16,
    PackedBFPLinear,
    PackedSBFPLinear,
    build_baseline_mode,
    build_sbfp_mode,
    build_weights_mode,
)
from test_torch_opt import B, CAP, T, flat_params, jgreedy, prompt

torch.set_num_threads(2)

STEPS = 6  # greedy tokens: the prefill's, then STEPS - 1 decode steps
LOGIT_TOL = 1e-3
L = OPTConfig.tiny().num_hidden_layers


@pytest.fixture(autouse=True)
def _restore_port_inference_mode():
    prev = DmxModule.inference_mode
    yield
    DmxModule.inference_mode = prev


def run_jax(jm, caches, ids):
    """Greedy prefill + STEPS - 1 decode steps; (every step's last-position
    logits [STEPS, B, V], tokens [B, STEPS])."""
    lg = jm(jnp.asarray(ids), caches=caches, position_offset=0)
    rows, toks = [lg[:, -1]], [jgreedy(lg[:, -1])]
    for i in range(STEPS - 1):
        lg = jm(toks[-1][:, None], caches=caches, position_offset=T + i)
        rows.append(lg[:, -1])
        toks.append(jgreedy(lg[:, -1]))
    return np.stack([np.asarray(r) for r in rows]), np.stack([np.asarray(t) for t in toks], 1)


def run_port(tm, caches, ids):
    logits, tok = greedy_prefill(tm, caches, torch.from_numpy(ids))
    toks, rows = greedy_decode(tm, caches, tok, T, STEPS - 1)
    return (torch.cat([logits[:, -1][None], rows]).numpy(),
            torch.cat([tok[:, None], toks], 1).numpy())


def assert_same_run(jrows, jtoks, trows, ttoks):
    top2 = np.sort(jrows, axis=-1)[..., -2:]
    margins = top2[..., 1] - top2[..., 0]
    assert margins.min() > LOGIT_TOL, f"near-tie in the JAX run: {margins.min()}"
    np.testing.assert_allclose(trows, jrows, atol=LOGIT_TOL, rtol=0)
    assert ttoks.shape == (B, STEPS)
    np.testing.assert_array_equal(ttoks, jtoks)


# ---------------------------------------------------------------------------
# the SBFP leg
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def sbfp_pair():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("DMX_DECODE_FUSED", "1")
        jm = JOPT(JOPTConfig.tiny(), rngs=nnx.Rngs(3))
        params = flat_params(jm)
        jdm = JDmxModel.from_raw(jm)
        jdm.configure(None, JDmxConfigRule(module_types=(jdmxnn.Linear,),
                                           module_config=dict(weight_storage_format=SBFP12_16)))
        j_compress(jdm)
    ids = prompt()
    jlogits = np.asarray(jm(jnp.asarray(ids), caches=jm.init_cache(B, CAP, quantized=True),
                            position_offset=0))
    jrows, jtoks = run_jax(jm, jm.init_cache(B, CAP, quantized=True), ids)

    prev = DmxModule.inference_mode
    tm = OPTForCausalLM(OPTConfig.tiny(), device="cpu")
    load_jax_params(tm, params)
    build_sbfp_mode(tm)
    with torch.no_grad():
        tlogits = tm(torch.from_numpy(ids), caches=tm.init_cache(B, CAP, quantized=True,
                                                                 device="cpu")).numpy()
    trows, ttoks = run_port(tm, tm.init_cache(B, CAP, quantized=True, device="cpu"), ids)
    DmxModule.inference_mode = prev
    return dict(jm=jm, tm=tm, jlogits=jlogits, tlogits=tlogits, jrows=jrows, jtoks=jtoks,
                trows=trows, ttoks=ttoks)


def _sbfp_modules(jm, tm):
    for jl, tl in zip(jm.model.decoder.layers, tm.model.decoder.layers):
        for name in ("q_proj", "k_proj", "v_proj", "out_proj"):
            yield getattr(jl.self_attn, name), getattr(tl.self_attn, name)
        yield jl.fc1, tl.fc1
        yield jl.fc2, tl.fc2
    yield jm.lm_head, tm.lm_head


def test_sbfp_payloads_equal_bit_for_bit(sbfp_pair):
    n = 0
    for jp, tp in _sbfp_modules(sbfp_pair["jm"], sbfp_pair["tm"]):
        assert isinstance(tp, PackedSBFPLinear)
        assert jp.weight_bf16 is None  # DMX_DECODE_FUSED keeps the payload
        np.testing.assert_array_equal(tp.weight_nibbles.numpy(),
                                      np.asarray(jp.weight_nibbles.get_value()))
        np.testing.assert_array_equal(tp.weight_block_scale.numpy().view(np.uint32),
                                      np.asarray(jp.weight_block_scale.get_value()).view(np.uint32))
        if jp.bias is not None:
            np.testing.assert_array_equal(tp.bias.detach().numpy().view(np.uint32),
                                          np.asarray(jp.bias.get_value()).view(np.uint32))
        n += 1
    assert n == 6 * L + 1
    tm = sbfp_pair["tm"]
    # SBFP q/k/v stay three projections (merge_parallel_linears is BFP-only),
    # the embedding stays f32 and the routing is frozen transparent
    assert all(l.self_attn.qkv_merged is None for l in tm.model.decoder.layers)
    assert all(l.self_attn.sdpa_is_transparent is True for l in tm.model.decoder.layers)
    assert not any(isinstance(m, PackedBFPLinear) for m in tm.modules())
    assert tm.model.decoder.embed_tokens.weight.dtype == torch.float32


def test_sbfp_prefill_logits_match(sbfp_pair):
    np.testing.assert_allclose(sbfp_pair["tlogits"], sbfp_pair["jlogits"], atol=LOGIT_TOL, rtol=0)


def test_sbfp_greedy_decode_matches(sbfp_pair):
    p = sbfp_pair
    assert_same_run(p["jrows"], p["jtoks"], p["trows"], p["ttoks"])


@pytest.mark.parametrize("fmt", ["SBFP<XP[4,0](CSN)><FP[0|4|5,16](FN)>{16}",
                                 "SBFP<XP[4,0](CSN)><FP[0|4|4,16](FN)>{8}"])
def test_other_sbfp_formats_build_and_serve_as_in_jax(fmt):
    """compress_for_inference packs SBFP weight storage of a 5-bit scale, or
    of a block of 8, as the JAX package does (its dequantized weight is not
    exact in bf16, or its block no multiple of 16: B5's f32 GEMM on the
    card), and the model then serves the same logits and greedy tokens as
    the JAX model built the same way."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("DMX_DECODE_FUSED", "1")
        jm = JOPT(JOPTConfig.tiny(), rngs=nnx.Rngs(5))
        params = flat_params(jm)
        jdm = JDmxModel.from_raw(jm)
        jdm.configure(None, JDmxConfigRule(module_types=(jdmxnn.Linear,),
                                           module_config=dict(weight_storage_format=fmt)))
        j_count = j_compress(jdm)
    ids = prompt()
    jrows, jtoks = run_jax(jm, jm.init_cache(B, CAP, quantized=True), ids)

    tm = OPTForCausalLM(OPTConfig.tiny(), device="cpu")
    load_jax_params(tm, params)
    tdm = TDmxModel.from_raw(tm)
    tdm.configure(None, TDmxConfigRule(module_types=(tdmxnn.Linear,),
                                       module_config=dict(weight_storage_format=fmt)))
    assert tcompress.compress_for_inference(tdm) == j_count == 6 * L + 1
    tcompress.set_inference_mode(True)
    packed = [tp for _, tp in _sbfp_modules(jm, tm)]
    assert all(isinstance(p, PackedSBFPLinear) and not sbfp_tensor_cores(p.packed, p.in_features)
               for p in packed)
    for jp, tp in _sbfp_modules(jm, tm):
        np.testing.assert_array_equal(tp.weight_nibbles.numpy(),
                                      np.asarray(jp.weight_nibbles.get_value()))
        np.testing.assert_array_equal(tp.weight_block_scale.numpy().view(np.uint32),
                                      np.asarray(jp.weight_block_scale.get_value()).view(np.uint32))
    trows, ttoks = run_port(tm, tm.init_cache(B, CAP, quantized=True, device="cpu"), ids)
    assert_same_run(jrows, jtoks, trows, ttoks)


# ---------------------------------------------------------------------------
# the fp32 baseline leg
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("jax_kernel", [False, True])
def test_baseline_leg_matches_jax(monkeypatch, jax_kernel):
    """BASELINE Dmx models with an f32 cache: prefill, then STEPS - 1 decode
    steps.  With ``jax_kernel`` the JAX side's flash-decode gate is forced on
    and its kernel runs in Pallas interpret mode (test_flash_decode.py:114-141)."""
    jm = JOPT(JOPTConfig.tiny(), rngs=nnx.Rngs(7))
    tm = OPTForCausalLM(OPTConfig.tiny(), device="cpu")
    load_jax_params(tm, flat_params(jm))
    JDmxModel.from_raw(jm).to_baseline_mode()
    build_baseline_mode(tm)
    calls = []
    if jax_kernel:
        orig = jfd.flash_decode

        def spy(*a, **kw):
            calls.append(1)
            return orig(*a, use_pallas=True, interpret=True, **kw)

        monkeypatch.setattr(jfd, "flash_decode_viable",
                            lambda S, block_k=128, kind="fp": S % min(block_k, S) == 0)
        monkeypatch.setattr(jfd, "flash_decode", spy)
    ids = prompt()
    jrows, jtoks = run_jax(jm, jm.init_cache(B, CAP), ids)
    assert len(calls) == (L * (STEPS - 1) if jax_kernel else 0)
    trows, ttoks = run_port(tm, tm.init_cache(B, CAP, device="cpu"), ids)
    assert_same_run(jrows, jtoks, trows, ttoks)
    assert all(l.self_attn.sdpa_is_transparent is True for l in tm.model.decoder.layers)
    assert not any(isinstance(m, (PackedBFPLinear, PackedSBFPLinear)) for m in tm.modules())


# ---------------------------------------------------------------------------
# routing: which wrapper each path calls, and how often
# ---------------------------------------------------------------------------

WRAPPERS = {
    "bfp_linear": tcompress, "sbfp_linear": tcompress, "flash_attention": topt,
    "flash_decode": topt, "flash_decode_int8": topt,
}


def spy_wrappers(monkeypatch):
    counts = dict.fromkeys(WRAPPERS, 0)
    for name, mod in WRAPPERS.items():
        def wrapped(*a, _name=name, _fn=getattr(mod, name), **kw):
            counts[_name] += 1
            return _fn(*a, **kw)

        monkeypatch.setattr(mod, name, wrapped)
    return counts


@pytest.mark.parametrize("mode", ["weights", "sbfp", "baseline"])
def test_each_path_calls_its_wrappers(monkeypatch, mode):
    build = {"weights": build_weights_mode, "sbfp": build_sbfp_mode,
             "baseline": build_baseline_mode}[mode]
    linear = {"weights": ("bfp_linear", 4 * L + 1), "sbfp": ("sbfp_linear", 6 * L + 1),
              "baseline": (None, 0)}[mode]
    decode = "flash_decode" if mode == "baseline" else "flash_decode_int8"
    tm = OPTForCausalLM(OPTConfig.tiny(), device="cpu", seed=1)
    build(tm)
    caches = tm.init_cache(B, CAP, quantized=mode != "baseline", device="cpu")
    counts = spy_wrappers(monkeypatch)
    _, tok = greedy_prefill(tm, caches, torch.from_numpy(prompt()))
    want = dict.fromkeys(WRAPPERS, 0)
    want["flash_attention"] = L
    if linear[0]:
        want[linear[0]] = linear[1]
    assert counts == want
    greedy_decode(tm, caches, tok, T, 3)
    want[decode] = 3 * L
    if linear[0]:
        want[linear[0]] += 3 * linear[1]
    assert counts == want


def test_non_transparent_sdpa_keeps_the_modular_path(monkeypatch):
    """A cast on the SDPA's query makes it non-transparent: an f32-cache
    decode step then runs the compound SDPA, not B4, and still matches JAX."""
    jm = JOPT(JOPTConfig.tiny(), rngs=nnx.Rngs(7))
    tm = OPTForCausalLM(OPTConfig.tiny(), device="cpu")
    load_jax_params(tm, flat_params(jm))
    jdm = JDmxModel.from_raw(jm).to_baseline_mode()
    tdm = build_baseline_mode(tm)
    cfg = {f"model.decoder.layers.{i}.self_attn.sdpa": dict(
        input_formats=["FP[1|5|10,15](FN)", "SAME", "SAME", "SAME"]) for i in range(L)}
    jdm.configure(cfg)
    tdm.configure(cfg)
    for layer in tm.model.decoder.layers:
        layer.self_attn.freeze_routing()
        assert layer.self_attn.sdpa_is_transparent is False
    counts = spy_wrappers(monkeypatch)
    ids = prompt()
    jrows, jtoks = run_jax(jm, jm.init_cache(B, CAP), ids)
    trows, ttoks = run_port(tm, tm.init_cache(B, CAP, device="cpu"), ids)
    assert counts == dict.fromkeys(WRAPPERS, 0)
    assert_same_run(jrows, jtoks, trows, ttoks)
