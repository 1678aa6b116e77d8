"""The port's top-level API against the JAX package's, on the CPU: the
``format`` and ``default_approx`` namespaces, the names still to port, the
new presets' casts, the FP8 and SBFP_WEIGHT_STORAGE rules on tiny OPT and
Llama models, and ``fold_weights_and_biases``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

import dmx_compressor_tpu as jdmx
import dmx_compressor_tpu_torch as tdmx
from dmx_compressor_tpu.modeling.model import DmxModel as JDmxModel
from dmx_compressor_tpu.models.llama import LlamaConfig as JLlamaConfig
from dmx_compressor_tpu.models.llama import LlamaForCausalLM as JLlama
from dmx_compressor_tpu.models.opt import OPTConfig as JOPTConfig
from dmx_compressor_tpu.models.opt import OPTForCausalLM as JOPT
from dmx_compressor_tpu.nn import modules as jnnm
from dmx_compressor_tpu.nn.core import DmxModule as JDmxModule
from dmx_compressor_tpu.ops.compress import compress_for_inference as j_compress
from dmx_compressor_tpu.ops.compress import set_inference_mode as j_set_inference_mode

from dmx_compressor_tpu_torch.modeling.model import DmxModel
from dmx_compressor_tpu_torch.models import opt as topt
from dmx_compressor_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
from dmx_compressor_tpu_torch.models.shared import greedy_decode, greedy_prefill, load_jax_params
from dmx_compressor_tpu_torch.nn import modules as tnnm
from dmx_compressor_tpu_torch.nn.core import DmxModule
from dmx_compressor_tpu_torch.numerics.format import Same
from dmx_compressor_tpu_torch.ops.compress import (
    SBFP12_16,
    PackedBFPLinear,
    compress_for_inference,
    set_inference_mode,
)
from test_torch_opt import flat_params, jgreedy

torch.set_num_threads(2)

# the presets this port added to what it had (the BFP16/24 (SN) family,
# FLOAT16 and the other basics were held by tests/test_torch_numerics.py)
NEW_PRESETS = sorted(
    [f"BFP{p}A_{b}" for p in ("16", "14", "12") for b in (128, 64, 32, 16)]
    + ["SBFP12_16"] + [f"SBFP12_16_{bias}" for bias in range(4, 19)]
    + [f"{n}_{sh}K{b}" for sh, n in (("E4M3", "MXFP8"), ("E5M2", "MXFP8"), ("E2M3", "MXFP6"),
                                      ("E3M2", "MXFP6"), ("E2M1", "MXFP4")) for b in (128, 64, 32)]
    + [f"MXINT{p}_K{b}" for p in (8, 6, 4) for b in (128, 64, 32)])
# what the JAX package's top level has and the port has not: nothing since
# the config / transformation / pipeline classes were ported (each
# subpackage's lacks: tests/test_torch_modeling.py)
MISSING_NAMES = set()
# the module types of the JAX package's rules that the port has no module
# for yet: none since the op zoo's rest (conv, pool, ReLU6, BatchNorm2d,
# GroupNorm, Exp) was ported
MISSING_MODULE_TYPES = set()
B, PROMPT, CAP, STEPS = 2, 8, 32, 6
# FP8 and BASIC with SBFP storage, port vs JAX: FLOAT16 boundaries, a value
# may land one fp16 step apart (LEG_TOL's BASIC figure of
# tests/test_torch_llama.py)
MODE_TOL = 4e-3


@pytest.fixture(autouse=True)
def _restore_inference_mode():
    prev = (DmxModule.inference_mode, JDmxModule.inference_mode)
    yield
    DmxModule.inference_mode, JDmxModule.inference_mode = prev


@pytest.mark.parametrize("ns", ["format", "default_approx"])
def test_namespace_equals_jax_by_shorthand(ns):
    want, got = vars(getattr(jdmx, ns)), vars(getattr(tdmx, ns))
    assert set(got) == set(want)
    for name in want:
        assert repr(got[name]) == repr(want[name]), name


def test_the_names_still_to_port():
    assert set(jdmx.__all__) - set(tdmx.__all__) == MISSING_NAMES
    assert set(tdmx.__all__) <= set(jdmx.__all__)
    assert set(vars(tdmx.config_rules)) == set(vars(jdmx.config_rules))

    def types(rules):
        return {t.__name__ for rule in rules for t in rule.module_types}

    for name in vars(jdmx.config_rules):
        want = types(getattr(jdmx.config_rules, name))
        got = types(getattr(tdmx.config_rules, name))
        assert got <= want and want - got <= MISSING_MODULE_TYPES, name
        for mod in want - got:
            assert not hasattr(tnnm, mod) and hasattr(jnnm, mod)


@pytest.mark.parametrize("rules", ["BASELINE", "FP8", "BASIC", "SBFP_WEIGHT_STORAGE"])
def test_rules_configure_what_jax_s_configure(rules):
    """Rule for rule, on the module types both packages have: the same
    types and the same module configs (formats by shorthand)."""
    def norm(rule, ported):
        names = tuple(sorted(t.__name__ for t in rule.module_types
                             if t.__name__ in ported))
        return names, {k: repr(v) for k, v in rule.module_config.items()}

    ported = {n for n in dir(tnnm) if not n.startswith("_")}
    want = [norm(r, ported) for r in getattr(jdmx.config_rules, rules)]
    got = [norm(r, ported) for r in getattr(tdmx.config_rules, rules)]
    assert got == [w for w in want if w[0]]


def test_sbfp12_16_preset_is_jax_s_not_the_bench_s():
    """format.SBFP12_16 is the JAX package's preset (scale bias 7); the
    serving recipe's SBFP12_16 is bench.py's (scale bias 16), format
    .SBFP12_16_16 here."""
    assert repr(tdmx.format.SBFP12_16) == "SBFP<XP[4,0](CSN)><FP[0|4|4,7](FN)>{16}"
    assert repr(tdmx.format.SBFP12_16_16) == SBFP12_16


@pytest.mark.parametrize("name", NEW_PRESETS)
def test_new_preset_casts_bit_for_bit(name):
    """A seeded normal-range tensor (no f32 subnormal: XLA on the CPU
    flushes them in arithmetic) cast by each new preset along the last axis,
    bit for bit with the JAX package."""
    rs = np.random.default_rng(5)
    x = (rs.standard_normal((6, 256)) * np.exp(rs.uniform(-4, 4, (6, 1)))).astype(np.float32)
    got = getattr(tdmx.format, name).cast(torch.from_numpy(x), -1).numpy()
    want = np.asarray(getattr(jdmx.format, name).cast(jnp.asarray(x), -1))
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


def _configure(dm, mode):
    if mode == "fp8":
        return dm.to_fp8_mode()
    return dm.to_basic_mode(sbfp_weight_storage=True)


def _pair(family, mode):
    """The tiny model of ``family`` from the JAX package's seed 7 on both
    sides, configured by ``mode`` ("fp8": ``to_fp8_mode``; "sbfp_storage":
    ``to_basic_mode(sbfp_weight_storage=True)``, then
    ``compress_for_inference``)."""
    if family == "opt":
        jcfg, tcfg = JOPTConfig.tiny(), topt.OPTConfig.tiny()
        jcls, tcls, load = JOPT, topt.OPTForCausalLM, topt.load_jax_params
    else:
        fields = {k: v for k, v in vars(LlamaConfig.tiny()).items() if k != "dtype"}
        jcfg, tcfg = JLlamaConfig(**fields), LlamaConfig(**fields)
        jcls, tcls, load = JLlama, LlamaForCausalLM, load_jax_params
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("DMX_DECODE_FUSED", "1")
        jm = jcls(jcfg, rngs=nnx.Rngs(7))
        params = flat_params(jm)
        jdm = _configure(JDmxModel.from_raw(jm), mode)
        if mode == "sbfp_storage":
            j_compress(jdm)
    tm = tcls(tcfg, device="cpu")
    load(tm, params)
    tdm = _configure(DmxModel.from_raw(tm), mode)
    if mode == "sbfp_storage":
        compress_for_inference(tdm)
    return jm, tm, jcfg.vocab_size


@pytest.mark.parametrize("mode", ["fp8", "sbfp_storage"])
@pytest.mark.parametrize("family", ["opt", "llama"])
def test_mode_leg_matches_jax(family, mode):
    """A prefill and greedy decode steps over an f32 cache: tokens equal to
    the JAX package's (its top-1/top-2 margins above the tolerance), every
    step's logits within MODE_TOL."""
    jm, tm, vocab = _pair(family, mode)
    inference = mode != "fp8"
    j_set_inference_mode(inference)
    set_inference_mode(inference)
    ids = np.random.default_rng(1).integers(0, vocab, (B, PROMPT)).astype(np.int32)
    jc = jm.init_cache(B, CAP)
    prefill = nnx.jit(lambda m, x, c: m(x, caches=c, position_offset=0))
    step = nnx.jit(lambda m, x, c, off: m(x, caches=c, position_offset=off))
    lg = prefill(jm, jnp.asarray(ids), jc)
    rows, toks = [lg[:, -1]], [jgreedy(lg[:, -1])]
    for i in range(STEPS - 1):
        out = step(jm, toks[-1][:, None], jc, jnp.int32(PROMPT + i))
        rows.append(out[:, -1])
        toks.append(jgreedy(out[:, -1]))
    jrows = np.stack([np.asarray(r) for r in rows])
    tc = tm.init_cache(B, CAP, device="cpu")
    tl, tok = greedy_prefill(tm, tc, torch.from_numpy(ids))
    ttoks, trows = greedy_decode(tm, tc, tok, PROMPT, STEPS - 1)
    top2 = np.sort(jrows, axis=-1)[..., -2:]
    assert (top2[..., 1] - top2[..., 0]).min() > MODE_TOL, "a near-tie in the JAX run"
    np.testing.assert_allclose(tl.numpy(), np.asarray(lg), atol=MODE_TOL, rtol=0)
    np.testing.assert_allclose(torch.cat([tl[:, -1][None], trows]).numpy(), jrows,
                               atol=MODE_TOL, rtol=0)
    np.testing.assert_array_equal(torch.cat([tok[:, None], ttoks], 1).numpy(),
                                  np.stack([np.asarray(t) for t in toks], 1))


@pytest.mark.parametrize("family", ["opt", "llama"])
def test_sbfp_storage_packs_the_payloads_jax_packs(family):
    """BASIC with SBFP12_16 storage (scale bias 7): compress_for_inference
    casts each weight through the storage format, then packs BFP16_64; the
    payloads of every packed Linear equal JAX's bit for bit."""
    jm, tm, _ = _pair(family, "sbfp_storage")
    packed = [(n, m) for n, m in tm.named_modules() if isinstance(m, PackedBFPLinear)
              and m.weight_mantissa is not None]
    assert packed
    for name, tp in packed:
        jp = jm
        for part in name.split("."):
            jp = jp[int(part)] if part.isdigit() else getattr(jp, part)
        for f in ("weight_mantissa", "weight_exponent"):
            np.testing.assert_array_equal(getattr(tp, f).numpy(),
                                          np.asarray(getattr(jp, f).get_value()), err_msg=name)


def test_fold_weight_and_bias_matches_jax_bit_for_bit():
    """tests/test_dmx_modules.py's case on both sides: a Linear with BFP16_64
    weights and a BFP32_1 bias, folded; the folded parameters equal JAX's
    bit for bit, the casts SAME, the output as before."""
    rs = np.random.default_rng(3)
    w = rs.standard_normal((8, 64)).astype(np.float32) * 0.2
    b = rs.standard_normal(8).astype(np.float32)
    x = rs.standard_normal((2, 64)).astype(np.float32)
    cfg = dict(weight_format=jdmx.format.BFP16_64, bias_format=jdmx.format.BFP32_1)
    jl = jnnm.Linear(64, 8)
    jl.weight.value, jl.bias.value = jnp.asarray(w), jnp.asarray(b)
    jl.configure(cfg)
    tl = tnnm.Linear(64, 8)
    with torch.no_grad():
        tl.weight.copy_(torch.from_numpy(w))
        tl.bias.copy_(torch.from_numpy(b))
    tl.configure(dict(weight_format=tdmx.format.BFP16_64, bias_format=tdmx.format.BFP32_1))
    before = tl(torch.from_numpy(x)).detach().numpy()
    jbefore = np.asarray(jl(jnp.asarray(x)))
    jl.fold_weight_and_bias()
    tl.fold_weight_and_bias()
    assert isinstance(tl.weight_format, Same) and isinstance(tl.bias_format, Same)
    for got, want in ((tl.weight, jl.weight.value), (tl.bias, jl.bias.value)):
        np.testing.assert_array_equal(got.detach().numpy().view(np.uint32),
                                      np.asarray(want).view(np.uint32))
    after = tl(torch.from_numpy(x)).detach().numpy()
    np.testing.assert_allclose(after, before, atol=1e-6)
    np.testing.assert_allclose(after, np.asarray(jl(jnp.asarray(x))), atol=1e-6)
    np.testing.assert_allclose(before, jbefore, atol=1e-6)


def test_fold_weights_and_biases_of_a_model_matches_jax():
    """DmxModel.fold_weights_and_biases over tiny OPT in BASIC mode with SBFP
    storage: every Linear's weight baked through the storage cast, then the
    BFP16_64 cast, and its bias through BFP32_1, bit for bit with JAX's fold
    of the same model (the head's weight is the token embedding's on both
    sides: it is folded there too), and the logits after the fold within
    MODE_TOL of JAX's."""
    jcfg, tcfg = JOPTConfig.tiny(), topt.OPTConfig.tiny()
    jm = JOPT(jcfg, rngs=nnx.Rngs(2))
    tm = topt.OPTForCausalLM(tcfg, device="cpu")
    topt.load_jax_params(tm, flat_params(jm))
    jdm = JDmxModel.from_raw(jm).to_basic_mode(sbfp_weight_storage=True)
    tdm = DmxModel.from_raw(tm).to_basic_mode(sbfp_weight_storage=True)
    jdm.fold_weights_and_biases()
    tdm.fold_weights_and_biases()
    want = flat_params(jm)
    lins = [(n, m) for n, m in tdm.named_dmx_modules() if isinstance(m, tnnm.Linear)]
    assert len(lins) == 6 * tcfg.num_hidden_layers + 1
    for name, m in lins:
        assert isinstance(m.weight_format, Same) and isinstance(m.weight_storage_format, Same)
        assert m.bias is None or isinstance(m.bias_format, Same)
        for p in ("weight", "bias"):
            if getattr(m, p) is not None:
                np.testing.assert_array_equal(
                    getattr(m, p).detach().numpy().view(np.uint32),
                    want[f"{name}.{p}"].view(np.uint32), err_msg=f"{name}.{p}")
    assert tm.lm_head.weight is tm.model.decoder.embed_tokens.weight
    ids = np.random.default_rng(4).integers(0, jcfg.vocab_size, (1, 8))
    with torch.no_grad():
        got = tm(torch.from_numpy(ids)).numpy()
    np.testing.assert_allclose(got, np.asarray(jm(jnp.asarray(ids))), atol=MODE_TOL, rtol=0)
