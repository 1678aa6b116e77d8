"""The PTQ recipes of the port held against the JAX package on the CPU:
SmoothQuant (static, dynamic, fused, scale format), quantizer calibration,
GPTQ / OBC at two (microblock, block) pairs, SLaNC norms, approximation
tuning, plugins, FLOP counting, where the hooks meet the packed kernels
(a SmoothQuant-calibrated OPT served in weights mode; the fused BASIC step
kept under an idle SmoothQuant and left under a calibrated one) and both
examples at tiny.  Inputs are numpy from seeds; every comparison states its
tolerance.  The JAX side of a packed build runs with ``DMX_DECODE_FUSED=1``
(ROADMAP's parity convention)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch
from flax import nnx

import dmx_compressor_tpu as jdmx
from dmx_compressor_tpu import advanced_recipe as jrec
from dmx_compressor_tpu import layer_reconstruction as jlr
from dmx_compressor_tpu import nn as jdmxnn
from dmx_compressor_tpu.functional.approximate import NoApproximation as JNoApprox
from dmx_compressor_tpu.modeling.hf import do_forward_on as j_do_forward_on
from dmx_compressor_tpu.modeling.model import DmxModel as JDmxModel
from dmx_compressor_tpu.models.opt import OPTConfig as JOPTConfig
from dmx_compressor_tpu.models.opt import OPTForCausalLM as JOPT
from dmx_compressor_tpu.nn.core import DmxModule as JDmxModule
from dmx_compressor_tpu.numerics import observer as jobs
from dmx_compressor_tpu.ops import basic_layer as jbl
from dmx_compressor_tpu.ops.compress import compress_for_inference as j_compress
from dmx_compressor_tpu.plugins import ActivatePlugins as JActivatePlugins
from dmx_compressor_tpu.plugins import PluginBase as JPluginBase

from dmx_compressor_tpu_torch import advanced_recipe as trec
from dmx_compressor_tpu_torch import layer_reconstruction as tlr
from dmx_compressor_tpu_torch import nn as tdmxnn
from dmx_compressor_tpu_torch.examples import model_calibration as tcalib_ex
from dmx_compressor_tpu_torch.examples import opt_int8_smoothquant_kv as tkv_ex
from dmx_compressor_tpu_torch.modeling.model import DmxConfigRule, DmxModel
from dmx_compressor_tpu_torch.models.opt import (
    OPTConfig,
    OPTDecoderLayer,
    OPTForCausalLM,
    greedy_decode,
    greedy_prefill,
    load_jax_params,
)
from dmx_compressor_tpu_torch.nn.core import DmxModule
from dmx_compressor_tpu_torch.numerics import observer as tobs
from dmx_compressor_tpu_torch.ops import basic_layer as tbl
from dmx_compressor_tpu_torch.ops.bfp_pack import bfp_pack
from dmx_compressor_tpu_torch.ops.compress import (
    PackedBFPLinear,
    build_basic_mode,
    compress_for_inference,
    set_inference_mode,
    weights_mode_rules,
)
from dmx_compressor_tpu_torch.plugins import ActivatePlugins, PluginBase
from test_torch_opt import flat_params, jgreedy

torch.set_num_threads(2)

SQ_RTOL = 1e-6  # the scale's pow: XLA's and torch's x ** 0.5 differ by an ulp at ~1 %
# logits of a SmoothQuant-folded packed model: where the scale is an ulp
# apart, a BFP16 mantissa of weight * scale can round one step apart
SQ_LOGIT_TOL = 4e-3
BFP16_64 = "BFP[8|8]{64}(SN)"


def rand(shape, seed=0, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def j(x):
    return np.asarray(x.get_value() if hasattr(x, "get_value") else x)


def linear_pair(n_in=16, n_out=8, seed=0, **config):
    jl = jdmxnn.Linear(n_in, n_out, rngs=nnx.Rngs(seed))
    tl = tdmxnn.Linear(n_in, n_out, device="cpu")
    with torch.no_grad():
        tl.weight.copy_(torch.from_numpy(j(jl.weight)))
        tl.bias.copy_(torch.from_numpy(j(jl.bias)))
    if config:
        jl.configure(config)
        tl.configure(config)
    return jl, tl


def run_both(jl, tl, x):
    with torch.no_grad():
        return tl(torch.from_numpy(x)).numpy(), np.asarray(jl(jnp.asarray(x)))


def outlier_input(n=32, d=16, seed=1):
    x = rand((n, d), seed)
    x[:, 0] *= 100.0  # an outlier channel
    return x


# ---------------------------------------------------------------------------
# SmoothQuant
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("fuse", [False, True])
@pytest.mark.parametrize("scale_format", [None, "FP[1|5|10,15](FN)"])
def test_static_smoothquant_matches_jax(fuse, scale_format):
    """Two calibration batches: the maxabs state bit for bit, the scale at
    ``SQ_RTOL``; after calibration the output within 1e-5 of JAX's (f32
    matmul order), fused weights at ``SQ_RTOL``; the product kept within
    2e-3 of the unscaled one."""
    config = {} if scale_format is None else dict(smoothquant_scale_format=scale_format)
    jl, tl = linear_pair(**config)
    hp = trec.DmxModuleSmoothQuantHyperparams(migration_strength=0.5, fuse_to_weight=fuse)
    jhp = jrec.DmxModuleSmoothQuantHyperparams(migration_strength=0.5, fuse_to_weight=fuse)
    xs = [outlier_input(seed=s) for s in (1, 2)]
    with tl.calibrating_smoothquant(hp), jl.calibrating_smoothquant(jhp):
        for x in xs:
            run_both(jl, tl, x)
    sq, jsq = tl.smoothquant, jl.smoothquant
    assert sq.enabled and not sq.calibrating and sq.fused_to_weight == fuse
    np.testing.assert_array_equal(sq.input_maxabs.numpy(), j(jsq.a_maxabs))
    np.testing.assert_array_equal(sq.weight_maxabs.numpy(), j(jsq.b_maxabs))
    np.testing.assert_allclose(sq.scale.numpy(), j(jsq.scale), rtol=SQ_RTOL)
    assert sq.scale.numpy()[0] > sq.scale.numpy()[1:].max()
    if fuse:
        np.testing.assert_allclose(tl.weight.detach().numpy(), j(jl.weight), rtol=SQ_RTOL)
    if scale_format is not None:
        assert repr(tl.dmx_config()["smoothquant_scale_format"]) == scale_format
        np.testing.assert_array_equal(sq.scale.numpy().astype(np.float16).astype(np.float32),
                                      sq.scale.numpy())
    got, want = run_both(jl, tl, xs[0])
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    sq.disable()
    ref, _ = run_both(jl, tl, xs[0])
    if not fuse:
        np.testing.assert_allclose(got, ref, rtol=2e-3, atol=2e-3)
    if fuse:  # a fused scale can be neither dynamic nor calibrated again
        with pytest.raises(RuntimeError):
            sq.set_dynamic(True)
        with pytest.raises(RuntimeError):
            tl.enable_smoothquant_calib(True, hp)


def test_dynamic_smoothquant_matches_jax():
    """A dynamic SmoothQuant takes each batch's own maxabs: every output and
    scale as JAX's."""
    jl, tl = linear_pair()
    for m in (jl, tl):
        m.init_smoothquant(dynamic=True)
        m.smoothquant.enable()
    for seed in (1, 2, 3):
        got, want = run_both(jl, tl, outlier_input(seed=seed) * seed)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
        np.testing.assert_array_equal(tl.smoothquant.input_maxabs.numpy(),
                                      j(jl.smoothquant.a_maxabs))
        np.testing.assert_allclose(tl.smoothquant.scale.numpy(), j(jl.smoothquant.scale),
                                   rtol=SQ_RTOL)


def test_generic_smoothquant_a_b_matches_jax():
    from dmx_compressor_tpu.numerics.smoothquant import SmoothQuant as JSQ

    from dmx_compressor_tpu_torch.numerics.smoothquant import SmoothQuant as TSQ

    a, b = rand((6, 10), 1, 4.0), rand((10, 3), 2)
    tsq, jsq = TSQ(-1, 0, migration_strength=0.3), JSQ(-1, 0, migration_strength=0.3)
    for s in (tsq, jsq):
        s.enable()
    ta, tb = tsq(torch.from_numpy(a), torch.from_numpy(b))
    ja, jb = jsq(jnp.asarray(a), jnp.asarray(b))
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), rtol=1e-6)
    np.testing.assert_allclose(tb.numpy(), np.asarray(jb), rtol=1e-6)
    np.testing.assert_allclose((ta @ tb).numpy(), a @ b, rtol=1e-4, atol=1e-4)
    with pytest.raises(ValueError):
        tsq.set_migration_strength(1.5)


# ---------------------------------------------------------------------------
# quantizer calibration
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("observer", ["minmax", "histogram"])
def test_input_calibration_for_all_linears_matches_jax(observer):
    """Every Linear's INT8 input cast calibrated through the recipe over a
    tiny OPT: qparams bit for bit, then fake-quantized logits within 1e-4."""
    tobs_cls = {"minmax": tobs.MinMaxObserver, "histogram": tobs.HistogramObserver}[observer]
    jobs_cls = {"minmax": jobs.MinMaxObserver, "histogram": jobs.HistogramObserver}[observer]
    jm = JOPT(JOPTConfig.tiny(), rngs=nnx.Rngs(0))
    tm = OPTForCausalLM(OPTConfig.tiny(), device="cpu")
    load_jax_params(tm, flat_params(jm))
    config = dict(input_formats=["XP[8,0](CSN)"])
    jdm = JDmxModel.from_raw(jm)
    jdm.configure(None, jdmx.DmxConfigRule(module_types=(jdmxnn.Linear,), module_config=config))
    tdm = DmxModel.from_raw(tm)
    tdm.configure(None, DmxConfigRule(module_types=(tdmxnn.Linear,), module_config=config))
    ids = np.random.default_rng(2).integers(0, JOPTConfig.tiny().vocab_size, (2, 16))
    with trec.DmxQuantizerCalibrationRecipe(trec.input_calibration_for_all_linears(
            observer_cls=tobs_cls)).applied_to(tdm), torch.no_grad():
        tdm(torch.from_numpy(ids))
    with jrec.DmxQuantizerCalibrationRecipe(jrec.input_calibration_for_all_linears(
            observer_cls=jobs_cls)).applied_to(jdm):
        jdm(jnp.asarray(ids))
    jmods = dict(jdm.named_dmx_modules())
    n = 0
    for name, m in tdm.named_dmx_modules():
        if isinstance(m, tdmxnn.Linear):
            tc, jc = m.input_casts["input_cast"], jmods[name].input_casts["input_cast"]
            assert tc.fake_quant_enabled and not tc.observer_enabled
            np.testing.assert_allclose(tc.scale.numpy(), j(jc.scale), rtol=1e-6)
            np.testing.assert_array_equal(tc.zero_point.numpy(), j(jc.zero_point))
            n += 1
    assert n == 6 * JOPTConfig.tiny().num_hidden_layers + 1
    # each calibrated Linear on one input: within f32 summation order
    x = rand((2, 16, OPTConfig.tiny().hidden_size), 5)
    for name in ("model.decoder.layers.0.self_attn.q_proj", "model.decoder.layers.1.fc1",
                 "lm_head"):
        m = dict(tdm.named_dmx_modules())[name]
        with torch.no_grad():
            np.testing.assert_allclose(m(torch.from_numpy(x)).numpy(),
                                       np.asarray(jmods[name](jnp.asarray(x))), atol=1e-5)
    # end to end, an activation an ulp apart (f32 sums in another order) can
    # round to the next INT8 step, and such steps compound over the layers:
    # held at 0.1 (max) and 1e-2 (mean) on logits of magnitude ~3
    with torch.no_grad():
        got = tdm(torch.from_numpy(ids)).numpy()
    want = np.asarray(jdm(jnp.asarray(ids)))
    assert np.abs(got - want).max() < 0.1 and np.abs(got - want).mean() < 1e-2


# ---------------------------------------------------------------------------
# GPTQ / OBC
# ---------------------------------------------------------------------------


def bfp_steps(w, precision=8, block=64):
    """Each weight's BFP quantization step: 2^(exponent + 2 - precision)."""
    p = bfp_pack(torch.from_numpy(w), precision, block)
    e = p.exponent.to(torch.float32).repeat_interleave(block, dim=-1)
    return torch.exp2(e + 2 - precision).numpy()


@pytest.mark.parametrize("microblock,block", [(64, 128), (128, 128)])
def test_gptq_matches_jax(microblock, block):
    """GPTQ of a 256 -> 48 Linear at BFP16_64 over four batches.  With JAX's
    Hessian carried across, the blocked float64 update equals JAX's at all
    but a share of weights that LAPACK's and torch's factorizations move one
    BFP step (at most 0.5 % differ, none by more than one step); from the
    port's own Hessian (f32 sums in another order) at most 2 %.  The weights
    stay on BFP16_64's grid, and beat round-to-nearest's output error."""
    xs = [rand((32, 256), 10 + i) for i in range(4)]
    results = {}
    for carry in (True, False):
        jl, tl = linear_pair(256, 48, seed=3, weight_format=BFP16_64)
        w0 = tl.weight.detach().numpy().copy()
        y_rtn = [run_both(jl, tl, x)[0] for x in xs]
        hp = trec.DmxModuleGPTQHyperparams(microblock_size=microblock, block_size=block)
        jhp = jrec.DmxModuleGPTQHyperparams(microblock_size=microblock, block_size=block)
        with tl.optimal_brain_compressing(hp), jl.optimal_brain_compressing(jhp):
            for x in xs:
                run_both(jl, tl, x)
            np.testing.assert_allclose(tl.obc.H.numpy(), np.asarray(jl.obc.H), rtol=1e-5,
                                       atol=1e-5)
            if carry:
                tl.obc.H = torch.from_numpy(np.asarray(jl.obc.H))
        tw, jw = tl.weight.detach().numpy(), j(jl.weight)
        diff = tw != jw
        assert diff.mean() <= (0.005 if carry else 0.02), diff.mean()
        assert (np.abs(tw - jw) <= bfp_steps(jw)).all()
        np.testing.assert_array_equal(bfp_pack_round_trip(tw), tw)
        results[carry] = diff.mean()
        y_true = [x @ w0.T + tl.bias.detach().numpy() for x in xs]
        y_gptq = [run_both(jl, tl, x)[0] for x in xs]
        mse = lambda ys: np.mean([(a - b) ** 2 for a, b in zip(y_true, ys)])  # noqa: E731
        assert mse(y_gptq) <= mse(y_rtn) * 1.05
    assert tl.obc is None and tl.weight_cast.fake_quant_enabled


def bfp_pack_round_trip(w):
    from dmx_compressor_tpu_torch.ops.bfp_pack import bfp_unpack

    return bfp_unpack(bfp_pack(torch.from_numpy(w), 8, 64)).numpy()


def test_gptq_refuses_microblocks_off_the_format_block():
    _, tl = linear_pair(256, 48, weight_format=BFP16_64)
    with pytest.raises(ValueError):
        with tl.optimal_brain_compressing(trec.DmxModuleGPTQHyperparams(microblock_size=32)):
            with torch.no_grad():
                tl(torch.from_numpy(rand((4, 256))))


def test_gptq_over_a_conv_unfolds_its_input():
    """A Conv2d's Hessian comes from its im2col patches, as JAX's."""
    from dmx_compressor_tpu.nn import Conv2d as JConv2d

    jc = JConv2d(4, 8, 3, padding=1, rngs=nnx.Rngs(0))
    tc = tdmxnn.Conv2d(4, 8, 3, padding=1, device="cpu")
    with torch.no_grad():
        tc.weight.copy_(torch.from_numpy(j(jc.weight)))
        tc.bias.copy_(torch.from_numpy(j(jc.bias)))
    x = rand((2, 4, 6, 6), 4)
    tobc, jobc = tlr.OptimalBrainCompressor(tc), jlr.OptimalBrainCompressor(jc)
    tobc.measure_hessian(torch.from_numpy(x))
    jobc.measure_hessian(jnp.asarray(x))
    np.testing.assert_allclose(tobc.H.numpy(), np.asarray(jobc.H), rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# SLaNC, approximation tuning, plugins, FLOPs
# ---------------------------------------------------------------------------


def _w(shape, seed):
    class W:
        pass

    w = W()
    w.weight = torch.from_numpy(rand(shape, seed))
    jw = W()
    jw.weight = jnp.asarray(rand(shape, seed))
    return w, jw


@pytest.mark.parametrize("position,mlp_type", [("post_attn", "standard"),
                                               ("post_mlp", "standard"),
                                               ("post_mlp", "llama"), ("first", "standard")])
def test_slanc_norms_match_jax(position, mlp_type):
    """The three positions' analytic norms (GQA's v_proj tiled, a llama MLP)
    within rtol 1e-5 (spectral norms by another SVD)."""
    shapes = dict(prev_ln_weight=(32,), v_proj=(16, 32), o_proj=(32, 32), fc1=(64, 32),
                  fc2=(32, 64), gate_proj=(48, 32), up_proj=(48, 32), down_proj=(32, 48))
    tkw, jkw = {}, {}
    for i, (k, shp) in enumerate(shapes.items()):
        tkw[k], jkw[k] = _w(shp, i)
    tn = tlr.compute_slanc_norm(trec.DmxModuleSLaNCHyperparams(position, mlp_type, **tkw))
    jn = jlr.compute_slanc_norm(jrec.DmxModuleSLaNCHyperparams(position, mlp_type, **jkw))
    np.testing.assert_allclose(tn, jn, rtol=1e-5)


def test_slanc_recipe_sets_the_surrogate_norm():
    ln = tdmxnn.LayerNorm(16)
    ln.configure(dict(approximation_function="LAYER_NORM[vsimd]{}()"))
    shared = ln.approximator.function
    hp = trec.DmxModuleSLaNCHyperparams(position="post_mlp", prev_ln_weight=tdmxnn.RMSNorm(16),
                                        fc1=tdmxnn.Linear(16, 32), fc2=tdmxnn.Linear(32, 16))
    with trec.DmxSLaNCRecipe(lambda m: {ln: hp}).applied_to(ln):
        pass
    norm = ln.approximator.function.extra_params["norm"]
    assert ln.approximator.function is not shared and "norm" not in shared.extra_params
    np.testing.assert_allclose(norm, 1.0 / tlr.compute_slanc_norm(hp), rtol=1e-12)
    assert torch.isfinite(ln(torch.from_numpy(rand((4, 16))))).all()


class _Quadratic:
    """A stand-in module whose approximation error is a known function of
    the tuned parameters: the search alone, without surrogate arithmetic."""

    def __init__(self, array):
        from types import SimpleNamespace

        self.aft, self.array, self.calls = None, array, []
        self.approximator = SimpleNamespace(function=SimpleNamespace(extra_params={}))

    def __call__(self, x):
        p = self.approximator.function.extra_params
        self.calls.append((p["a"], p["b"]))
        self.approximation_error = self.array([(p["a"] - 0.37) * 3.0, p["b"] ** 2 - 0.2])


def test_aft_search_draws_jax_s_candidates():
    """The seeded search (the JAX package's numpy stream, the midpoint, then
    uniform exploration, then Gaussian refinement): every candidate and the
    tuned parameters exactly JAX's."""
    tmod, jmod = _Quadratic(torch.tensor), _Quadratic(jnp.asarray)
    space = [("a", 0.0, 1.0), ("b", -1.0, 2.0)]
    tlr.ApproximationFunctionTuner(tmod, space).optimize(None)
    jlr.ApproximationFunctionTuner(jmod, space).optimize(None)
    assert len(tmod.calls) == 20 and tmod.calls == jmod.calls
    assert tmod.approximator.function.extra_params == jmod.approximator.function.extra_params


def test_aft_tunes_a_surrogate_as_jax_does():
    """A vsimd softmax's ``max_adjust`` tuned over [0, 1] on both sides.  Its
    approximation error is an MSE of ~1e-12 that the two packages' surrogate
    arithmetic moves by ~1 %, so the refinement may settle on a neighbouring
    candidate: the tuned values within 0.05, each one's error within 5 % of
    the other's."""
    fn = "SOFTMAX[vsimd]{input_clamp=-100}(max_adjust=0.5)"
    tm, jm = tdmxnn.Softmax(dim=-1), jdmxnn.Softmax(dim=-1)
    tm.configure(dict(approximation_function=fn))
    jm.configure(dict(approximation_function=fn))
    hp = trec.DmxModuleApproximationFunctionTuningHyperparams([("max_adjust", 0.0, 1.0)])
    jhp = jrec.DmxModuleApproximationFunctionTuningHyperparams([("max_adjust", 0.0, 1.0)])
    x = rand((8, 32), 6, 3.0)
    with trec.DmxApproximationFunctionTuningRecipe(lambda m: {tm: hp}).applied_to(tm):
        with torch.no_grad():
            tm(torch.from_numpy(x))
    with jm.tuning_approximation_function(jhp):
        jm(jnp.asarray(x))
    assert tm.aft is None
    got = tm.approximator.function.extra_params["max_adjust"]
    want = jm.approximator.function.extra_params["max_adjust"]
    assert abs(got - want) < 0.05 and got != 0.5
    with torch.no_grad():
        tm(torch.from_numpy(x))
    jm(jnp.asarray(x))
    np.testing.assert_allclose(np.mean(tm.approximation_error.numpy() ** 2),
                               np.mean(np.asarray(jm.approximation_error) ** 2), rtol=5e-2)


def test_standalone_approximator_keeps_jax_s_error():
    """``Approximator``: the surrogate's output and its error against the
    input it replaces, as the JAX package's (f32 surrogate arithmetic in
    another order: 1e-6)."""
    from dmx_compressor_tpu.functional.approximate import Approximator as JApproximator

    from dmx_compressor_tpu_torch.functional import Approximator

    x = rand((4, 64), 8, 2.0)
    fn = "SOFTMAX[vsimd]{input_clamp=-100}(max_adjust=0.5)"
    t, jj = Approximator(fn), JApproximator(fn)
    np.testing.assert_allclose(t(torch.from_numpy(x)).numpy(), np.asarray(jj(jnp.asarray(x))),
                               atol=1e-6, rtol=0)
    np.testing.assert_allclose(t.approximation_error.numpy(), np.asarray(jj.approximation_error),
                               atol=1e-6, rtol=0)
    assert Approximator().approximation_error is None


def tiny_opt_pair(seed=0):
    jm = JOPT(JOPTConfig.tiny(), rngs=nnx.Rngs(seed))
    tm = OPTForCausalLM(OPTConfig.tiny(), device="cpu")
    load_jax_params(tm, flat_params(jm))
    return jm, tm


def test_plugins_see_every_layer_as_jax_s_do():
    """An ActivatePlugins over a tiny OPT: the same call log (module types in
    call order, a plugin's own Dmx calls not logged), model processing on
    activation, nothing after exit."""

    def make(base):
        class Log(base):
            def __init__(self):
                self.calls, self.models = [], 0

            def process_model(self, model):
                self.models += 1

            def process_layer(self, data):
                self.calls.append(type(data.mod).__name__)
                assert data.output_after_cast is not None and data.mod is not None

        return Log()

    jm, tm = tiny_opt_pair()
    jdm, tdm = JDmxModel.from_raw(jm), DmxModel.from_raw(tm)
    ids = np.random.default_rng(3).integers(0, JOPTConfig.tiny().vocab_size, (2, 8))
    tp, jp = make(PluginBase), make(JPluginBase)
    with ActivatePlugins(tp).applied_to(tdm), torch.no_grad():
        tdm(torch.from_numpy(ids))
    with JActivatePlugins(jp).applied_to(jdm):
        jdm(jnp.asarray(ids))
    assert tp.calls == jp.calls and tp.models == jp.models == 1 and len(tp.calls) > 20
    assert DmxModule.plugins == [] and JDmxModule.plugins == []
    with torch.no_grad():
        tdm(torch.from_numpy(ids))
    assert len(tp.calls) == len(jp.calls)


def test_counting_flops_matches_jax():
    jm, tm = tiny_opt_pair()
    jdm, tdm = JDmxModel.from_raw(jm), DmxModel.from_raw(tm)
    ids = np.random.default_rng(3).integers(0, JOPTConfig.tiny().vocab_size, (2, 8))
    with tdm.counting_flops(), torch.no_grad():
        tdm(torch.from_numpy(ids))
        tdm(torch.from_numpy(ids[:, :5]))
    with jdm.counting_flops():
        jdm(jnp.asarray(ids))
        jdm(jnp.asarray(ids[:, :5]))
    cfg = OPTConfig.tiny()
    d, f, v, L = cfg.hidden_size, cfg.ffn_dim, cfg.vocab_size, cfg.num_hidden_layers
    assert tdm.flops == jdm.flops == 13 * (L * (4 * d * d + 2 * d * f) + d * v) * 2
    lin = tdm.model.decoder.layers[0].fc1
    assert lin.last_input_shape == (2, 5, d) and not lin.flop_counter_enabled
    assert lin.bops == lin.flops * 32 * 32


def test_idle_hooks_add_no_operation():
    """A Linear's forward with its idle SmoothQuant and dense sparsifier runs
    the same aten ops as with neither (a profiler spy)."""

    def ops(m):
        with torch.profiler.profile() as prof, torch.no_grad():
            m(torch.ones(3, 16))
        return [e.name for e in prof.events() if e.name.startswith("aten::")]

    _, tl = linear_pair(weight_format=BFP16_64)
    with_hooks = ops(tl)
    tl.smoothquant, tl.weight_sparsifier = None, None
    assert with_hooks == ops(tl) and with_hooks


# ---------------------------------------------------------------------------
# where the hooks meet the packed linears and the fused steps
# ---------------------------------------------------------------------------

B, T, CAP, STEPS = 2, 8, 32, 8


@pytest.mark.parametrize("fuse", [False, True])
def test_smoothquant_calibrated_weights_mode_tokens_equal_jax(fuse):
    """OPT tiny, the weights-mode rules, SmoothQuant calibrated (unfused and
    fused), then compressed and decoded greedily over an int8 cache: every
    payload, the prefill logits (1e-4) and the tokens as JAX's.  Both
    packages fold the SmoothQuant scale into the payload; the packed linear
    carries a SmoothQuant of its own, idle, so the input is not divided by
    the scale after compression: in JAX (its packed linear's fresh
    ``init_smoothquant``) and in the port alike."""
    ids = np.random.default_rng(1).integers(0, JOPTConfig.tiny().vocab_size, (B, T))
    calib = np.random.default_rng(4).integers(0, JOPTConfig.tiny().vocab_size, (4, 16))
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("DMX_DECODE_FUSED", "1")
        jm, tm = tiny_opt_pair()
        jdm = JDmxModel.from_raw(jm)
        jdm.to_basic_mode()
        for _, m in jdm.named_dmx_modules():
            m.input_casts.set_format(["SAME"] * len(m.input_casts))
            m.output_casts.set_format(["SAME"] * len(m.output_casts))
            m.approximator.function = JNoApprox()
        with jrec.DmxSmoothQuantRecipe(jrec.smoothquant_for_all_linears(0.5, fuse)).applied_to(
                jdm):
            jdm(jnp.asarray(calib))
        jfc1 = jm.model.decoder.layers[0].fc1
        jscale = j(jfc1.smoothquant.scale)
        j_compress(jdm)
    jc = jm.init_cache(B, CAP, quantized=True)
    jlogits = jm(jnp.asarray(ids, jnp.int32), caches=jc, position_offset=0)
    tok = jgreedy(jlogits[:, -1])
    jtoks, jrows = [tok], [jlogits[:, -1]]
    for i in range(STEPS - 1):
        lg = jm(tok[:, None], caches=jc, position_offset=T + i)
        tok = jgreedy(lg[:, -1])
        jtoks.append(tok)
        jrows.append(lg[:, -1])

    tdm = weights_mode_rules(tm)
    with trec.DmxSmoothQuantRecipe(trec.smoothquant_for_all_linears(0.5, fuse)).applied_to(
            tdm), torch.no_grad():
        tdm(torch.from_numpy(calib))
    np.testing.assert_allclose(tm.model.decoder.layers[0].fc1.smoothquant.scale.numpy(), jscale,
                               rtol=SQ_RTOL)
    compress_for_inference(tdm)
    set_inference_mode(True)
    try:
        tc = tm.init_cache(B, CAP, quantized=True, device="cpu")
        tlogits, ttok = greedy_prefill(tm, tc, torch.from_numpy(ids))
        ttoks, _ = greedy_decode(tm, tc, ttok, T, STEPS - 1)
    finally:
        set_inference_mode(False)
    fc1, jfc1 = tm.model.decoder.layers[0].fc1, jm.model.decoder.layers[0].fc1
    assert isinstance(fc1, PackedBFPLinear) and not fc1.smoothquant.enabled
    assert not jfc1.smoothquant.enabled
    same = (fc1.weight_mantissa.numpy() == j(jfc1.weight_mantissa)).mean()
    assert same >= 0.999, same  # the scale's pow may move a mantissa one step
    np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits), atol=SQ_LOGIT_TOL, rtol=0)
    top2 = np.sort(np.stack([np.asarray(r) for r in jrows]), axis=-1)[..., -2:]
    assert (top2[..., 1] - top2[..., 0]).min() > SQ_LOGIT_TOL, "a near-tie in the JAX run"
    np.testing.assert_array_equal(torch.cat([ttok[:, None], ttoks], 1).numpy(),
                                  np.stack([np.asarray(t) for t in jtoks], 1))


def test_basic_fused_step_under_idle_and_calibrated_smoothquant(monkeypatch):
    """BASIC mode's fused decode step (a launch-count spy on the port's
    ``OPTDecoderLayer._fused_basic_step``): kept while every packed linear's
    SmoothQuant is idle, left once one is calibrated (input maxabs
    observed), dynamic or calibrating; JAX's plan decides the same."""
    jm, tm = tiny_opt_pair()
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("DMX_DECODE_FUSED", "1")
        jdm = JDmxModel.from_raw(jm)
        jdm.to_basic_mode()
        j_compress(jdm)
    build_basic_mode(tm)
    calls = []
    orig = OPTDecoderLayer._fused_basic_step
    monkeypatch.setattr(OPTDecoderLayer, "_fused_basic_step",
                        lambda self, *a: calls.append(1) or orig(self, *a))
    cfg = OPTConfig.tiny()
    caches = tm.init_cache(B, CAP, dtype=torch.float16, split_base_len=T, device="cpu")
    ids = torch.from_numpy(np.random.default_rng(1).integers(0, cfg.vocab_size, (B, T)))
    from dmx_compressor_tpu_torch.ops.split_decode import prepare_split_decode

    _, tok = greedy_prefill(tm, caches, ids)
    prepare_split_decode(tm, caches)
    tlayer, jlayer = tm.model.decoder.layers[0], jm.model.decoder.layers[0]
    prev = JDmxModule.inference_mode
    JDmxModule.inference_mode = True
    pos = T
    try:
        for state in ("idle", "calibrated", "dynamic", "calibrating"):
            del calls[:]
            for lin in (tlayer.fc1, jlayer.fc1):
                sq = lin.smoothquant
                if state == "calibrated":
                    sq.a_maxabs = (torch.ones(cfg.hidden_size) if isinstance(lin, DmxModule)
                                   else jnp.ones(cfg.hidden_size))
                elif state == "dynamic":
                    sq.reset_a_maxabs()
                    sq.set_dynamic(True)
                elif state == "calibrating":
                    sq.set_dynamic(False)
                    sq.calibrating = True
            want_fused = state == "idle"
            assert (tbl.basic_layer_plan(tlayer) is not None) == want_fused
            assert (jbl.basic_layer_plan(jlayer) is not None) == want_fused
            if state in ("idle", "calibrated"):
                # a dynamic or calibrating SmoothQuant observes the weight in
                # the forward, which a packed linear no longer holds (in JAX
                # too): only its plan is held
                greedy_decode(tm, caches, tok, pos, 1)
                pos += 1
                assert len(calls) == (cfg.num_hidden_layers - 1 + want_fused), state
    finally:
        JDmxModule.inference_mode = prev
        set_inference_mode(False)


# ---------------------------------------------------------------------------
# the examples at tiny
# ---------------------------------------------------------------------------


def test_model_calibration_example_matches_jax():
    """``examples/model_calibration.py``'s flow on both sides (the JAX
    example's model and streams): the f32 perplexity within rtol 1e-5, the
    BASIC one within 2e-3 (FLOAT16 / BFP casts one step apart), the INT8
    calibrated one within 1e-2 (an activation an ulp apart rounds to the
    next INT8 step, and the steps compound over the layers)."""
    jm, tm = tiny_opt_pair()
    rng = np.random.default_rng(0)
    cfg = JOPTConfig.tiny()
    eval_ids = rng.integers(0, cfg.vocab_size, 512)
    want = [j_do_forward_on(jm, eval_ids, max_length=32)["perplexity"]]
    jdm = jdmx.DmxModel.from_raw(jm)
    jdm.to_basic_mode()
    want.append(j_do_forward_on(jm, eval_ids, max_length=32)["perplexity"])
    jdm.configure(None, jdmx.DmxConfigRule(module_types=(jdmxnn.Linear,),
                                           module_config=dict(input_formats=[jdmx.format.INT8])))
    calib = jnp.asarray(rng.integers(0, cfg.vocab_size, (4, 32)), jnp.int32)
    with jrec.DmxQuantizerCalibrationRecipe(jrec.input_calibration_for_all_linears(
            observer_cls=jobs.MinMaxObserver)).applied_to(jdm):
        jdm(calib)
    with jrec.DmxSmoothQuantRecipe(jrec.smoothquant_for_all_linears(0.5)).applied_to(jdm):
        jdm(calib)
    want.append(j_do_forward_on(jm, eval_ids, max_length=32)["perplexity"])

    got = tcalib_ex.calibrate(tm, np.random.default_rng(0))
    np.testing.assert_allclose(got["fp32"], want[0], rtol=1e-5)
    np.testing.assert_allclose(got["basic"], want[1], rtol=2e-3)
    np.testing.assert_allclose(got["calibrated"], want[2], rtol=1e-2)
    assert got["calibrated"] != got["basic"]


def test_int8_smoothquant_kv_example_matches_jax():
    """``examples/opt_int8_smoothquant_kv.py`` on both sides: the perplexities
    (rtol 1e-5 / 2e-3) and the greedy tokens through the int8 KV cache."""
    import jax

    jm, tm = tiny_opt_pair()
    rng = np.random.default_rng(0)
    cfg = JOPTConfig.tiny()
    eval_ids = rng.integers(0, cfg.vocab_size, 512)
    want = [j_do_forward_on(jm, eval_ids, max_length=32)["perplexity"]]
    jdm = jdmx.DmxModel.from_raw(jm)
    jdm.configure(None, jdmx.DmxConfigRule(module_types=(jdmxnn.Linear,),
                                           module_config=dict(weight_format=jdmx.format.INT8)))
    calib = jnp.asarray(rng.integers(0, cfg.vocab_size, (4, 32)), jnp.int32)
    with jrec.DmxSmoothQuantRecipe(jrec.smoothquant_for_all_linears(0.5, True)).applied_to(jdm):
        jdm(calib)

    def jgen(model):
        return {m: jrec.DmxModuleQuantizerCalibrationHyperparams(
            weight=jrec.CastCalibrationHyperparams(
                observer_cls=jobs.MinMaxObserver, qscheme_to_overload="per_tensor_symmetric",
                group_size=64, ch_axis=-1))
            for _, m in model.named_dmx_modules() if isinstance(m, jdmxnn.Linear)}

    with jrec.DmxQuantizerCalibrationRecipe(jgen).applied_to(jdm):
        jdm(calib)
    want.append(j_do_forward_on(jm, eval_ids, max_length=32)["perplexity"])
    ids = jnp.asarray(rng.integers(0, cfg.vocab_size, (2, 8)), jnp.int32)
    caches = jm.init_cache(2, 16, quantized=True)
    lg = jm(ids, caches=caches, position_offset=0)
    tok = jnp.argmax(lg[:, -1], axis=-1)
    jtoks = [tok]
    for i in range(7):
        lg = jm(tok[:, None], caches=caches, position_offset=8 + i)
        tok = jnp.argmax(lg[:, -1], axis=-1)
        jtoks.append(tok)
    del jax

    trng = np.random.default_rng(0)
    got = tkv_ex.build(tm, trng)
    np.testing.assert_allclose(got["fp32"], want[0], rtol=1e-5)
    np.testing.assert_allclose(got["quantized"], want[1], rtol=2e-3)
    tids = torch.as_tensor(trng.integers(0, cfg.vocab_size, (2, 8)))
    np.testing.assert_array_equal(tkv_ex.generate(tm, tids, 8).numpy(),
                                  np.stack([np.asarray(t) for t in jtoks], 1))
    w = tm.model.decoder.layers[0].fc1.weight_cast
    assert w.group_size == 64 and w.scale.numel() == OPTConfig.tiny().hidden_size // 64
