"""Calibration state of the port held against the JAX package on the CPU:
the observers' qparams (MinMax per tensor / per channel, the histogram's bins
exactly and its range search, the percentile), ``CastTo`` calibration on and
off with per-tensor, per-channel and per-group observers, ``Quantize`` /
``DeQuantize``, ``int_group_pack`` and ``do_forward_on``'s perplexity.  Every
input is numpy from a seed; each comparison states its tolerance (bit for
bit unless it says otherwise)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch
from flax import nnx

from dmx_compressor_tpu.modeling.hf import do_forward_on as j_do_forward_on
from dmx_compressor_tpu.models.opt import OPTConfig as JOPTConfig
from dmx_compressor_tpu.models.opt import OPTForCausalLM as JOPT
from dmx_compressor_tpu.numerics import cast as jcast
from dmx_compressor_tpu.numerics import observer as jobs
from dmx_compressor_tpu.numerics.format import Format as JFormat
from dmx_compressor_tpu.ops import bfp_pack as jpack

from dmx_compressor_tpu_torch.modeling.hf import do_forward_on
from dmx_compressor_tpu_torch.models.opt import OPTConfig, OPTForCausalLM, load_jax_params
from dmx_compressor_tpu_torch.numerics import cast as tcast
from dmx_compressor_tpu_torch.numerics import observer as tobs
from dmx_compressor_tpu_torch.numerics.format import Format
from dmx_compressor_tpu_torch.ops import bfp_pack as tpack
from test_torch_opt import flat_params

torch.set_num_threads(2)

INT8 = "XP[8,0](CSN)"
SCHEMES = ["per_tensor_affine", "per_tensor_symmetric"]


def rand(shape, seed=0, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def j(x):
    return np.asarray(x)


def t(x):
    return x.detach().cpu().numpy()


def assert_qparams_equal(tq, jq):
    np.testing.assert_array_equal(t(tq[0]), j(jq[0]))
    np.testing.assert_array_equal(t(tq[1]), j(jq[1]))


@pytest.mark.parametrize("sh", [INT8, "XP[8,0](C_N)", "XP[4,0](CSN)", "XP[8,2](CSN)",
                                "XP[8,0](_SN)", "FP[1|5|10,15](FN)", "BFP[8|8]{64}(SN)",
                                "SAME"])
def test_qmin_qmax_match_jax(sh):
    assert tobs.get_qmin_qmax(Format.from_shorthand(sh)) == \
        jobs.get_qmin_qmax(JFormat.from_shorthand(sh))


@pytest.mark.parametrize("scheme", SCHEMES + ["per_channel_affine", "per_channel_symmetric"])
def test_qparams_from_min_max_match_jax(scheme):
    """Random ranges, a range that excludes 0, a degenerate one and an
    empty (+inf / -inf) one, which falls back to scale 1, zero point 0."""
    lo = np.concatenate([rand(6, 1) * 3 - 1, [0.5, 0.0, np.inf]]).astype(np.float32)
    hi = np.concatenate([np.abs(rand(6, 2)) * 5, [2.0, 0.0, -np.inf]]).astype(np.float32)
    tq = tobs.calculate_qparams_from_min_max(torch.from_numpy(lo), torch.from_numpy(hi),
                                             -128, 127, scheme)
    jq = jobs.calculate_qparams_from_min_max(jnp.asarray(lo), jnp.asarray(hi), -128, 127,
                                             scheme)
    assert_qparams_equal(tq, jq)
    assert tobs.calculate_qparams_from_min_max(torch.zeros(1), torch.ones(1), None, None,
                                               scheme)[0].tolist() == [1.0]


@pytest.mark.parametrize("scheme,ch_axis", [("per_tensor_affine", -1),
                                            ("per_tensor_symmetric", -1),
                                            ("per_channel_affine", 0),
                                            ("per_channel_symmetric", -1)])
def test_minmax_observer_matches_jax(scheme, ch_axis):
    tob = tobs.MinMaxObserver(Format.from_shorthand(INT8), scheme, ch_axis)
    job = jobs.MinMaxObserver(JFormat.from_shorthand(INT8), scheme, ch_axis)
    for seed in (0, 1, 2):
        x = rand((6, 10), seed, scale=seed + 1)
        tob(torch.from_numpy(x))
        job(jnp.asarray(x))
    np.testing.assert_array_equal(t(tob.min_val), j(job.min_val.get_value()))
    np.testing.assert_array_equal(t(tob.max_val), j(job.max_val.get_value()))
    assert_qparams_equal(tob.calculate_qparams(), job.calculate_qparams())
    tob.reset()
    assert float(tob.min_val) == np.inf


def _outlier_batch(seed, n=5000):
    x = rand(n, seed)
    x[:3] = [9.0, -7.5, 12.25]  # a tail for the range search to clip
    return x


@pytest.mark.parametrize("scheme", SCHEMES)
def test_histogram_observer_bins_exactly_and_qparams_match_jax(scheme):
    """The first batch's bins (``jnp.histogram`` in f32) and the later
    batches' (float64 numpy, the old histogram redistributed) equal JAX's
    count for count; the L2 range search then gives JAX's qparams."""
    tob = tobs.HistogramObserver(Format.from_shorthand(INT8), scheme)
    job = jobs.HistogramObserver(JFormat.from_shorthand(INT8), scheme)
    for i, seed in enumerate((0, 1, 2)):
        x = _outlier_batch(seed) * (1.0 + i)
        tob(torch.from_numpy(x))
        job(jnp.asarray(x))
        np.testing.assert_array_equal(t(tob.histogram), j(job.histogram.get_value()))
        assert float(tob.min_val) == float(job.min_val.get_value())
        assert float(tob.max_val) == float(job.max_val.get_value())
    assert t(tob.histogram).sum() == 3 * 5000
    assert tob._non_linear_param_search() == job._non_linear_param_search()
    assert_qparams_equal(tob.calculate_qparams(), job.calculate_qparams())


def test_histogram_first_batch_edges_in_f32_on_awkward_ranges():
    """Values on and next to the f32 bin edges of ranges that are not dyadic
    (where float64 edges would bin them otherwise), the degenerate range
    widened by 0.5 each way, as ``jnp.histogram`` bins them."""
    for lo, hi in ((-0.3, 0.7), (-1e-3, 3.3), (1.1, 1.1)):
        edges = np.asarray(jnp.linspace(jnp.float32(lo), jnp.float32(hi), 65))
        x = np.concatenate([edges, np.nextafter(edges, np.float32(-np.inf)),
                            np.nextafter(edges, np.float32(np.inf)),
                            rand(300, 4) * (hi - lo) + lo]).astype(np.float32)
        x = np.clip(x, np.float32(lo), np.float32(hi))
        tob = tobs.HistogramObserver(Format.from_shorthand(INT8), bins=64)
        job = jobs.HistogramObserver(JFormat.from_shorthand(INT8), bins=64)
        tob(torch.from_numpy(x))
        job(jnp.asarray(x))
        np.testing.assert_array_equal(t(tob.histogram), j(job.histogram.get_value()))
        assert float(tob.min_val) == float(job.min_val.get_value())


@pytest.mark.parametrize("percentile", [99.99, 99.0, 90.0])
def test_percentile_observer_matches_jax(percentile):
    """JAX's linear interpolation between the same two order statistics,
    over two batches (a running min / max of the percentiles).  Not bit for
    bit: XLA on the CPU folds q / 100 * (n - 1) into q * ((n - 1) / 100) and
    contracts products into fmas, so the interpolation weight can land one
    f32 step of the position apart; held to that step times the gap between
    the two order statistics (2^-9 relative at 20011 values), plus 2 ulp."""
    tob = tobs.PercentileObserver(Format.from_shorthand(INT8), percentile=percentile)
    job = jobs.PercentileObserver(JFormat.from_shorthand(INT8), percentile=percentile)
    n, worst = 20011, 0.0
    for seed in (0, 1):
        x = _outlier_batch(seed, n)
        xs = np.sort(x)
        for q in (100.0 - percentile, percentile):
            pos = np.float32(q) / np.float32(100) * np.float32(n - 1)
            lo, hi = xs[int(np.floor(pos))], xs[int(np.ceil(pos))]
            got = float(tobs._jnp_percentile_f32(torch.from_numpy(x), q))
            want = float(jnp.percentile(jnp.asarray(x), q))
            tol = float(2 * np.spacing(pos) * (hi - lo) + 2 * np.spacing(np.float32(abs(want))))
            assert lo <= got <= hi and abs(got - want) <= tol, (q, got, want, tol)
            worst = max(worst, tol)
        tob(torch.from_numpy(x))
        job(jnp.asarray(x))
    np.testing.assert_allclose(t(tob.min_val), j(job.min_val.get_value()), rtol=0, atol=worst)
    np.testing.assert_allclose(t(tob.max_val), j(job.max_val.get_value()), rtol=0, atol=worst)


OBSERVER_PAIRS = {"minmax": (tobs.MinMaxObserver, jobs.MinMaxObserver),
                  "histogram": (tobs.HistogramObserver, jobs.HistogramObserver),
                  "percentile": (tobs.PercentileObserver, jobs.PercentileObserver)}


@pytest.mark.parametrize("obs,scheme,group_size,ch_axis", [
    ("minmax", "per_tensor_affine", None, None),
    ("minmax", "per_channel_symmetric", None, 0),
    ("minmax", "per_tensor_symmetric", 32, -1),
    ("minmax", "per_tensor_affine", 48, -1),  # a ragged last group
    ("histogram", "per_tensor_affine", None, None),
    ("histogram", "per_tensor_symmetric", 64, -1),
    ("percentile", "per_tensor_affine", None, None),
])
def test_cast_calibration_on_and_off_matches_jax(obs, scheme, group_size, ch_axis):
    """``enable_calibration``: fake quantization off and the observer on
    while batches stream through (the output is the input), then the qparams
    JAX computes and its fake-quantized output, bit for bit."""
    tc = tcast.CastTo(format=INT8)
    jc = jcast.CastTo(format=INT8)
    for c, cls in zip((tc, jc), OBSERVER_PAIRS[obs]):
        c.enable_calibration(True, observer_cls=cls, qscheme_to_overload=scheme,
                             group_size=group_size, ch_axis=ch_axis)
    assert tc.observer_enabled and not tc.fake_quant_enabled
    for seed in (0, 1):
        x = rand((8, 160), seed, scale=2.0 + seed)
        np.testing.assert_array_equal(t(tc(torch.from_numpy(x))), x)
        jc(jnp.asarray(x))
    for c in (tc, jc):
        c.enable_calibration(False)
    assert tc.fake_quant_enabled and not tc.observer_enabled
    np.testing.assert_array_equal(t(tc.scale), j(jc.scale.get_value()))
    np.testing.assert_array_equal(t(tc.zero_point), j(jc.zero_point.get_value()))
    if group_size:
        assert len(tc.group_observers) == -(-160 // group_size) == len(jc.group_observers)
    x = rand((8, 160), 5, scale=3.0)
    np.testing.assert_array_equal(t(tc(torch.from_numpy(x))), j(jc(jnp.asarray(x))))


def test_affine_qparams_follow_the_input_device():
    """A cast's initial qparams live on the CPU (a Dmx module substituted
    into a model on the card keeps them there until calibration): the
    affine cast moves them to the input's device."""
    c = tcast.CastTo(format=INT8)
    assert c.scale.device.type == "cpu"
    assert c(torch.ones(3, 5, device="meta")).device.type == "meta"


def test_observer_follows_the_format():
    """``set_format`` updates the observer's range; a SAME cast never
    observes."""
    c = tcast.CastTo(format="SAME", observer="minmax")
    c.enable_observer()
    c(torch.ones(4))
    assert float(c.observer.min_val) == np.inf
    c.set_format("XP[4,0](CSN)")
    assert (c.observer.quant_min, c.observer.quant_max) == (-7, 7)
    with pytest.raises(ValueError):
        tcast.CastTo(format=INT8, group_size=8, qscheme="per_channel_affine")


def test_quantize_dequantize_match_jax():
    x = rand((4, 33), 3, scale=4.0)
    for scale, zp, sh in ((0.05, 3, INT8), ([0.1], [-2], "XP[4,0](CSN)"),
                          (0.02, 0, "FP[1|5|10,15](FN)")):
        tq, jq = tcast.Quantize(scale, zp, sh), jcast.Quantize(scale, zp, sh)
        q = tq(torch.from_numpy(x))
        assert q.dtype == torch.int32
        np.testing.assert_array_equal(t(q), j(jq(jnp.asarray(x))))
        tdq, jdq = tcast.DeQuantize(scale, zp), jcast.DeQuantize(scale, zp)
        np.testing.assert_array_equal(t(tdq(q)), j(jdq(jnp.asarray(t(q)))))
    np.testing.assert_array_equal(t(tcast.DeQuantize()(torch.arange(3))), [0.0, 1.0, 2.0])


@pytest.mark.parametrize("bits,group,symmetric", [(8, 64, True), (8, 32, False),
                                                  (4, 16, True), (4, 64, False)])
def test_int_group_pack_matches_jax_and_round_trips(bits, group, symmetric):
    x = rand((6, 128), 9, scale=2.0)
    x[2, :group] = 0.0  # an all-zero group: the 1e-10 floor
    tq, ts, tz = tpack.int_group_pack(torch.from_numpy(x), bits, group, symmetric)
    jq, js, jz = jpack.int_group_pack(jnp.asarray(x), bits, group, symmetric)
    assert tq.dtype == torch.int8 and ts.shape == (6, 128 // group)
    for a, b in ((tq, jq), (ts, js), (tz, jz)):
        np.testing.assert_array_equal(t(a), j(b))
    out = tpack.int_group_unpack(tq, ts, tz, group)
    np.testing.assert_array_equal(t(out), j(jpack.int_group_unpack(jq, js, jz, group)))
    # the round trip is within half a step of each group's scale
    step = np.repeat(t(ts), group, axis=-1)
    assert (np.abs(t(out) - x) <= 0.5 * step + 1e-7).all()


def test_do_forward_on_matches_jax():
    """The strided perplexity of a tiny OPT over 200 ids in windows of 32
    (stride 32 and an overlapping stride 24), JAX's weights carried: equal
    within rtol 1e-5 (f32 logits in another summation order)."""
    jm = JOPT(JOPTConfig.tiny(), rngs=nnx.Rngs(0))
    tm = OPTForCausalLM(OPTConfig.tiny(), device="cpu")
    load_jax_params(tm, flat_params(jm))
    ids = np.random.default_rng(0).integers(0, JOPTConfig.tiny().vocab_size, 200)
    for stride in (None, 24):
        got = do_forward_on(tm, ids, max_length=32, stride=stride)
        want = j_do_forward_on(jm, ids, max_length=32, stride=stride)
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
        np.testing.assert_allclose(got["perplexity"], want["perplexity"], rtol=1e-5)
