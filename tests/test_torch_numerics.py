"""The port's numerics (rounding, formats, casts, BFP packing) against the JAX
package, bit for bit: the same numpy inputs go through both, and the float32
results are compared as raw bits.  Stochastic rounding is held by statistics."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import dmx_compressor_tpu as dmx
from dmx_compressor_tpu.numerics import cast as jcast
from dmx_compressor_tpu.numerics import rounding as JR
from dmx_compressor_tpu.numerics.format import Format as JFormat
from dmx_compressor_tpu.ops import bfp_pack as jpack

import dmx_compressor_tpu_torch as dmxt
from dmx_compressor_tpu_torch.numerics import cast as tcast
from dmx_compressor_tpu_torch.numerics import rounding as TR
from dmx_compressor_tpu_torch.numerics.format import Format as TFormat
from dmx_compressor_tpu_torch.ops import bfp_pack as tpack

torch.set_num_threads(2)

RNG = np.random.default_rng(0)


def rand_f32(shape, scale=4.0):
    x = (RNG.standard_normal(shape) * scale).astype(np.float32)
    return np.nan_to_num(x, posinf=3e38, neginf=-3e38)


def j(fn, x, *args, **kwargs):
    return np.asarray(fn(jnp.asarray(x), *args, **kwargs))


def t(fn, x, *args, **kwargs):
    return fn(torch.from_numpy(np.array(x)), *args, **kwargs).numpy()


def assert_bits_equal(got, want):
    got = np.ascontiguousarray(got, np.float32)
    want = np.ascontiguousarray(want, np.float32)
    assert got.shape == want.shape
    bad = got.view(np.uint32) != want.view(np.uint32)
    assert not bad.any(), (
        f"{bad.sum()} of {bad.size} differ; first: port {got[bad][:4]} vs jax {want[bad][:4]}"
    )


# ---------------------------------------------------------------------------
# rounding primitives
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("sh,xs", [
    ("BFP[8|8]{1}(SN)", [1.0, 1.0 + 2**-7, 1.0 + 2**-6, 1.0 + 2**-6 + 2**-7]),
    ("BFP[4|8]{1}(SN)", [1.0, 1.0 + 2**-3, 1.0 + 2**-2, 1.0 + 2**-2 + 2**-3]),
])
def test_bfp_1_golden_vectors(sh, xs):
    x = np.array(xs + [-v for v in xs], np.float32)
    assert_bits_equal(t(TFormat.from_shorthand(sh).cast, x), j(JFormat.from_shorthand(sh).cast, x))


@pytest.mark.parametrize("wl,fl", [(8, 0), (8, 4), (4, 0), (16, 8), (24, 0)])
@pytest.mark.parametrize("mode", ["nearest", "up", "down"])
@pytest.mark.parametrize("symmetric", [True, False])
def test_fixed_point_matches_jax(wl, fl, mode, symmetric):
    x = rand_f32((512,), scale=2.0 ** (wl - fl - 2))
    ties = (np.arange(-20, 20, dtype=np.float32) + 0.5) * 2.0**-fl
    x = np.concatenate([x, ties])
    assert_bits_equal(
        t(TR.fixed_point_quantize, x, wl, fl, True, symmetric, mode),
        j(JR.fixed_point_quantize, x, wl, fl, True, symmetric, mode),
    )


@pytest.mark.parametrize(
    "man,exp,bias",
    [(3, 4, 7), (2, 5, 15), (7, 8, 127), (10, 5, 15), (4, 4, 7), (4, 4, 12), (0, 8, 127),
     (22, 8, 127)],
)
@pytest.mark.parametrize("flush", [True, False])
@pytest.mark.parametrize("mode", ["nearest", "up", "down"])
def test_float_quantize_matches_jax(man, exp, bias, flush, mode):
    x = np.concatenate([
        rand_f32((256,), 1.0),
        rand_f32((256,), 2.0 ** (2 ** (exp - 1) - 1)),  # near overflow
        rand_f32((256,), 2.0 ** (-bias)),  # subnormal region of the format
        np.array([0.0, -0.0, 1.0, -1.0, 1e-45, -3e-39, 2.0**-126], np.float32),
        (1.0 + (np.arange(16, dtype=np.float32) * 2 + 1) * 2.0 ** -(man + 1)),  # ties
    ]).astype(np.float32)
    assert_bits_equal(
        t(TR.float_quantize, x, man, exp, bias, flush, mode),
        j(JR.float_quantize, x, man, exp, bias, flush, mode),
    )


def _blocks():
    blocks = rand_f32((32, 64))
    blocks[0] *= 1e-20
    blocks[1] *= 1e20
    blocks[2] = 0.0
    blocks[3] = np.linspace(-1.9999999, 1.9999999, 64, dtype=np.float32)
    return blocks


@pytest.mark.parametrize("wl", [4, 6, 8, 16])
@pytest.mark.parametrize("mode", ["nearest", "up", "down"])
def test_block_quantize_matches_jax(wl, mode):
    b = _blocks()
    assert_bits_equal(t(TR.block_quantize, b, wl, mode), j(JR.block_quantize, b, wl, mode))


@pytest.mark.parametrize("mode", ["nearest", "up", "down"])
def test_block_quantize_lastdim_matches_jax(mode):
    x = rand_f32((4, 3, 128))
    x[0, 0, :64] = 0.0  # a zero block
    assert_bits_equal(
        t(TR.block_quantize_lastdim, x, 8, 64, mode),
        j(JR.block_quantize_lastdim, x, 8, 64, mode),
    )


def test_make_mantissa_asymmetric_matches_jax():
    b = _blocks()
    q = j(JR.block_quantize, b, 8)
    got = TR.make_mantissa_asymmetric(torch.tensor(q), torch.tensor(b), 8).numpy()
    want = np.asarray(JR.make_mantissa_asymmetric(jnp.asarray(q), jnp.asarray(b), 8))
    assert_bits_equal(got, want)


def test_stochastic_rounding_statistics():
    """Unbiased and on the grid, for both fixed point and BFP; the port's
    stream differs from JAX's PRNG, so only the statistics are held."""
    gen = torch.Generator().manual_seed(0)
    x = torch.full((100_000,), 0.3)
    q = TR.fixed_point_quantize(x, 8, 0, rounding="stochastic", generator=gen)
    assert set(np.unique(q.numpy())).issubset({0.0, 1.0})
    jq = np.asarray(JR.fixed_point_quantize(jnp.full((100_000,), 0.3), 8, 0,
                                            rounding="stochastic", key=jax.random.key(0)))
    assert abs(q.mean().item() - 0.3) < 0.01 and abs(jq.mean() - 0.3) < 0.01
    fmt = TFormat.from_shorthand("BFP[8|8]{64}(SS)")
    xb = torch.from_numpy(rand_f32((256, 64)))
    qb = fmt.cast(xb, generator=gen)
    nearest = TFormat.from_shorthand("BFP[8|8]{64}(SN)").cast(xb)
    step = (qb - nearest).abs()
    assert float((qb - xb).mean().abs()) < 1e-3 and float(step.max()) > 0
    with pytest.raises(ValueError):
        TR.fixed_point_quantize(x, 8, 0, rounding="stochastic")


# ---------------------------------------------------------------------------
# formats
# ---------------------------------------------------------------------------

SHORTHANDS = [
    "SAME", "XP[8,0](CSN)", "XP[4,+2](C_U)", "FP[1|5|10,15](FN)", "FP[1|4|3,7](_N)",
    "FP[0|4|4,7](FN)", "BFP[8|8]{64}(SN)", "BFP[8|8]{64,-1}(SN)", "BFP[4|8]{16}(_D)",
    "BFP[24|8]{1}(SN)", "SBFP<XP[4,0](CSN)><FP[0|4|4,7](FN)>{16}", "MXFP8[E4M3]{32}",
    "MXINT8{32}",
]


@pytest.mark.parametrize("sh", SHORTHANDS)
def test_shorthand_grammar_matches_jax(sh):
    ported, ref = TFormat.from_shorthand(sh), JFormat.from_shorthand(sh)
    assert repr(ported) == repr(ref)
    assert type(ported).__name__ == type(ref).__name__
    assert TFormat.from_shorthand(repr(ported)) == ported


@pytest.mark.parametrize("bad", ["QP[8,0](CSN)", "BFP[8|8]{64}(SX)", "XP[8,0]", "FP[1|5|10]"])
def test_malformed_shorthand_raises(bad):
    with pytest.raises(ValueError):
        TFormat.from_shorthand(bad)


@pytest.mark.parametrize("name", ["SAME", "FLOAT16", "BFP16_64", "BFP32_1", "BFP12_16"])
def test_presets_match_jax(name):
    assert repr(getattr(dmxt.format, name)) == repr(getattr(dmx.format, name))


@pytest.mark.parametrize("prec,bs", [(8, 64), (8, 16), (4, 32), (6, 128)])
@pytest.mark.parametrize("block_dim", [-1, 0, 1])
@pytest.mark.parametrize("symmetric", [True, False])
def test_bfp_cast_matches_jax(prec, bs, block_dim, symmetric):
    x = rand_f32((4, 3, 100))  # 100: not a multiple of the block -> remainder path
    sh = f"BFP[{prec}|8]{{{bs}}}({'S' if symmetric else '_'}N)"
    assert_bits_equal(
        t(TFormat.from_shorthand(sh).cast, x, block_dim),
        j(JFormat.from_shorthand(sh).cast, x, block_dim),
    )


@pytest.mark.parametrize("sh", [
    "SBFP<XP[4,0](CSN)><FP[0|4|4,7](FN)>{16}", "MXFP8[E4M3]{32}", "MXFP6[E2M3]{32}",
    "MXINT8{32}", "FP[1|5|10,15](FN)", "FP[1|8|7,127](FN)", "XP[8,0](CSN)",
])
def test_other_format_casts_match_jax(sh):
    x = rand_f32((8, 64), scale=100.0)
    x[0, :16] = 0.0
    assert_bits_equal(
        t(TFormat.from_shorthand(sh).cast, x, -1), j(JFormat.from_shorthand(sh).cast, x, -1)
    )


# the float formats whose overflow clip met NaN (ROADMAP Queue C fault 4:
# NaN's exponent passed the clip's test and torch.sign(NaN) is 0, so the port
# cast NaN to 0.0), with NaN, -NaN, +-inf, 2.5 and a value past every
# format's largest, in every rounding mode (U, D, N; S by NaN positions and
# bits, its streams differ) and along both block dims
NAN_SHORTHANDS = ["FP[1|4|3,7](_N)", "FP[1|5|2,15](_N)", "FP[0|4|4,7](FN)", "FP[1|4|3,7](FU)",
                  "FP[1|4|3,7](FD)", "FP[1|3|2,3](FN)", "FP[1|5|10,15](_U)"]


def nan_inf_rows(rows=4):
    nan = np.float32(np.nan)
    return np.array([[1.0, nan, -nan, np.inf, -np.inf, 2.5, 3.0e38]] * rows, np.float32)


@pytest.mark.parametrize("sh", NAN_SHORTHANDS)
@pytest.mark.parametrize("mode", ["N", "U", "D", "S"])
@pytest.mark.parametrize("block_dim", [-1, 0])
def test_float_cast_keeps_nan_and_inf_as_jax(sh, mode, block_dim):
    sh = sh[:-2] + mode + ")"
    x = nan_inf_rows()
    if block_dim == 0:
        x = np.ascontiguousarray(x.T)
    kw_t, kw_j = {}, {}
    if mode == "S":
        kw_t, kw_j = dict(generator=torch.Generator().manual_seed(0)), dict(key=jax.random.key(0))
    got = TFormat.from_shorthand(sh).cast(torch.from_numpy(x), block_dim, **kw_t).numpy()
    want = np.asarray(JFormat.from_shorthand(sh).cast(jnp.asarray(x), block_dim, **kw_j))
    nan = np.isnan(want)
    assert nan.sum() == 8  # JAX keeps the two NaNs of each row
    np.testing.assert_array_equal(np.isnan(got), nan)
    assert_bits_equal(got[nan], want[nan])  # NaN's sign and payload
    if mode != "S":
        assert_bits_equal(got, want)
    else:  # +-inf and the value past the largest saturate alike
        sat = np.isinf(x) | (np.abs(x) > 1e38)
        assert_bits_equal(got[sat], want[sat])


# ---------------------------------------------------------------------------
# casts
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("sh", ["SAME", "FP[1|5|10,15](FN)", "BFP[8|8]{64}(SN)", "XP[8,0](CSN)"])
def test_cast_to_matches_jax_and_keeps_ste_gradient(sh):
    x = rand_f32((4, 128), scale=3.0)
    x[0, 0] = 1e9  # saturates under FLOAT16 and XP
    ported, ref = tcast.CastTo(format=sh), jcast.CastTo(format=sh)
    if sh.startswith("XP"):
        ported.scale.fill_(0.05)
        ref.scale.value = jnp.full((1,), 0.05, jnp.float32)
    xt = torch.from_numpy(x).requires_grad_(True)
    y = ported(xt)
    assert_bits_equal(y.detach().numpy(), np.asarray(ref(jnp.asarray(x))))
    y.sum().backward()
    np.testing.assert_array_equal(xt.grad.numpy(), np.ones_like(x))


def test_cast_to_dict_routes_inputs_and_outputs():
    casts = tcast.CastToDict({"input_cast": tcast.CastTo("FP[1|5|10,15](FN)"),
                              "residual_cast": tcast.CastTo("SAME")})
    a, b = torch.tensor([1.0 + 2**-12]), torch.tensor([1.0 + 2**-12])
    xa, args, kwargs = casts(a, b)
    assert xa.item() == 1.0 and args[0].item() == b.item() and kwargs == {}
    assert casts(a, output=True).item() == 1.0
    casts.set_format(["SAME", "FP[1|5|10,15](FN)"])
    assert repr(casts["input_cast"].format) == "SAME"
    casts["residual_cast"].set_format("XP[8,0](CSN)"), casts["residual_cast"].enable_calibration(observer_cls=tcast.OBSERVERS["minmax"])
    assert casts(a, torch.tensor([-2.0, 6.0]))[1][0].tolist() == [-2.0, 6.0] and casts["residual_cast"].scale.tolist() == [float(np.float32(8) / np.float32(254))] and casts["residual_cast"].zero_point.tolist() == [-63]


# ---------------------------------------------------------------------------
# packed BFP
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("prec,bs", [(8, 64), (8, 16), (4, 32)])
def test_bfp_pack_matches_jax(prec, bs):
    x = rand_f32((16, 128), 1.0) * 10.0
    x[3, :bs] = 0.0  # a zero block packs to exponent 0
    jp = jpack.bfp_pack(jnp.asarray(x), prec, bs)
    tp = tpack.bfp_pack(torch.from_numpy(x), prec, bs)
    np.testing.assert_array_equal(tp.mantissa.numpy(), np.asarray(jp.mantissa))
    np.testing.assert_array_equal(tp.exponent.numpy(), np.asarray(jp.exponent))
    assert tp.mantissa.dtype == torch.int8 and tp.exponent.dtype == torch.int8
    assert_bits_equal(tpack.bfp_unpack(tp).numpy(), np.asarray(jpack.bfp_unpack(jp)))
    # and the reconstruction is the simulated cast
    want = JFormat.from_shorthand(f"BFP[{prec}|8]{{{bs}}}(SN)").cast(jnp.asarray(x), -1)
    assert_bits_equal(tpack.bfp_unpack(tp).numpy(), np.asarray(want))
    assert tp.mantissa.numel() + tp.exponent.numel() == 16 * 128 + 16 * 128 // bs


@pytest.mark.parametrize("config", [
    dict(format="BFP[8|8]{16}(SN)",
         pre_transform={"shaping": [("view", (8, 64)), ("permute", (1, 0))]}),
    dict(format="FP[1|5|10,15](FN)",
         pre_transform={"format": "BFP[8|8]{64}(SN)", "shaping": [("flatten", (0, -1))]}),
    dict(format="XP[8,0](CSN)", qscheme="per_channel_symmetric", ch_axis=0),
    dict(format="XP[4,0](CSN)", group_size=32),
])
def test_cast_to_affine_and_pre_transforms_match_jax(config):
    x = rand_f32((4, 128), scale=2.0)
    config = dict(config)
    pre = config.pop("pre_transform", None)
    ported, ref = tcast.CastTo(**config), jcast.CastTo(**config)
    if pre is not None:
        ported.set_pre_transform(pre)
        ref.set_pre_transform(pre)
    if config["format"].startswith("XP"):
        # one (scale, zero point) per channel (4 rows) or per group (128 / 32)
        scale = np.arange(1, 5, dtype=np.float32) * 0.01
        zp = np.array([0, 1, -1, 2], np.int32)
        ported.scale, ported.zero_point = torch.tensor(scale), torch.tensor(zp)
        ref.scale.value, ref.zero_point.value = jnp.asarray(scale), jnp.asarray(zp)
    assert_bits_equal(ported(torch.from_numpy(x)).numpy(), np.asarray(ref(jnp.asarray(x))))
