"""The BASIC fake-quant leg of the JAX bench on the CPU: the port against the
JAX package, module by module and end to end.

The same seeded numpy inputs go through the JAX function and its port:

- the casts of kernel T2 (symmetric nearest BFP along the last axis and
  along an inner axis, FLOAT16), bit for bit, on zero, -0.0, subnormal,
  clamp-edge and overflowing blocks;
- the eight building blocks of ``tools/probe_fused_cast.py``, each against
  its Pallas kernel run in interpret mode;
- kernel T1's function, ``expand_full`` of ``tools/diag_bfpkernel_ab.py``,
  run in interpret mode, against ``bfp_linear_bf16_ref``;
- the vsimd surrogates, the fused BASIC linear, the fused LN-linear chain,
  the split-cache decode attention and the fused layer step;
- the BASIC leg (bench.py's basic mode: to_basic_mode ->
  compress_for_inference -> inference mode, a float16 split cache,
  prepare_split_decode between prefill and decode) on OPTConfig.tiny with
  one attention head, so that the fused decode attention engages;
- which wrapper the leg calls, and how often.

The JAX side is built with ``DMX_DECODE_FUSED=1`` so its packed linears keep
the int8 payload and compute from it in f32; the port runs T1's plain
version, whose products are the same exact values.
"""

import functools
import importlib.util
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx
from jax.experimental import pallas as pl

from dmx_compressor_tpu.functional import simd_ops as jsimd
from dmx_compressor_tpu.modeling.model import DmxModel as JDmxModel
from dmx_compressor_tpu.models.opt import OPTConfig as JOPTConfig
from dmx_compressor_tpu.models.opt import OPTForCausalLM as JOPT
from dmx_compressor_tpu.nn.core import DmxModule as JDmxModule
from dmx_compressor_tpu.numerics.format import Format as JFormat
from dmx_compressor_tpu.ops import basic_attention as jba
from dmx_compressor_tpu.ops import basic_layer as jbl
from dmx_compressor_tpu.ops import basic_linear as jbli
from dmx_compressor_tpu.ops.bfp_pack import PackedBFP as JPackedBFP
from dmx_compressor_tpu.ops.compress import compress_for_inference as j_compress
from dmx_compressor_tpu.ops.compress import set_inference_mode as j_set_inference_mode
from dmx_compressor_tpu.ops.split_decode import prepare_split_decode as j_prepare

from dmx_compressor_tpu_torch.functional import simd_ops as tsimd
from dmx_compressor_tpu_torch.functional.approximate import ApproximationFunction
from dmx_compressor_tpu_torch.models import opt as topt
from dmx_compressor_tpu_torch.models.opt import (
    OPTConfig,
    OPTForCausalLM,
    greedy_decode,
    greedy_prefill,
    load_jax_params,
)
from dmx_compressor_tpu_torch.nn.core import DmxModule
from dmx_compressor_tpu_torch.numerics import rounding as R
from dmx_compressor_tpu_torch.numerics.format import Format
from dmx_compressor_tpu_torch.ops import basic_attention as tba
from dmx_compressor_tpu_torch.ops import basic_layer as tbl
from dmx_compressor_tpu_torch.ops import basic_linear as tbli
from dmx_compressor_tpu_torch.ops import bfp_cast as T2
from dmx_compressor_tpu_torch.ops import compress as tcompress
from dmx_compressor_tpu_torch.ops.bfp_linear import bfp_linear_bf16_ref
from dmx_compressor_tpu_torch.ops.bfp_pack import PackedBFP, bfp_pack
from dmx_compressor_tpu_torch.ops.compress import PackedBFPLinear, build_basic_mode
from dmx_compressor_tpu_torch.ops.kv_cache import SplitKVCache
from dmx_compressor_tpu_torch.ops.split_decode import prepare_split_decode
from test_torch_opt import flat_params, jgreedy

torch.set_num_threads(2)

ROOT = pathlib.Path(__file__).resolve().parent.parent
WL, BLOCK = 8, 64  # BFP16_64, the BASIC rules' Linear and ActActMatMul format
BFP16_64 = "BFP[8|8]{64}(SN)"
FLOAT16 = "FP[1|5|10,15](FN)"
LINEAR_TOL = dict(rtol=1e-6, atol=1e-5)  # test_basic_linear.py:184
CHAIN_TOL = dict(rtol=2e-3, atol=2e-4)  # test_basic_layer.py:217, test_basic_attention.py:184
# surrogates: the same f32 formulas, reductions summed in another order
SURROGATE_TOL = dict(rtol=1e-6, atol=1e-6)
# the BASIC leg's logits, port against JAX: BFP and FLOAT16 casts round
# values whose f32 sums differ in their last bit (another summation order),
# so a rounding may land one fp16 step apart; the greatest such difference
# measured here, at either config, is 1 fp16 step of a logit (< 2^-10 for
# |logit| < 1)
LEG_TOL = 4e-3
STEPS = 6


@pytest.fixture(autouse=True)
def _restore_inference_mode():
    """Both packages keep inference mode as a class flag, shared by the
    tests of one worker."""
    prev = (DmxModule.inference_mode, JDmxModule.inference_mode)
    yield
    DmxModule.inference_mode, JDmxModule.inference_mode = prev


def rng(seed):
    return np.random.default_rng(seed)


def bits_equal(got: np.ndarray, want: np.ndarray) -> None:
    """Equal bit for bit, except that a NaN need only meet a NaN."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    nan = np.isnan(want)
    np.testing.assert_array_equal(np.isnan(got), nan)
    np.testing.assert_array_equal(got[~nan].view(np.uint32), want[~nan].view(np.uint32))


def np_bfp_cast(x: np.ndarray, wl: int, block: int) -> np.ndarray:
    """numpy f32 transcription of the JAX package's ``_bfp_cast_with_exponents``
    after per-block exponents, along the last axis.  XLA on the CPU flushes
    f32 subnormals to zero in arithmetic, so for a subnormal block this,
    and not the JAX function, speaks for the algorithm."""
    f32 = np.float32
    xr = x.astype(f32).reshape(*x.shape[:-1], -1, block)
    amax_bits = np.max(np.abs(xr), axis=-1, keepdims=True).view(np.uint32)
    zero = amax_bits == 0
    e = np.where(zero, 0, ((amax_bits >> 23) & 0xFF).astype(np.int64) - 127)

    def mul_pow2(v, k):
        k1 = np.clip(k, -126, 126)
        return (v * np.exp2(k - k1).astype(f32)).astype(f32) * np.exp2(k1).astype(f32)

    with np.errstate(over="ignore", invalid="ignore"):
        base = mul_pow2(np.full_like(xr, 1.5), e + 2)
        t = (xr + base).astype(f32)
        q = (mul_pow2(np.rint(mul_pow2(t, wl - 2 - e)), e + 2 - wl) - base).astype(f32)
        lim = mul_pow2(np.ones_like(xr), e + 1)
        maxv = f32(2.0 - 2.0 ** (-(wl - 2))) * mul_pow2(np.ones_like(xr), e)
        q = np.where(np.abs(q) >= lim, np.sign(q) * maxv, q).astype(f32)
    return np.where(zero, xr, q).reshape(x.shape)


SUBNORMAL_BLOCK = 6


def special_blocks(seed, n_blocks: int = 10) -> np.ndarray:
    """[n_blocks * 64] f32: random blocks at several scales, then a zero
    block, a block of +-0.0, a subnormal block, a block whose max rounds up
    to 2^(e+1) (clamped), one with values at the clamp edge, and one whose
    max is >= 2^126 (where the rebase constant overflows)."""
    r = rng(seed)
    blocks = [r.standard_normal(64) * s for s in (1.0, 1e-3, 3e4, 1e-30)]
    blocks.append(np.zeros(64))
    signed_zero = np.zeros(64)
    signed_zero[::2] = -0.0
    blocks.append(signed_zero)
    blocks.append(r.standard_normal(64) * 1e-39)  # f32 subnormals: SUBNORMAL_BLOCK
    edge = r.uniform(-1.0, 1.0, 64)
    edge[5] = 1.9999  # rounds to 2.0 at 8 bits: clamped to (2 - 2^-6)
    blocks.append(edge)
    edge2 = r.uniform(-1.0, 1.0, 64)
    edge2[9] = -(2 - 2.0**-7)  # the midpoint below the clamp value
    blocks.append(edge2)
    big = r.standard_normal(64)
    big[0] = 2.0**126
    blocks.append(big)
    return np.concatenate(blocks[:n_blocks]).astype(np.float32)


# ---------------------------------------------------------------------------
# kernel T2: the casts, bit for bit
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["lastdim", "k_rows", "v_sblocks", "format_lastdim",
                                  "format_multiplier"])
def test_bfp_cast_matches_jax_bit_for_bit(kind):
    """Ten blocks of 64 (special_blocks) laid out so that each is one cast
    block of the site: against the numpy transcription everywhere, against
    the JAX package everywhere but the subnormal block."""
    flat = special_blocks(1)
    sub = np.zeros(flat.shape, bool)
    sub[SUBNORMAL_BLOCK * 64:(SUBNORMAL_BLOCK + 1) * 64] = True

    def lay(a):
        if kind in ("lastdim", "format_lastdim"):
            return a.reshape(5, 128)
        if kind in ("k_rows", "format_multiplier"):
            return a.reshape(2, 5, 1, 64)
        # [B, H, S, D] whose blocks run along S: v[b, h, s, d] = block b*5+d
        return np.ascontiguousarray(
            np.broadcast_to(a.reshape(2, 5, 64).transpose(0, 2, 1)[:, None], (2, 2, 64, 5)))

    x = lay(flat)
    xt, xj = torch.from_numpy(x), jnp.asarray(x)
    fmt, jfmt = Format.from_shorthand(BFP16_64), JFormat.from_shorthand(BFP16_64)
    if kind == "lastdim":
        got, want = T2.bfp_cast(xt, WL, BLOCK, -1), jbli.cast_blocked_lastdim(xj, BLOCK, WL)
    elif kind == "k_rows":
        got, want = tba.cast_k_rows(xt, WL, BLOCK), jba.cast_k_rows(xj, WL, BLOCK)
    elif kind == "v_sblocks":
        got, want = tba.cast_v_sblocks(xt, BLOCK, WL), jba.cast_v_sblocks(xj, BLOCK, WL)
    elif kind == "format_lastdim":
        got, want = fmt.cast(xt, -1), jfmt.cast(xj, -1)
    else:  # the ActActMatMul multiplier cast: blocks along -2 of a k^T view
        got = fmt.cast(xt.transpose(-1, -2), -2).transpose(-1, -2)
        want = jfmt.cast(xj.swapaxes(-1, -2), -2).swapaxes(-1, -2)
    got, want = got.numpy(), np.asarray(want)
    bits_equal(got, lay(np_bfp_cast(flat, WL, BLOCK)))
    keep = ~lay(sub)
    bits_equal(got[keep], want[keep])
    # the subnormal block is cast, not passed through
    assert not np.array_equal(got[~keep], x[~keep])
    if kind in ("lastdim", "format_lastdim"):
        # the rounding module's plain path computes the same function
        bits_equal(got, R.block_quantize_lastdim(xt, WL, BLOCK).numpy())
        e, je = tbli.block_exponents(xt, BLOCK).numpy(), np.asarray(jbli.block_exponents(xj, BLOCK))
        keep_b = ~lay(sub)[:, ::BLOCK]
        np.testing.assert_array_equal(e[keep_b], je[keep_b])
        assert (e[~keep_b] == -127).all()


def test_fp16_cast_matches_jax_bit_for_bit():
    r = rng(2)
    x = np.concatenate([
        r.standard_normal(512) * 3.0, r.standard_normal(128) * 1e-6, r.standard_normal(128) * 6e4,
        r.standard_normal(128) * 7e-5,
        [0.0, -0.0, 65504.0, -65504.0, 65505.0, 65519.0, 65520.0, 1e9, -1e9, 6.103515625e-05,
         6.1e-05, 2.0**-24, -(2.0**-24), 1.0 + 2.0**-11, 1.0 + 3 * 2.0**-11, np.inf, -np.inf,
         np.nan],
    ]).astype(np.float32)
    got = T2.fp16_cast(torch.from_numpy(x))
    bits_equal(got.numpy(), jbli._fp16_cast_f32(jnp.asarray(x)))
    fmt = Format.from_shorthand(FLOAT16).cast(torch.from_numpy(x))
    bits_equal(fmt.numpy(), JFormat.from_shorthand(FLOAT16).cast(jnp.asarray(x)))


@pytest.mark.parametrize("layout", ["lastdim", "scores", "inner"])
def test_composed_fp16_then_bfp_cast_matches_jax_bit_for_bit(layout):
    """bfp_cast(..., fp16_first=True), the one-launch FLOAT16-then-BFP cast
    of the fused decode step, is bfp_cast_ref(fp16_cast_ref(x)) bit for bit
    and the JAX package's _fp16_cast_f32 then cast_blocked_lastdim (the
    ten special blocks, less the subnormal one where XLA flushes; their
    FLOAT16 images flush it to zero anyway, and values beyond 65504
    saturate first); along an inner axis against the plain version."""
    r = rng(3)
    flat = np.concatenate([special_blocks(4), r.standard_normal(128) * 7e4,
                           r.standard_normal(128) * 3e-5]).astype(np.float32)
    if layout == "lastdim":
        x = flat.reshape(7, 128)
    elif layout == "scores":  # [B, H, 1, S] softmax weights, blocks along S
        x = np.abs(flat).reshape(7, 1, 1, 128) / np.float32(7e4)
    else:
        x = np.ascontiguousarray(flat.reshape(2, 7, 64).transpose(0, 2, 1))
    xt = torch.from_numpy(x)
    axis = -2 if layout == "inner" else -1
    got = T2.bfp_cast(xt, WL, BLOCK, axis, fp16_first=True)
    assert got.dtype == torch.float32
    bits_equal(got.numpy(), T2.bfp_cast_ref(T2.fp16_cast_ref(xt), WL, BLOCK, axis).numpy())
    bits_equal(got.numpy(), tbli.cast_blocked_lastdim(tbli._fp16_cast_f32(xt), BLOCK, WL).numpy()
               if axis == -1 else T2.bfp_cast(T2.fp16_cast(xt), WL, BLOCK, axis).numpy())
    if axis == -1:
        want = jbli.cast_blocked_lastdim(jbli._fp16_cast_f32(jnp.asarray(x)), BLOCK, WL)
        bits_equal(got.numpy(), np.asarray(want))
        # the FLOAT16 images differ from x: the composition is not a no-op
        assert not np.array_equal(got.numpy(), T2.bfp_cast(xt, WL, BLOCK, -1).numpy())


# ---------------------------------------------------------------------------
# kernel T2's probes, against the Pallas kernels of probe_fused_cast.py
# ---------------------------------------------------------------------------


def _load_tool(name):
    spec = importlib.util.spec_from_file_location(name, ROOT / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@functools.lru_cache(maxsize=None)
def _probe_kernels():
    """probe letter -> (Pallas kernel, input shape, output ShapeDtypeStruct),
    taken from the tool's own main() with its runner replaced."""
    mod = _load_tool("probe_fused_cast")
    found = {}
    mod.run = lambda name, kernel, x, out_shape, ref_fn: found.setdefault(
        name[0], (kernel, x.shape, out_shape))
    mod.main()
    return found


@pytest.mark.parametrize("probe", list(T2.PROBES))
def test_probe_matches_its_pallas_kernel(probe):
    kernel, in_shape, out_shape = _probe_kernels()[probe]
    x = (rng(3).standard_normal(in_shape) * (8.0 if probe == "d" else 3.0)).astype(np.float32)
    if probe == "f":
        x.flat[:6] = [7e4, -7e4, 1e-6, -0.0, 65519.0, 2.0**-24]
    want = np.asarray(pl.pallas_call(kernel, out_shape=out_shape, interpret=True)(jnp.asarray(x)))
    xt = torch.from_numpy(x.reshape(x.shape[0], -1))
    got = T2.probe_ref(probe, xt, BLOCK).numpy()
    bits_equal(got, want.reshape(got.shape))
    bits_equal(T2.probe(probe, xt, BLOCK).numpy(), got)  # the wrapper, CPU tensor


# ---------------------------------------------------------------------------
# kernel T1's function, against expand_full of diag_bfpkernel_ab.py
# ---------------------------------------------------------------------------


def test_bfp_linear_bf16_matches_expand_full(monkeypatch):
    """A weight block near the f32 minimum (subnormal in f32 and bf16)
    included; the Pallas kernel runs in interpret mode."""
    mod = _load_tool("diag_bfpkernel_ab")
    monkeypatch.setattr(pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True))
    r = rng(4)
    M, K, N = 8, 192, 96
    w = r.standard_normal((N, K)).astype(np.float32) * 0.05
    w[3, :64] *= 2e-38  # f32 subnormals: block exponent -127, man * 2^-133
    packed = bfp_pack(torch.from_numpy(w), WL, BLOCK)
    assert int(packed.exponent[3, 0]) <= -126
    x = (r.standard_normal((M, K)) * 0.5).astype(np.float32)
    want = np.asarray(mod.bfp_matmul_variant(
        jnp.asarray(x), jnp.asarray(packed.mantissa.numpy()), jnp.asarray(packed.exponent.numpy()),
        WL, BLOCK, variant="expand_full"))
    got = bfp_linear_bf16_ref(torch.from_numpy(x), packed).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    assert np.any(got[:, 3] != 0)


# ---------------------------------------------------------------------------
# the surrogates
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", ["poly2exp", "exp_small", "softmax", "softmax_clamped",
                                  "layer_norm", "layer_norm_tiled", "execute_softmax",
                                  "poly2exp_inline"])
def test_surrogate_matches_jax(case):
    x = (rng(5).standard_normal((4, 128)) * 4.0).astype(np.float32)
    w = (1.0 + 0.1 * rng(6).standard_normal(128)).astype(np.float32)
    b = (0.1 * rng(7).standard_normal(128)).astype(np.float32)
    xt, xj = torch.from_numpy(x), jnp.asarray(x)
    if case == "poly2exp":
        got, want = tsimd.poly2exp(xt), jsimd.poly2exp(xj)
    elif case == "exp_small":
        got = tsimd.exp(xt, knorm=1, kmax=6, use_exp_large=False)
        want = jsimd.exp(xj, knorm=1, kmax=6, use_exp_large=False)
    elif case == "softmax":
        got, want = tsimd.softmax(xt), jsimd.softmax(xj)
    elif case == "softmax_clamped":
        got = tsimd.softmax(xt, dim=0, input_clamp=-2.0, max_adjust=0.1141)
        want = jsimd.softmax(xj, dim=0, input_clamp=-2.0, max_adjust=0.1141)
    elif case == "layer_norm":
        got = tsimd.layer_norm(xt, (128,), torch.from_numpy(w), torch.from_numpy(b))
        want = jsimd.layer_norm(xj, (128,), jnp.asarray(w), jnp.asarray(b))
    elif case == "layer_norm_tiled":
        got = tsimd.layer_norm(xt, (128,), torch.from_numpy(w), None, tile_size=32, norm=0.5)
        want = jsimd.layer_norm(xj, (128,), jnp.asarray(w), None, tile_size=32, norm=0.5)
    elif case == "execute_softmax":
        got = ApproximationFunction.from_shorthand(
            "SOFTMAX[vsimd]{input_clamp=-100}(max_adjust=0.1141)").execute(xt, dim=-1)
        want = jsimd.softmax(xj, dim=-1, max_adjust=0.1141)
    else:
        got = tba._poly2exp_inline(xt - 6.0, 15, False)
        want = jba._poly2exp_inline(xj - 6.0, 15, False)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **SURROGATE_TOL)


# ---------------------------------------------------------------------------
# the fused chains
# ---------------------------------------------------------------------------


def _packed(seed, N, K):
    w = torch.from_numpy((rng(seed).standard_normal((N, K)) * 0.05).astype(np.float32))
    p = bfp_pack(w, WL, BLOCK)
    jp = JPackedBFP(jnp.asarray(p.mantissa.numpy()), jnp.asarray(p.exponent.numpy()), WL, BLOCK)
    return p, jp


@pytest.mark.parametrize("out_fp16,res", [(False, None), (True, None), (True, "grid"),
                                          (True, "raw")])
def test_fused_basic_linear_matches_jax(out_fp16, res):
    M, K, N = 6, 192, 80
    p, jp = _packed(8, N, K)
    x = (rng(9).standard_normal((2, 3, K)) * 2.0).astype(np.float32)
    x[0, 0, :64] = 0.0  # a zero block passes through
    bias = (rng(10).standard_normal(N) * 0.1).astype(np.float32)
    r = None
    if res is not None:
        r = (rng(11).standard_normal((2, 3, N)) * 4.0).astype(np.float32)
        if res == "grid":
            r = r.astype(np.float16).astype(np.float32)
    kw = dict(in_wl=WL, in_block=BLOCK, out_fp16=out_fp16, res_on_grid=res == "grid")
    got = tbli.fused_basic_linear(torch.from_numpy(x), packed=p, bias=torch.from_numpy(bias),
                                  res_out=None if r is None else torch.from_numpy(r), **kw)
    want = jbli.fused_basic_linear(jnp.asarray(x), packed=jp, bias=jnp.asarray(bias),
                                   res_out=None if r is None else jnp.asarray(r), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LINEAR_TOL)


@pytest.mark.parametrize("variant", ["plain", "resadd_relu", "on_grid"])
def test_fused_ln_linear_matches_jax(variant):
    K, N = 128, 192
    p, jp = _packed(12, N, K)
    x = (rng(13).standard_normal((4, K)) * 1.5).astype(np.float32)
    res = (rng(14).standard_normal((4, K))).astype(np.float32)
    ln_w = (1.0 + 0.1 * rng(15).standard_normal(K)).astype(np.float32)
    ln_b = (0.1 * rng(16).standard_normal(K)).astype(np.float32)
    bias = (rng(17).standard_normal(N) * 0.1).astype(np.float32)
    if variant == "on_grid":
        x = x.astype(np.float16).astype(np.float32)
    kw = dict(eps=1e-5, wl=WL, in_block=BLOCK, input_on_grid=variant == "on_grid")
    if variant == "resadd_relu":
        kw.update(relu=True, emit_pre=True)
    got = tbl.fused_ln_linear(
        torch.from_numpy(x), packed=p, bias=torch.from_numpy(bias), ln_w=torch.from_numpy(ln_w),
        ln_b=torch.from_numpy(ln_b),
        residual=torch.from_numpy(res) if variant == "resadd_relu" else None, **kw)
    want = jbl.fused_ln_linear(
        jnp.asarray(x), packed=jp, bias=jnp.asarray(bias), ln_w=jnp.asarray(ln_w),
        ln_b=jnp.asarray(ln_b), residual=jnp.asarray(res) if variant == "resadd_relu" else None,
        **kw)
    got, want = (got, want) if variant == "resadd_relu" else ((got,), (want,))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **CHAIN_TOL)


@pytest.mark.parametrize("form", ["split", "split_precast", "whole_cache"])
def test_basic_sdpa_decode_matches_jax(form):
    """The split-cache decode attention, with and without the base casts
    made beforehand, and the one-cache form over the concatenated cache."""
    precast = form == "split_precast"
    B, H, S0, C, D = 2, 3, 128, 64, 64
    r = rng(18)
    q = (r.standard_normal((B, H, 1, D)) * 2.0).astype(np.float32)
    segs = [(r.standard_normal((B, H, n, D)) * 2.0).astype(np.float16).astype(np.float32)
            for n in (S0, S0, C, C)]
    segs[2][:, :, 40:] = 0.0  # the unwritten tail slots
    segs[3][:, :, 40:] = 0.0
    mask = np.where(np.arange(S0 + C) <= S0 + 40, 0.0, -1e4).astype(np.float32)[None]
    params = dict(wl=WL, block=BLOCK, input_clamp=-100.0, max_adjust=0.1141, kmax=15,
                  use_exp_large=True)
    targs = [torch.from_numpy(a) for a in [q, *segs, mask]]
    jargs = [jnp.asarray(a) for a in [q, *segs, mask]]
    tkw, jkw = {}, {}
    if precast:
        tkw = dict(base_k_cast=tba.cast_k_rows(targs[1], WL, BLOCK),
                   base_v_cast=tba.cast_v_sblocks(targs[2], BLOCK, WL))
        jkw = dict(base_k_cast=jba.cast_k_rows(jargs[1], WL, BLOCK).astype(jnp.bfloat16),
                   base_v_cast=jba.cast_v_sblocks(jargs[2], BLOCK, WL).astype(jnp.bfloat16))
    if form == "whole_cache":
        q_, bk, bv, tk, tv, m_ = targs
        got = tba.basic_sdpa_decode(q_, torch.cat([bk, tk], 2), torch.cat([bv, tv], 2), m_,
                                    scale=D**-0.5, params=tba.BasicSDPAParams(**params))
        q_, bk, bv, tk, tv, m_ = jargs
        want = jba.basic_sdpa_decode(q_, jnp.concatenate([bk, tk], 2),
                                     jnp.concatenate([bv, tv], 2), m_, scale=D**-0.5,
                                     params=jba.BasicSDPAParams(**params))
    else:
        got = tba.basic_sdpa_decode_split(*targs, scale=D**-0.5,
                                          params=tba.BasicSDPAParams(**params), **tkw)
        want = jba.basic_sdpa_decode_split(*jargs, scale=D**-0.5,
                                           params=jba.BasicSDPAParams(**params), **jkw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **CHAIN_TOL)


# ---------------------------------------------------------------------------
# the BASIC leg
# ---------------------------------------------------------------------------

# OPTConfig.tiny with one attention head, so head_dim is 64: the BFP block
# divides it, and the fused decode attention and the base casts engage
# (with tiny's four heads of 16 the decode attention takes the modular
# path); positions for the prompt and the decode steps.  Batch 5 x prompt
# 64 = 320 rows > 256, so the prefill's linears take the modular path, as at
# bench.py's shapes.
CFG = dict(num_attention_heads=1, max_position_embeddings=128)
B, P, TAIL = 5, 64, 64


def _configs():
    base = dict(vars(OPTConfig.tiny()))
    base.pop("dtype")
    base.update(CFG)
    return JOPTConfig(**base), OPTConfig(**base)


@functools.lru_cache(maxsize=None)
def _jax_model():
    """The JAX package's basic mode (bench.py:_build_host), its weights and
    the prompt; prefill and decode compiled once with nnx.jit (the same
    values as eager calls, in a fraction of the time)."""
    jcfg, _ = _configs()
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("DMX_DECODE_FUSED", "1")
        jm = JOPT(jcfg, rngs=nnx.Rngs(5))
        params = flat_params(jm)
        jdm = JDmxModel.from_raw(jm)
        jdm.to_basic_mode()
        j_compress(jdm)
    ids = rng(19).integers(0, jcfg.vocab_size, (B, P)).astype(np.int32)
    prefill = nnx.jit(lambda m, x, c: m(x, caches=c, position_offset=0))
    step = nnx.jit(lambda m, x, c, off: m(x, caches=c, position_offset=off))
    return jm, params, ids, prefill, step


def _jax_prefilled():
    """A fresh JAX split cache, prefilled and prepared (inference mode on)."""
    jm, _, ids, prefill, _ = _jax_model()
    j_set_inference_mode(True)
    caches = jm.init_cache(B, P + TAIL, dtype=jnp.float16, split_base_len=P)
    lg = prefill(jm, jnp.asarray(ids), caches)
    j_prepare(jm, caches)
    return caches, lg


@functools.lru_cache(maxsize=None)
def _jax_leg():
    """bench.py's basic leg on the JAX side: the prefill logits, every
    step's last-position logits [STEPS, B, V] and the tokens [B, STEPS]."""
    prev = JDmxModule.inference_mode
    jm, _, _, _, step = _jax_model()
    caches, lg = _jax_prefilled()
    rows, toks = [lg[:, -1]], [jgreedy(lg[:, -1])]
    for i in range(STEPS - 1):
        out = step(jm, toks[-1][:, None], caches, jnp.int32(P + i))
        rows.append(out[:, -1])
        toks.append(jgreedy(out[:, -1]))
    JDmxModule.inference_mode = prev
    return (np.asarray(lg), np.stack([np.asarray(r) for r in rows]),
            np.stack([np.asarray(t) for t in toks], 1))


def _port_model():
    _, tcfg = _configs()
    tm = OPTForCausalLM(tcfg, device="cpu")
    load_jax_params(tm, _jax_model()[1])
    build_basic_mode(tm)
    caches = tm.init_cache(B, P + TAIL, dtype=torch.float16, split_base_len=P, device="cpu")
    return tm, caches


def test_basic_leg_matches_jax():
    jlogits, jrows, jtoks = _jax_leg()
    ids = _jax_model()[2]
    tm, caches = _port_model()
    assert all(isinstance(c, SplitKVCache) and c.base_k.dtype == torch.float16 for c in caches)
    logits, tok = greedy_prefill(tm, caches, torch.from_numpy(ids))
    prepare_split_decode(tm, caches)
    toks, rows = greedy_decode(tm, caches, tok, P, STEPS - 1)
    trows = torch.cat([logits[:, -1][None], rows]).numpy()
    ttoks = torch.cat([tok[:, None], toks], 1).numpy()
    np.testing.assert_allclose(logits.numpy(), jlogits, atol=LEG_TOL, rtol=0)
    np.testing.assert_allclose(trows, jrows, atol=LEG_TOL, rtol=0)
    # greedy tokens are held where the JAX top-1/top-2 margin exceeds the
    # tolerance, up to a row's first near-tie
    top2 = np.sort(jrows, axis=-1)[..., -2:]
    margin = top2[..., 1] - top2[..., 0]  # [STEPS, B]
    held = 0
    for b in range(B):
        for s in range(STEPS):
            if margin[s, b] <= LEG_TOL:
                break
            assert ttoks[b, s] == jtoks[b, s], (b, s)
            held += 1
    assert held >= STEPS  # at least a row's worth of tokens is held


def test_fused_layer_step_matches_jax():
    """One decoder layer's decode step on identical prefilled split caches:
    the port's fused step against the JAX package's."""
    jm, _, ids, _, _ = _jax_model()
    jcfg, _ = _configs()
    jc, _ = _jax_prefilled()
    tm, tc = _port_model()
    with torch.no_grad():
        tm(torch.from_numpy(ids), caches=tc, position_offset=0)
    prepare_split_decode(tm, tc)
    x = (rng(20).standard_normal((B, 1, jcfg.hidden_size))).astype(np.float32)
    mask = np.where(np.arange(P + TAIL) <= P, 0.0, -1e4).astype(np.float32)[None]
    jlayer = jm.model.decoder.layers[0]
    assert jbl.basic_layer_plan(jlayer) is not None
    tlayer = tm.model.decoder.layers[0]
    assert tbl.basic_layer_plan(tlayer) is not None
    want = nnx.jit(lambda lay, x_, m_, c_: lay(x_, attn_mask=m_, cache=c_, position_offset=P))(
        jlayer, jnp.asarray(x), jnp.asarray(mask), jc[0])
    with torch.no_grad():
        got = tlayer(torch.from_numpy(x), attn_mask=torch.from_numpy(mask), cache=tc[0],
                     position_offset=P)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **CHAIN_TOL)
    np.testing.assert_array_equal(tc[0].tail_k[:, :, 0].numpy(),
                                  np.asarray(jc[0].tail_k.get_value()[:, :, 0]))


# ---------------------------------------------------------------------------
# routing: the fused step, T1 not B1, T2 on every cast
# ---------------------------------------------------------------------------


def test_basic_leg_routes_through_t1_and_t2(monkeypatch):
    """Counts of the kernel wrappers' calls on the test config, as
    chip_smoke.py asserts the kernels' launches on the card: prefill
    (modular) 4L+1 T1 and 34L+6 T2, prepare_split_decode 2L T2, each decode
    step 4L+1 T1 and 16L+3 T2 through the fused step and head; B1 never, the
    plain BFP/FP rounding paths never.  Every cast is still counted: 3L+1
    of a step's T2 calls are the composed FLOAT16-then-BFP cast (LN1 ->
    qkv, softmax -> weights, LN2 -> fc1 per layer; the final LN -> the
    head), two casts each, so a step makes 19L+4 casts as before."""
    ids = _jax_model()[2]
    tm, caches = _port_model()
    L = tm.cfg.num_hidden_layers
    counts = dict.fromkeys(["t1", "b1", "t2", "composed", "fused_step", "plain_round"], 0)

    def spy(mod, attr, key):
        fn = getattr(mod, attr)

        def wrapped(*a, **kw):
            counts[key] += 1
            if kw.get("fp16_first"):
                counts["composed"] += 1
            return fn(*a, **kw)

        monkeypatch.setattr(mod, attr, wrapped)

    spy(tcompress, "bfp_linear_bf16", "t1")
    spy(tbli, "bfp_linear_bf16", "t1")
    spy(tcompress, "bfp_linear", "b1")
    spy(T2, "bfp_cast", "t2")
    spy(T2, "fp16_cast", "t2")
    spy(topt.OPTDecoderLayer, "_fused_basic_step", "fused_step")
    for attr in ("block_quantize_lastdim", "apply_blockwise", "float_quantize"):
        spy(R, attr, "plain_round")

    _, tok = greedy_prefill(tm, caches, torch.from_numpy(ids))
    assert counts == dict(t1=4 * L + 1, b1=0, t2=34 * L + 6, composed=0, fused_step=0,
                          plain_round=0)
    prepare_split_decode(tm, caches)
    assert counts["t2"] == 34 * L + 6 + 2 * L
    assert all(c.base_cast_key == (WL, BLOCK) for c in caches)
    greedy_decode(tm, caches, tok, P, 2)
    assert counts == dict(t1=3 * (4 * L + 1), b1=0, t2=34 * L + 6 + 2 * L + 2 * (16 * L + 3),
                          composed=2 * (3 * L + 1), fused_step=2 * L, plain_round=0)
    casts = counts["t2"] + counts["composed"] - (34 * L + 6 + 2 * L)
    assert casts == 2 * (19 * L + 4)
    assert all(isinstance(m, PackedBFPLinear) for m in (tm.lm_head,))
