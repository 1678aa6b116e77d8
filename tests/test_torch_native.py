"""The native C++ oracle (``csrc/dmxq.cpp``) against the port's casts and
packing, bit for bit, and against the JAX package's (tests/test_native.py's
triple agreement): the fixed-point, low-bit float and block quantizers, the
plain version of T2's BFP cast on the CPU, and ``bfp_pack`` / ``bfp_unpack``.
T2's FLOAT16 cast is not the oracle's float quantizer: that one flushes an
input below the smallest normal before rounding, where FLOAT16 (the JAX
package's too) rounds it up to the smallest normal."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dmx_compressor_tpu import native as jnative
from dmx_compressor_tpu.numerics import rounding as JR

from dmx_compressor_tpu_torch import native
from dmx_compressor_tpu_torch.numerics import rounding as R
from dmx_compressor_tpu_torch.numerics.format import Format
from dmx_compressor_tpu_torch.ops import bfp_cast as T2
from dmx_compressor_tpu_torch.ops.bfp_pack import bfp_pack, bfp_unpack

pytestmark = pytest.mark.skipif(not native.is_available(), reason="no C++ toolchain available")


def rng(seed):
    return np.random.default_rng(seed)


def test_native_builds_into_the_checkout():
    assert native.AVAILABLE
    so = native._build()
    assert so.parent == native._ROOT / "build" / "dmxq" and so.exists()


def test_native_fixed_point_matches_port_and_jax():
    x = (rng(0).standard_normal(2048) * 64).astype(np.float32)
    got = native.fixed_point_quantize_nearest(x, 8, 0, True, True)
    port = R.fixed_point_quantize(torch.from_numpy(x), 8, 0, True, True, "nearest").numpy()
    want = np.asarray(JR.fixed_point_quantize(jnp.asarray(x), 8, 0, True, True, "nearest"))
    np.testing.assert_array_equal(port, got)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, jnative.fixed_point_quantize_nearest(x, 8, 0, True, True))


@pytest.mark.parametrize("man,exp,bias", [(3, 4, 7), (10, 5, 15), (7, 8, 127)])
def test_native_float_matches_port_and_jax(man, exp, bias):
    x = (rng(1).standard_normal(2048) * 8).astype(np.float32)
    got = native.float_quantize_nearest(x, man, exp, bias, True)
    port = R.float_quantize(torch.from_numpy(x), man, exp, bias, True, "nearest").numpy()
    want = np.asarray(JR.float_quantize(jnp.asarray(x), man, exp, bias, True, "nearest"))
    np.testing.assert_array_equal(port, got)
    np.testing.assert_array_equal(got, want)


def test_native_block_matches_port_and_jax():
    blocks = (rng(2).standard_normal((64, 64)) * 3).astype(np.float32)
    got = native.block_quantize_nearest(blocks, 8)
    port = R.block_quantize(torch.from_numpy(blocks), 8, "nearest").numpy()
    want = np.asarray(JR.block_quantize(jnp.asarray(blocks), 8, "nearest"))
    np.testing.assert_array_equal(port, got)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("scale", [1e-3, 3.0, 1e4])
def test_t2_plain_bfp_cast_matches_native(scale):
    """T2's BFP16_64 cast along the last axis (its plain version, on the
    CPU; the format's cast goes through it) against the oracle's blocks of
    64."""
    x = (rng(3).standard_normal((8, 4, 256)) * scale).astype(np.float32)
    want = native.block_quantize_nearest(x.reshape(-1, 64), 8).reshape(x.shape)
    got = T2.bfp_cast(torch.from_numpy(x), 8, 64).numpy()
    np.testing.assert_array_equal(got, want)
    fmt = Format.from_shorthand("BFP[8|8]{64}(SN)")
    np.testing.assert_array_equal(fmt.cast(torch.from_numpy(x), -1).numpy(), want)


def test_native_pack_matches_port_pack():
    w = (rng(4).standard_normal((32, 256)) * 2).astype(np.float32)
    man_c, exp_c = native.bfp_pack(w, 8, 64)
    p = bfp_pack(torch.from_numpy(w), 8, 64)
    np.testing.assert_array_equal(man_c, p.mantissa.numpy())
    np.testing.assert_array_equal(exp_c, p.exponent.numpy())
    rec = native.bfp_unpack(man_c, exp_c, 8, 64)
    np.testing.assert_array_equal(rec, bfp_unpack(p).numpy())
    jm, je = jnative.bfp_pack(w, 8, 64)
    np.testing.assert_array_equal(man_c, jm)
    np.testing.assert_array_equal(exp_c, je)


def test_missing_library_raises(monkeypatch):
    monkeypatch.setattr(native, "_LIB", None)
    monkeypatch.setattr(native, "_build", lambda: None)
    assert not native.is_available()
    with pytest.raises(RuntimeError, match="could not be built"):
        native.block_quantize_nearest(np.zeros((1, 64), np.float32), 8)
