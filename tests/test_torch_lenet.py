"""LeNet-5, port against the JAX package on the CPU, and its kernel
launches against chip_smoke.py's counts.

The JAX model of seed 7 carries its weights into the port
(``models.lenet.load_jax_params``: ``nnx.Conv``'s kernel [kh, kw, in, out]
becomes torch's [out, in, kh, kw]); both sides take the same standard-normal
[B, 1, 28, 28] inputs, made with numpy from a seed, raw and in bench.py's
legs (the JAX side built with ``DMX_DECODE_FUSED=1`` under ``nnx.jit``).
"""

import numpy as np
import pytest
import torch
from flax import nnx

from dmx_compressor_tpu.models.lenet import LeNet5 as JLeNet5
from dmx_compressor_tpu.nn.core import DmxModule as JDmxModule
from dmx_compressor_tpu.ops.compress import set_inference_mode as j_set_inference_mode

import chip_smoke
from dmx_compressor_tpu_torch.models import lenet as tl
from dmx_compressor_tpu_torch.nn import modules as tnnm
from dmx_compressor_tpu_torch.nn.core import DmxModule
from test_torch_llama import PORT_BUILD, _j_build
from test_torch_opt import flat_params
from torch_seq2seq import spy

torch.set_num_threads(2)

# the f32 legs differ in summation order only; in the weights and basic
# legs a BFP or FLOAT16 cast may land one step apart
RAW_TOL = 1e-5
MODE_TOL = 4e-3


@pytest.fixture(autouse=True)
def _restore_inference_mode():
    prev = (DmxModule.inference_mode, JDmxModule.inference_mode)
    yield
    DmxModule.inference_mode, JDmxModule.inference_mode = prev


def images(n=4, seed=3):
    return np.random.default_rng(seed).standard_normal((n, 1, 28, 28)).astype(np.float32)


@pytest.mark.parametrize("leg", ["raw", "weights", "baseline", "basic"])
def test_leg_matches_jax(leg):
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("DMX_DECODE_FUSED", "1")
        jm = JLeNet5(rngs=nnx.Rngs(7))
        params = flat_params(jm)
        if leg != "raw":
            _j_build(leg, jm)
    j_set_inference_mode(leg not in ("raw", "baseline"))
    want = np.asarray(nnx.jit(lambda m, x: m(x))(jm, images()))
    tm = tl.LeNet5(device="cpu")
    tl.load_jax_params(tm, params)
    if leg != "raw":
        PORT_BUILD[leg](tm)
    with torch.no_grad():
        got = tm(torch.from_numpy(images())).numpy()
    np.testing.assert_allclose(got, want, atol=RAW_TOL if leg in ("raw", "baseline")
                               else MODE_TOL, rtol=0)
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))


@pytest.mark.parametrize("mode", ["baseline", "basic"])
def test_launches_are_chip_smoke_s(monkeypatch, mode):
    """One forward's wrapper calls, the count chip_smoke.py holds the card
    to: none in the baseline; in BASIC the FLOAT16 casts only (the BFP casts
    of channels 1 and 6 and of fc1's 400 inputs, off the block, are plain
    torch; no linear packs), 17 of them."""
    tm = tl.LeNet5(device="cpu")
    PORT_BUILD[mode](tm)
    assert isinstance(tm.conv1, tnnm.Conv2d) and isinstance(tm.fc1, tnnm.Linear)
    counts = {}
    spy(monkeypatch, counts)
    with torch.no_grad():
        tm(torch.from_numpy(images(2)))
    want = {"baseline": {}, "basic": {"t2": 17}}[mode]
    assert counts == want
    assert ({"t2": n for n in chip_smoke.LENET_LAUNCHES[mode].values()} == want)
