"""What tests/test_torch_t5.py, test_torch_whisper.py and
test_torch_seq2seq.py share: the encoder-decoder families of the port held
against the JAX package on the CPU (the JAX package is the reference).

Each JAX model of seed 7 (``nnx.Rngs(7)``) carries its weights into the port
with the family's ``load_jax_params``; both sides take the same seeded
numpy inputs: T5 token ids uniform in [1, vocab), Whisper standard-normal
features [B, mels, 2 x max_source_positions].  A leg (``raw`` or bench.py's
``weights``, ``sbfp``, ``basic``, ``baseline``) encodes once, prefills the start ids
(T5: one token 0; Whisper: four, the length of its
``<|startoftranscript|><|en|><|transcribe|><|notimestamps|>``) into caches
of start + STEPS slots (int8 for the weights and sbfp legs, as chip_smoke.py's paths)
and decodes greedily; the JAX side's packed linears are built with
``DMX_DECODE_FUSED=1`` (ROADMAP's parity convention), its encode and decode
run under ``nnx.jit``.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from dmx_compressor_tpu.models.t5 import T5Config as JT5Config
from dmx_compressor_tpu.models.t5 import T5ForConditionalGeneration as JT5
from dmx_compressor_tpu.models.whisper import WhisperConfig as JWhisperConfig
from dmx_compressor_tpu.models.whisper import WhisperForConditionalGeneration as JWhisper
from dmx_compressor_tpu.nn.core import DmxModule as JDmxModule
from dmx_compressor_tpu.ops.compress import set_inference_mode as j_set_inference_mode

from dmx_compressor_tpu_torch.models import t5 as tt5
from dmx_compressor_tpu_torch.models import whisper as tw
from dmx_compressor_tpu_torch.models.shared import greedy_token
from dmx_compressor_tpu_torch.nn.core import DmxModule
from test_torch_llama import PORT_BUILD, _j_build
from test_torch_opt import flat_params, jgreedy

B = 2
STEPS = 6  # greedy tokens: the prefill's, then STEPS - 1 decode steps
ENC_LEN = 12  # T5's encoder tokens
START = {"t5": 1, "whisper": 4}  # decoder start tokens
# end to end, port against JAX: the f32 legs (raw, baseline) differ in
# summation order only; the weights leg's int8 cache may round a K/V entry
# one step apart, the BASIC leg's FLOAT16 / BFP casts may land one fp16 step
# apart: MODE_TOL of tests/test_torch_api.py
MODE_TOL = 4e-3
RAW_TOL = 1e-5

# family -> (JAX config, JAX model, port config, port model, the port's loader)
FAMILIES = {
    "t5": (JT5Config, JT5, tt5.T5Config, tt5.T5ForConditionalGeneration, tt5.load_jax_params),
    "whisper": (JWhisperConfig, JWhisper, tw.WhisperConfig, tw.WhisperForConditionalGeneration,
                tw.load_jax_params),
}


def configs(family, **fields):
    """(JAX config, port config): the family's ``tiny()`` with ``fields``."""
    jc, _, tc, *_ = FAMILIES[family]
    base = {k: v for k, v in vars(tc.tiny()).items() if k != "dtype"}
    base.update(fields)
    return jc(**base), tc(**base)


def encoder_input(family, cfg, batch=B, seed=3):
    rng = np.random.default_rng(seed)
    if family == "t5":
        return rng.integers(1, cfg.vocab_size, (batch, ENC_LEN)).astype(np.int32)
    return rng.standard_normal(
        (batch, cfg.num_mel_bins, 2 * cfg.max_source_positions)).astype(np.float32)


def start_ids(family, cfg, batch=B, seed=5):
    if family == "t5":
        return np.zeros((batch, 1), np.int32)
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (batch, 4)).astype(np.int32)


def jax_model(family, leg=None, **fields):
    """The JAX model of seed 7 (``leg`` built, DMX_DECODE_FUSED=1) and its
    raw weights."""
    jcfg, _ = configs(family, **fields)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("DMX_DECODE_FUSED", "1")
        jm = FAMILIES[family][1](jcfg, rngs=nnx.Rngs(7))
        params = flat_params(jm)
        if leg not in (None, "raw"):
            _j_build(leg, jm)
    return jm, params


def port_model(family, params, leg=None, **fields):
    """The port's model on the CPU, the JAX weights loaded, ``leg`` built."""
    _, tcfg = configs(family, **fields)
    tm = FAMILIES[family][3](tcfg, device="cpu")
    FAMILIES[family][4](tm, params)
    if leg not in (None, "raw"):
        PORT_BUILD[leg](tm)
    return tm


@functools.lru_cache(maxsize=None)
def jax_leg(family, leg, gated=False):
    """The JAX side of a leg: its raw params, every step's last-position
    logits [STEPS, B, V] (the prefill's first) and the tokens [B, STEPS]."""
    fields = dict(is_gated_act=True) if gated else {}
    jm, params = jax_model(family, leg, **fields)
    jcfg, _ = configs(family, **fields)
    prev = JDmxModule.inference_mode
    j_set_inference_mode(leg not in ("raw", "baseline"))
    ids = start_ids(family, jcfg)
    caches = jm.init_cache(B, START[family] + STEPS, quantized=leg in ("weights", "sbfp"))
    enc = nnx.jit(lambda m, x: m.encode(x))(jm, jnp.asarray(encoder_input(family, jcfg)))
    decode = nnx.jit(lambda m, x, e, c, off: m.decode(x, e, caches=c, position_offset=off))
    lg = decode(jm, jnp.asarray(ids), enc, caches, 0)
    rows, toks = [lg[:, -1]], [jgreedy(lg[:, -1])]
    for i in range(STEPS - 1):
        lg = decode(jm, toks[-1][:, None], enc, caches, jnp.int32(START[family] + i))
        rows.append(lg[:, -1])
        toks.append(jgreedy(lg[:, -1]))
    JDmxModule.inference_mode = prev
    return (params, np.stack([np.asarray(r) for r in rows]),
            np.stack([np.asarray(t) for t in toks], 1))


def port_run(tm, family, cfg, quantized):
    """The port's greedy loop as :func:`jax_leg` runs it: (logits [STEPS, B,
    V], tokens [B, STEPS])."""
    ids = torch.from_numpy(start_ids(family, cfg))
    caches = tm.init_cache(B, START[family] + STEPS, quantized=quantized, device="cpu")
    with torch.no_grad():
        enc = tm.encode(torch.from_numpy(encoder_input(family, cfg)))
        lg = tm.decode(ids, enc, caches=caches, position_offset=0)
        rows, toks = [lg[:, -1]], [greedy_token(lg[:, -1])]
        for i in range(STEPS - 1):
            lg = tm.decode(toks[-1][:, None], enc, caches=caches,
                           position_offset=START[family] + i)
            rows.append(lg[:, -1])
            toks.append(greedy_token(lg[:, -1]))
    return torch.stack(rows).numpy(), torch.stack(toks, 1).numpy()


def leg_matches_jax(family, leg, gated=False):
    """Greedy tokens identical to the JAX package's (every JAX top-1/top-2
    margin exceeds the tolerance, so none is a near-tie), every step's
    logits within the leg's tolerance."""
    fields = dict(is_gated_act=True) if gated else {}
    params, jrows, jtoks = jax_leg(family, leg, gated)
    prev = DmxModule.inference_mode
    tm = port_model(family, params, leg, **fields)
    rows, toks = port_run(tm, family, configs(family, **fields)[1],
                          leg in ("weights", "sbfp"))
    DmxModule.inference_mode = prev
    tol = RAW_TOL if leg in ("raw", "baseline") else MODE_TOL
    top2 = np.sort(jrows, axis=-1)[..., -2:]
    assert (top2[..., 1] - top2[..., 0]).min() > tol, "a near-tie in the JAX run"
    np.testing.assert_allclose(rows, jrows, atol=tol, rtol=0)
    np.testing.assert_array_equal(toks, jtoks)


def packed_weights_equal(family):
    """The weights leg's packed payloads, both sides, bit for bit: every
    packed linear of the model (the tied head's packing of its table
    included), by module path."""
    from dmx_compressor_tpu.ops.compress import PackedBFPLinear as JPacked

    from dmx_compressor_tpu_torch.ops.compress import PackedBFPLinear

    jm, params = jax_model(family, "weights")
    prev = DmxModule.inference_mode
    tm = port_model(family, params, "weights")
    DmxModule.inference_mode = prev
    jpacked = {".".join(str(p) for p in path): m for path, m in nnx.iter_graph(jm)
               if isinstance(m, JPacked)}
    tpacked = {n: m for n, m in tm.named_modules() if isinstance(m, PackedBFPLinear)}
    assert sorted(jpacked) == sorted(tpacked) and tpacked
    for n, tp in tpacked.items():
        for f in ("weight_mantissa", "weight_exponent"):
            np.testing.assert_array_equal(getattr(tp, f).numpy(),
                                          np.asarray(getattr(jpacked[n], f).get_value()), n)
    return tm


def spy(monkeypatch, counts):
    """Count the kernel wrappers' calls as chip_smoke.py counts their
    launches (the modules reach them through these module attributes)."""
    from dmx_compressor_tpu_torch.ops import basic_linear as tbli
    from dmx_compressor_tpu_torch.ops import bfp_cast as T2
    from dmx_compressor_tpu_torch.ops import compress as tcompress
    from dmx_compressor_tpu_torch.ops import flash_attention as tfa
    from dmx_compressor_tpu_torch.ops import flash_decode as tfd

    def wrap(mod, attr, key):
        fn = getattr(mod, attr)

        def wrapped(*a, **kw):
            counts[key] = counts.get(key, 0) + 1
            return fn(*a, **kw)

        monkeypatch.setattr(mod, attr, wrapped)

    wrap(tcompress, "bfp_linear", "b1")
    wrap(tcompress, "bfp_linear_bf16", "t1")
    wrap(tbli, "bfp_linear_bf16", "t1")
    wrap(tcompress, "sbfp_linear", "b5")
    wrap(T2, "bfp_cast", "t2")
    wrap(T2, "fp16_cast", "t2")
    wrap(tfa, "flash_attention", "b3")
    wrap(tfd, "flash_decode", "b4")
    wrap(tfd, "flash_decode_int8", "b2")
