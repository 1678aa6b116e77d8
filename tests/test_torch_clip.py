"""CLIP, port against the JAX package on the CPU (the JAX package is the
reference), and its kernel launches against chip_smoke.py's counts.

The JAX ``CLIPConfig.tiny()`` model of seed 7 carries its weights into the
port (``models.clip.load_jax_params``); both sides take the same images
(standard normal) and prompts (uniform token ids), made with numpy from a
seed, and run ``__call__`` and ``zero_shot_classify`` raw and in bench.py's
legs (``weights``, ``baseline``, ``basic``; the JAX side's packed linears
built with ``DMX_DECODE_FUSED=1``, ROADMAP's parity convention, under
``nnx.jit``).
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from dmx_compressor_tpu.models.clip import CLIPConfig as JCLIPConfig
from dmx_compressor_tpu.models.clip import CLIPModel as JCLIP
from dmx_compressor_tpu.nn.core import DmxModule as JDmxModule
from dmx_compressor_tpu.ops.compress import set_inference_mode as j_set_inference_mode

import chip_smoke
from dmx_compressor_tpu_torch.models import clip as tc
from dmx_compressor_tpu_torch.nn.core import DmxModule
from test_torch_llama import PORT_BUILD, _j_build
from test_torch_opt import flat_params
from torch_seq2seq import spy

torch.set_num_threads(2)

N_IMAGES, N_CLASSES = 2, 3
# the f32 legs (raw, baseline) differ in summation order only; in the
# weights and basic legs a BFP or FLOAT16 cast may land one step apart
# (MODE_TOL of tests/test_torch_api.py)
RAW_TOL = 1e-5
MODE_TOL = 4e-3


@pytest.fixture(autouse=True)
def _restore_inference_mode():
    prev = (DmxModule.inference_mode, JDmxModule.inference_mode)
    yield
    DmxModule.inference_mode, JDmxModule.inference_mode = prev


def inputs(cfg, n_images=N_IMAGES, n_prompts=N_CLASSES, seed=3):
    """Images [n, 3, H, W] and prompts [n, T], numpy from ``seed``."""
    rng = np.random.default_rng(seed)
    v, t = cfg.vision, cfg.text
    px = rng.standard_normal((n_images, v.num_channels, v.image_size, v.image_size), np.float32)
    ids = rng.integers(0, t.vocab_size, (n_prompts, t.max_position_embeddings)).astype(np.int32)
    return px, ids


@functools.lru_cache(maxsize=None)
def jax_leg(leg):
    """The JAX side: its raw params, (logits per image, logits per text,
    zero-shot probabilities)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("DMX_DECODE_FUSED", "1")
        jm = JCLIP(JCLIPConfig.tiny(), rngs=nnx.Rngs(7))
        params = flat_params(jm)
        if leg != "raw":
            _j_build(leg, jm)
    prev = JDmxModule.inference_mode
    j_set_inference_mode(leg not in ("raw", "baseline"))
    px, ids = (jnp.asarray(a) for a in inputs(JCLIPConfig.tiny()))
    per_image, per_text = nnx.jit(lambda m, i, p: m(i, p))(jm, ids, px)
    probs = nnx.jit(lambda m, p, i: m.zero_shot_classify(p, i))(jm, px, ids)
    JDmxModule.inference_mode = prev
    return params, tuple(np.asarray(a) for a in (per_image, per_text, probs))


def port_leg(leg, params):
    tm = tc.CLIPModel(tc.CLIPConfig.tiny(), device="cpu")
    tc.load_jax_params(tm, params)
    if leg != "raw":
        PORT_BUILD[leg](tm)
    px, ids = (torch.from_numpy(a) for a in inputs(tc.CLIPConfig.tiny()))
    with torch.no_grad():
        per_image, per_text = tm(ids, px)
        probs = tm.zero_shot_classify(px, ids)
    return tuple(a.numpy() for a in (per_image, per_text, probs))


@pytest.mark.parametrize("leg", ["raw", "weights", "sbfp", "baseline", "basic"])
def test_leg_matches_jax(leg):
    """Both logits and the zero-shot probabilities within the leg's
    tolerance, each image's class the JAX package's (its top-1/top-2
    margin above the tolerance: no near-tie)."""
    params, want = jax_leg(leg)
    got = port_leg(leg, params)
    tol = RAW_TOL if leg in ("raw", "baseline") else MODE_TOL
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, atol=tol, rtol=0)
    top2 = np.sort(want[0], axis=-1)[:, -2:]
    assert (top2[:, 1] - top2[:, 0]).min() > tol, "a near-tie in the JAX run"
    np.testing.assert_array_equal(got[2].argmax(-1), want[2].argmax(-1))
    np.testing.assert_allclose(got[1], got[0].T, rtol=0, atol=0)


def count_config(layers=2):
    """CLIP at a test width whose cast and kernel sites are ViT-B/32's:
    heads of 64, every linear's K a multiple of 64, 17 image tokens and 16
    text positions off the BFP block, and (at 20 images and 20 prompts)
    every tower linear above the fused basic linear's 256 rows, the
    projections at or below them."""
    return tc.CLIPConfig(
        vision=tc.CLIPVisionConfig(hidden_size=128, intermediate_size=256,
                                   num_hidden_layers=layers, num_attention_heads=2,
                                   image_size=64, patch_size=16),
        text=tc.CLIPTextConfig(vocab_size=300, hidden_size=128, intermediate_size=256,
                               num_hidden_layers=layers, num_attention_heads=2,
                               max_position_embeddings=16),
        projection_dim=128)


@pytest.mark.parametrize("mode", ["weights", "baseline", "basic"])
def test_launches_are_chip_smoke_s(monkeypatch, mode):
    """The wrappers' calls of one ``zero_shot_classify`` and one
    ``__call__``, each the count chip_smoke.py holds the card to a
    forward."""
    cfg = count_config()
    tm = tc.CLIPModel(cfg, device="cpu")
    PORT_BUILD[mode](tm)
    px, ids = (torch.from_numpy(a) for a in inputs(cfg, 20, 20))
    counts = {}
    spy(monkeypatch, counts)
    want = {"weights": {"b1": 6 * 2 + 6 * 2 + 2}, "baseline": {},
            "basic": {"t1": 26, "t2": (33 * 2 + 5) + (36 * 2 + 4) + 2}}[mode]
    names = {"bfp_linear": "b1", "bfp_linear_bf16": "t1", "bfp_cast": "t2"}
    assert {names[k]: v for k, v in chip_smoke.clip_launches(cfg)[mode].items()} == want
    with torch.no_grad():
        for run in (lambda: tm.zero_shot_classify(px, ids), lambda: tm(ids, px)):
            counts.clear()
            run()
            assert counts == want


def test_hf_tensor_converter_maps_hf_names_and_the_patch_weight():
    hf = {"vision_model.embeddings.patch_embedding.weight": np.zeros((64, 3, 8, 8)),
          "vision_model.embeddings.class_embedding": np.zeros(64),
          "text_model.encoder.layers.1.mlp.fc1.weight": np.zeros((128, 64))}
    got = tc.CLIPModel.hf_tensor_converter(hf)
    assert got["vision_model.patch_embedding.weight"].shape == (64, 192)
    assert set(got) == {"vision_model.patch_embedding.weight", "vision_model.class_embedding",
                        "text_model.layers.1.mlp.fc1.weight"}
    own = dict(tc.CLIPModel(tc.CLIPConfig.tiny(), device="cpu").named_parameters())
    assert set(got) <= set(own)
