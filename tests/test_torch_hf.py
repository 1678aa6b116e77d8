"""modeling/hf.py of the port against the JAX package's, on the CPU.

Every checkpoint is written here from seeded numpy tensors in HF names (no
download): OPT by tests/test_hf_integration.py's own writer, and one tiny
checkpoint per family whose names and shapes are those of transformers'
model of the family (its state dict; the values numpy's).  The JAX
package's ``model_from_checkpoint`` and the port's load each directory; the
parameters must come out equal and the same keys unmatched.  JAX's
tests/test_hf_integration.py is ported case for case, each result held
against JAX's: greedy tokens equal, perplexities within 1e-5 relative, QA
scores and the registries' results equal.  Sampling draws from another
stream than JAX's (a torch.Generator), so it is held by statistics: a
chi-square test of the first token's frequencies against JAX's softmax.
Also here: the safetensors reader and chip_smoke.py's writer against the
``safetensors`` package, ``state_dict_url``, and the attention plain
versions at OPT-2.7b's head_dim 80 against JAX's references.
"""

import json
import os
import pickle
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from dmx_compressor_tpu.modeling import hf as jhf
from dmx_compressor_tpu.ops import flash_attention as jfa
from dmx_compressor_tpu.ops import flash_decode as jfd
from dmx_compressor_tpu.ops import kv_cache as jkv

from dmx_compressor_tpu_torch.modeling import hf as thf
from dmx_compressor_tpu_torch.modeling.model import DmxModel
from dmx_compressor_tpu_torch.ops import flash_attention as tfa
from dmx_compressor_tpu_torch.ops import flash_decode as tfd
from dmx_compressor_tpu_torch.ops import kv_cache as tkv

from test_hf_integration import _EchoTokenizer, _write_opt_checkpoint

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
import chip_smoke  # noqa: E402

torch.set_num_threads(2)
RNG = np.random.default_rng(0)
LOGIT_ATOL = 1e-5  # tests/test_hf_integration.py's
PPL_RTOL = 1e-5  # an f32 model's perplexity, port vs JAX
# a BASIC model's: |log ppl| apart by at most the BASIC leg's logit
# tolerance (tests/test_torch_basic.py's LEG_TOL: a BFP or FLOAT16 cast may
# land one step apart); measured 5.8e-5 on test_pipeline_with_config's stream
BASIC_LOG_PPL_TOL = 4e-3
CHI2_P = 1e-3


@pytest.fixture
def opt_dir(tmp_path):
    _write_opt_checkpoint(str(tmp_path))
    return str(tmp_path)


def flat_params(model):
    return {".".join(str(p) for p in path): np.asarray(v.get_value())
            for path, v in nnx.to_flat_state(nnx.state(model))}


def ids_of(*shape, vocab=512, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(np.int32)


# ---------------------------------------------------------------------------
# the safetensors format
# ---------------------------------------------------------------------------


def st_tensors():
    rs = np.random.default_rng(3)
    return {
        "w.f32": rs.standard_normal((3, 5)).astype(np.float32),
        "a.f16": rs.standard_normal((7,)).astype(np.float16),
        "ids": rs.integers(-2**40, 2**40, (2, 3)).astype(np.int64),
        "z.i8": rs.integers(-128, 128, (4,)).astype(np.int8),
        "empty": np.zeros((0, 4), np.float32),
        "scalar": np.asarray(1.5, np.float32),
    }


def test_safetensors_reader_matches_the_package(tmp_path):
    """F32 / F16 / I64 / I8 bit for bit against safetensors.numpy.load_file;
    BF16 (numpy has no such type, and safetensors.numpy refuses it) against
    safetensors.torch.load_file, as float32."""
    from safetensors.numpy import load_file, save_file
    from safetensors.torch import load_file as tload
    from safetensors.torch import save_file as tsave

    fname = str(tmp_path / "a.safetensors")
    save_file(st_tensors(), fname, metadata={"format": "np"})
    want, got = load_file(fname), thf.read_safetensors(fname)
    assert list(got) == sorted(want, key=list(got).index) and set(got) == set(want)
    for k, v in want.items():
        assert got[k].dtype == v.dtype and got[k].shape == v.shape, k
        assert got[k].tobytes() == v.tobytes(), k
    bf = str(tmp_path / "b.safetensors")
    tsave({"x": torch.randn(4, 6).to(torch.bfloat16), "n": torch.arange(5)}, bf)
    tw, tg = tload(bf), thf.read_safetensors(bf)
    assert tg["x"].dtype == np.float32
    assert tg["x"].tobytes() == tw["x"].float().numpy().tobytes()
    np.testing.assert_array_equal(tg["n"], tw["n"].numpy())


def test_chip_smoke_writer_matches_the_package_byte_for_byte(tmp_path):
    from safetensors.numpy import save_file

    tensors = st_tensors()
    save_file(tensors, str(tmp_path / "pkg.safetensors"))
    chip_smoke.write_safetensors(tensors, str(tmp_path / "own.safetensors"))
    assert ((tmp_path / "own.safetensors").read_bytes()
            == (tmp_path / "pkg.safetensors").read_bytes())


def test_read_hf_checkpoint_takes_bin_files(tmp_path):
    sd = {"a.weight": torch.randn(3, 4), "b.bias": torch.randn(2).half()}
    torch.save(sd, str(tmp_path / "pytorch_model.bin"))
    got = thf.read_hf_checkpoint(str(tmp_path))
    want = jhf.read_hf_checkpoint(str(tmp_path))
    assert set(got) == set(want)
    for k in got:
        np.testing.assert_array_equal(got[k], want[k])
    (tmp_path / "nothing").mkdir()
    with pytest.raises(FileNotFoundError):
        thf.read_hf_checkpoint(str(tmp_path / "nothing"))


# ---------------------------------------------------------------------------
# one checkpoint per family
# ---------------------------------------------------------------------------


def hf_model(family):
    """transformers' model of the family at a tiny size (its state dict
    names the checkpoint's tensors)."""
    transformers = pytest.importorskip("transformers")
    if family == "opt":
        cfg = transformers.OPTConfig(vocab_size=128, hidden_size=32, ffn_dim=64,
                                     num_hidden_layers=2, num_attention_heads=2,
                                     max_position_embeddings=64, word_embed_proj_dim=32)
        return cfg, transformers.OPTForCausalLM(cfg)
    if family == "gpt2":
        cfg = transformers.GPT2Config(vocab_size=128, n_embd=32, n_layer=2, n_head=2,
                                      n_positions=64)
        return cfg, transformers.GPT2LMHeadModel(cfg)
    if family == "llama":
        cfg = transformers.LlamaConfig(vocab_size=128, hidden_size=64, intermediate_size=128,
                                       num_hidden_layers=2, num_attention_heads=4,
                                       num_key_value_heads=2, max_position_embeddings=64)
        return cfg, transformers.LlamaForCausalLM(cfg)
    if family == "t5":
        cfg = transformers.T5Config(vocab_size=128, d_model=32, d_kv=8, d_ff=64, num_layers=2,
                                    num_heads=4, feed_forward_proj="relu")
        return cfg, transformers.T5ForConditionalGeneration(cfg)
    if family == "whisper":
        cfg = transformers.WhisperConfig(vocab_size=128, num_mel_bins=8, d_model=32,
                                         encoder_layers=2, decoder_layers=2,
                                         encoder_attention_heads=2, decoder_attention_heads=2,
                                         encoder_ffn_dim=64, decoder_ffn_dim=64,
                                         max_source_positions=16, max_target_positions=32,
                                         pad_token_id=0, bos_token_id=1, eos_token_id=2,
                                         decoder_start_token_id=3)
        return cfg, transformers.WhisperForConditionalGeneration(cfg)
    cfg = transformers.CLIPConfig(
        text_config=dict(vocab_size=128, hidden_size=32, intermediate_size=64,
                         num_hidden_layers=2, num_attention_heads=2, max_position_embeddings=16),
        vision_config=dict(hidden_size=32, intermediate_size=64, num_hidden_layers=2,
                           num_attention_heads=2, image_size=32, patch_size=8),
        projection_dim=16)
    return cfg, transformers.CLIPModel(cfg)


def write_family_checkpoint(family, path, seed=0):
    """config.json and model.safetensors: every float tensor of the family's
    HF state dict drawn from numpy (normal, 0.05; norm weights about 1)."""
    from safetensors.numpy import save_file

    cfg, model = hf_model(family)
    rs = np.random.default_rng(seed)
    tensors = {}
    for k, v in model.state_dict().items():
        if v.is_floating_point():
            a = np.array(rs.standard_normal(tuple(v.shape)) * 0.05, np.float32)
            if "norm" in k and k.endswith("weight"):
                a += 1.0
            tensors[k] = a
        else:
            tensors[k] = v.numpy()
    os.makedirs(path, exist_ok=True)
    cfg.to_json_file(os.path.join(path, "config.json"))
    save_file(tensors, os.path.join(path, "model.safetensors"))


def port_from_jax(family, jm, path):
    """A port model of the checkpoint's config holding the JAX model's
    weights (every parameter zeroed, then ``load_jax_params``)."""
    from dmx_compressor_tpu_torch.models import clip, gpt2, opt, shared, t5, whisper

    loaders = {"opt": opt.load_jax_params, "gpt2": gpt2.load_jax_params,
               "llama": shared.load_jax_params, "t5": t5.load_jax_params,
               "whisper": whisper.load_jax_params, "clip": clip.load_jax_params}
    tm, _ = thf.model_from_checkpoint(path, device="cpu")
    with torch.no_grad():
        for p in tm.parameters():
            p.zero_()
    loaders[family](tm, flat_params(jm))
    return tm


FAMILIES = ["opt", "gpt2", "llama", "t5", "whisper", "clip"]


def family_forward(family, m, port):
    """A forward of each package's model on the same seeded inputs."""
    rs = np.random.default_rng(9)
    if family in ("opt", "gpt2", "llama"):
        x = rs.integers(0, 128, (2, 12)).astype(np.int32)
        return m(torch.from_numpy(x).long()) if port else m(jnp.asarray(x))
    if family == "t5":
        x, y = rs.integers(1, 128, (2, 10)), rs.integers(0, 128, (2, 5))
        if port:
            return m(torch.from_numpy(x).long(), torch.from_numpy(y).long())
        return m(jnp.asarray(x, jnp.int32), jnp.asarray(y, jnp.int32))
    if family == "whisper":
        f = rs.standard_normal((2, 8, 32)).astype(np.float32)
        y = rs.integers(0, 128, (2, 4))
        if port:
            return m(torch.from_numpy(f), torch.from_numpy(y).long())
        return m(jnp.asarray(f), jnp.asarray(y, jnp.int32))
    px = rs.standard_normal((2, 3, 32, 32)).astype(np.float32)
    ids = rs.integers(0, 128, (2, 16)).astype(np.int32)
    if port:
        return (m.get_image_features(torch.from_numpy(px)),
                m.get_text_features(torch.from_numpy(ids).long()))
    return m.get_image_features(jnp.asarray(px)), m.get_text_features(jnp.asarray(ids))


@pytest.mark.parametrize("family", FAMILIES)
def test_model_from_checkpoint_equals_jax_per_family(family, tmp_path):
    """The same checkpoint through both packages: the same unmatched keys,
    every parameter of the port equal to JAX's loaded weights carried over
    (``load_jax_params``), and the forwards within 1e-5."""
    torch.manual_seed(0)
    path = str(tmp_path / family)
    write_family_checkpoint(family, path)
    jm, jmissed = jhf.model_from_checkpoint(path)
    tm, tmissed = thf.model_from_checkpoint(path, device="cpu")
    assert sorted(tmissed) == sorted(jmissed)
    ref = port_from_jax(family, jm, path).state_dict()
    got = tm.state_dict()
    assert set(got) == set(ref)
    for k in got:
        assert torch.equal(got[k], ref[k]), k
    with torch.no_grad():
        tout = family_forward(family, tm, True)
    jout = family_forward(family, jm, False)
    for t, j in zip(tout if isinstance(tout, tuple) else (tout,),
                    jout if isinstance(jout, tuple) else (jout,)):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=LOGIT_ATOL, rtol=1e-5)


def test_model_from_checkpoint_defaults_to_the_card(opt_dir, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        thf.model_from_checkpoint(opt_dir)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        thf.pipeline("text-generation", opt_dir)


# ---------------------------------------------------------------------------
# tests/test_hf_integration.py, ported
# ---------------------------------------------------------------------------


def test_checkpoint_import_roundtrip(tmp_path):
    src = _write_opt_checkpoint(str(tmp_path))
    loaded, missed = thf.model_from_checkpoint(str(tmp_path), device="cpu")
    assert missed == []
    x = ids_of(2, 8)
    with torch.no_grad():
        got = loaded(torch.from_numpy(x).long()).numpy()
    np.testing.assert_allclose(got, np.asarray(src(jnp.asarray(x))), atol=LOGIT_ATOL)


def test_pipeline_with_config(opt_dir):
    pipe = thf.pipeline("text-generation", opt_dir, dmx_config="BASIC", device="cpu")
    jpipe = jhf.pipeline("text-generation", opt_dir, dmx_config="BASIC")
    fc1 = next(m for n, m in pipe.model.dmx_module_dict.items() if n.endswith("fc1"))
    assert repr(fc1.weight_format) == "BFP[8|8]{64}(SN)"
    # the tied head substituted as a Linear sharing the embedding table
    lm = pipe.model.get_submodule("lm_head")
    emb = pipe.model.get_submodule("model.decoder.embed_tokens")
    assert lm.weight is emb.weight

    stream = RNG.integers(0, 512, 128)
    out = pipe.do_forward_on(stream, max_length=32)
    want = jpipe.do_forward_on(stream, max_length=32)
    assert np.isfinite(out["perplexity"])
    assert abs(np.log(out["perplexity"] / want["perplexity"])) <= BASIC_LOG_PPL_TOL

    ids = ids_of(1, 4, seed=2)
    for quantized in (False, True):
        gen = pipe.generate(ids, max_new_tokens=5, quantized_cache=quantized)
        assert tuple(gen.shape) == (1, 9)
        np.testing.assert_array_equal(
            gen.numpy(), np.asarray(jpipe.generate(jnp.asarray(ids), max_new_tokens=5,
                                                   quantized_cache=quantized)))


def test_basic_perplexity_close_to_fp32(opt_dir):
    """BASIC tracks fp32 perplexity; the f32 value within 1e-5 of JAX's, the
    BASIC one within BASIC_LOG_PPL_TOL."""
    model, _ = thf.model_from_checkpoint(opt_dir, device="cpu")
    jmodel, _ = jhf.model_from_checkpoint(opt_dir)
    stream = RNG.integers(0, 512, 256)
    ppl_fp32 = thf.do_forward_on(model, stream, max_length=32)["perplexity"]
    np.testing.assert_allclose(
        ppl_fp32, jhf.do_forward_on(jmodel, stream, max_length=32)["perplexity"], rtol=PPL_RTOL)
    DmxModel.from_raw(model).to_basic_mode()
    from dmx_compressor_tpu.modeling.model import DmxModel as JDmxModel

    JDmxModel.from_raw(jmodel).to_basic_mode()
    ppl_basic = thf.do_forward_on(model, stream, max_length=32)["perplexity"]
    jppl_basic = jhf.do_forward_on(jmodel, stream, max_length=32)["perplexity"]
    assert abs(np.log(ppl_basic / jppl_basic)) <= BASIC_LOG_PPL_TOL
    assert abs(np.log(ppl_basic) - np.log(ppl_fp32)) < 0.1


def test_task_evaluation_beyond_perplexity(opt_dir):
    """QA EM/F1 and the metric-dispatching text-generation evaluation give
    JAX's numbers through the same tokenizer."""
    assert thf.squad_em_f1("The Cat!", ["the cat", "a dog"]) == {"exact_match": 1.0, "f1": 1.0}
    for pred, refs in [("black cat", ["the cat sat"]), ("", ["x"]), ("a", [""]),
                       ("one two two", ["two two three", "one"])]:
        assert thf.squad_em_f1(pred, refs) == jhf.squad_em_f1(pred, refs)

    pipe = thf.pipeline("text-generation", opt_dir, dmx_config="BASIC", device="cpu")
    jpipe = jhf.pipeline("text-generation", opt_dir, dmx_config="BASIC")
    pipe.tokenizer = jpipe.tokenizer = _EchoTokenizer()
    examples = [{"context": "ab", "question": "cd", "answers": ["xyz"]},
                {"context": "ef", "question": "gh", "answers": ["qrs"]}]
    out = pipe.evaluate_task("question-answering", examples=examples, max_new_tokens=4)
    assert out == jpipe.evaluate_task("question-answering", examples=examples, max_new_tokens=4)
    assert set(out) == {"exact_match", "f1", "n"} and out["n"] == 2.0

    kw = dict(metric="d-matrix/dmx_perplexity", references=["hello world", "quant it"],
              max_length=16)
    ppl = pipe.evaluate_task("text-generation", **kw)["perplexity"]
    jppl = jpipe.evaluate_task("text-generation", **kw)["perplexity"]
    assert abs(np.log(ppl / jppl)) <= BASIC_LOG_PPL_TOL
    with pytest.raises(ValueError):
        pipe.evaluate_task("image-segmentation")


def test_metric_and_task_registries(opt_dir):
    pipe = thf.pipeline("text-generation", opt_dir, dmx_config="BASIC", device="cpu")
    pipe.tokenizer = _EchoTokenizer()

    @thf.register_metric("test-char-count")
    def _char_count(p, references=None, dataset_ids=None, **kw):
        return {"chars": float(sum(len(r) for r in references))}

    try:
        out = pipe.evaluate_task("text-generation", metric="test-char-count",
                                 references=["ab", "cde"])
        assert out == {"chars": 5.0}
        with pytest.raises(NotImplementedError, match="register_metric"):
            pipe.evaluate_task("text-generation", metric="no-such-metric", references=["x"])
        thf.register_task("echo-task", lambda p, **kw: {"ok": 1.0, **kw})
        assert pipe.evaluate_task("echo-task", extra=2.0) == {"ok": 1.0, "extra": 2.0}
        assert "echo-task" not in jhf.TASK_REGISTRY  # each package its own registry
    finally:
        thf.METRIC_REGISTRY.pop("test-char-count", None)
        thf.TASK_REGISTRY.pop("echo-task", None)


def test_generate_sampling_and_batching(opt_dir):
    pipe = thf.pipeline("text-generation", opt_dir, device="cpu")
    jpipe = jhf.pipeline("text-generation", opt_dir)
    ids = ids_of(1, 4, seed=4)
    greedy = pipe.generate(ids, max_new_tokens=6).numpy()
    np.testing.assert_array_equal(greedy, pipe.generate(ids, max_new_tokens=6).numpy())
    np.testing.assert_array_equal(
        greedy, np.asarray(jpipe.generate(jnp.asarray(ids), max_new_tokens=6)))
    s1 = pipe.generate(ids, max_new_tokens=6, temperature=1.0, seed=1).numpy()
    s2 = pipe.generate(ids, max_new_tokens=6, temperature=1.0, seed=1).numpy()
    np.testing.assert_array_equal(s1, s2)  # seeded sampling reproducible
    s3 = pipe.generate(ids, max_new_tokens=6, temperature=1.0, top_k=5, seed=2)
    assert tuple(s3.shape) == (1, 10)
    # top_k = 1 is greedy, in both packages
    np.testing.assert_array_equal(
        pipe.generate(ids, max_new_tokens=6, temperature=1.0, top_k=1, seed=3).numpy(), greedy)
    np.testing.assert_array_equal(
        np.asarray(jpipe.generate(jnp.asarray(ids), max_new_tokens=6, temperature=1.0, top_k=1,
                                  seed=3)), greedy)

    prompts = [RNG.integers(0, 512, (3,)), RNG.integers(0, 512, (5,))]
    out, lens = pipe.generate_batch(prompts, max_new_tokens=4)
    jout, jlens = jpipe.generate_batch(prompts, max_new_tokens=4)
    assert tuple(out.shape) == (2, 9) and lens == jlens == [3, 5]
    np.testing.assert_array_equal(out.numpy(), np.asarray(jout))


def test_top_k_draws_lie_in_the_top_k(opt_dir):
    """Every sampled token at top_k 5 is among the 5 largest logits of its
    step (the logits recomputed over the generated sequence)."""
    pipe = thf.pipeline("text-generation", opt_dir, device="cpu")
    ids = ids_of(3, 4, seed=6)
    out = pipe.generate(ids, max_new_tokens=8, temperature=1.0, top_k=5, seed=11)
    with torch.no_grad():
        logits = pipe.raw_model(out.long())
    top5 = torch.topk(logits[:, 3:-1], 5, dim=-1).indices
    assert (top5 == out[:, 4:, None].long()).any(-1).all()


def test_first_token_frequencies_match_jax_softmax(opt_dir):
    """4096 first-token draws at temperature 1 (one prompt, one draw a row)
    against JAX's softmax of the prompt's last logits: chi-square, expected
    counts below 5 pooled, p > 1e-3.  The two packages draw from different
    streams (ROADMAP "Not faults")."""
    from scipy.stats import chisquare

    pipe = thf.pipeline("text-generation", opt_dir, device="cpu")
    jm, _ = jhf.model_from_checkpoint(opt_dir)
    ids = ids_of(1, 4, seed=8)
    p = np.asarray(jax.nn.softmax(jm(jnp.asarray(ids))[0, -1].astype(jnp.float32)), np.float64)
    n = 4096
    draws = pipe.generate(np.repeat(ids, n, 0), max_new_tokens=1, temperature=1.0, seed=5)[:, -1]
    counts = np.bincount(draws.numpy(), minlength=p.size).astype(np.float64)
    expected = p / p.sum() * n
    big = expected >= 5
    obs = np.append(counts[big], counts[~big].sum())
    exp = np.append(expected[big], expected[~big].sum())
    if exp[-1] == 0:
        obs, exp = obs[:-1], exp[:-1]
    assert chisquare(obs, exp).pvalue > CHI2_P


def test_pipeline_named_config_resolution(opt_dir, monkeypatch):
    probe = thf.pipeline("text-generation", opt_dir, dmx_config="BASIC", device="cpu")
    cfg_dir = os.path.join(opt_dir, "configs")
    os.makedirs(cfg_dir)
    probe.model.dmx_config.to_yaml(os.path.join(cfg_dir, "MYRECIPE.yaml"))
    pipe = thf.pipeline("text-generation", opt_dir, dmx_config="MYRECIPE", device="cpu")
    lin = next(m for n, m in pipe.model.dmx_module_dict.items() if n.endswith("fc1"))
    assert repr(lin.weight_format) == "BFP[8|8]{64}(SN)"
    alt = os.path.join(opt_dir, "hub_cache")
    os.makedirs(alt)
    with open(os.path.join(cfg_dir, "MYRECIPE.yaml")) as f, \
            open(os.path.join(alt, "OTHER.yaml"), "w") as g:
        g.write(f.read())
    monkeypatch.setenv("DMX_CONFIG_PATH", alt)
    pipe2 = thf.pipeline("text-generation", opt_dir, dmx_config="OTHER", device="cpu")
    lin2 = next(m for n, m in pipe2.model.dmx_module_dict.items() if n.endswith("fc1"))
    assert repr(lin2.weight_format) == "BFP[8|8]{64}(SN)"
    with pytest.raises(ValueError, match="unknown dmx_config"):
        thf.pipeline("text-generation", opt_dir, dmx_config="NOPE", device="cpu")


@pytest.mark.parametrize("family", ["t5", "whisper"])
def test_generate_seq2seq_equals_jax(family, tmp_path):
    path = str(tmp_path / family)
    write_family_checkpoint(family, path, seed=1)
    pipe = thf.pipeline("text2text-generation", path, device="cpu")
    jpipe = jhf.pipeline("text2text-generation", path)
    rs = np.random.default_rng(2)
    x = (rs.integers(1, 128, (2, 10)).astype(np.int32) if family == "t5"
         else rs.standard_normal((2, 8, 32)).astype(np.float32))
    got = pipe.generate_seq2seq(x, max_new_tokens=5)
    np.testing.assert_array_equal(np.asarray(got),
                                  np.asarray(jpipe.generate_seq2seq(jnp.asarray(x),
                                                                    max_new_tokens=5)))


# ---------------------------------------------------------------------------
# state_dict_url
# ---------------------------------------------------------------------------


def test_state_dict_url_round_trips_through_a_frozen_config(opt_dir, tmp_path):
    """A layer saved and registered, the model frozen to yaml, thawed onto
    a fresh model: the layer's weights come back; the URL is recorded."""
    pipe = thf.pipeline("text-generation", opt_dir, dmx_config="BASIC", device="cpu")
    name = "model.decoder.layers.1.fc1"
    with torch.no_grad():
        pipe.model.get_submodule(name).weight.mul_(3.0)
    want = pipe.model.get_submodule(name).weight.detach().clone()
    store = tmp_path / "store"
    store.mkdir()
    pipe.model.save_specific_layers_state_dict_and_register_urls(str(store), [name])
    url = pipe.model.get_submodule(name).state_dict_url
    assert url.startswith("file://") and url.endswith(".pkl")
    assert len(list(store.iterdir())) == 1
    pipe.model.freeze(str(tmp_path / "frozen.yaml"))
    fresh = thf.pipeline("text-generation", opt_dir, device="cpu")
    assert not torch.equal(fresh.model.get_submodule(name).weight, want)
    fresh.model.thaw(str(tmp_path / "frozen.yaml"))
    assert torch.equal(fresh.model.get_submodule(name).weight, want)
    assert fresh.model.get_submodule(name).state_dict_url == url


def test_state_dict_url_of_a_jax_pickle_raises_naming_the_keys(opt_dir, tmp_path):
    """The JAX package's pickle names nnx paths, not the port's state-dict
    names: loading it raises ValueError naming the mismatch."""
    from dmx_compressor_tpu.modeling.model import DmxModel as JDmxModel

    jm, _ = jhf.model_from_checkpoint(opt_dir)
    jdm = JDmxModel.from_raw(jm)
    name = "model.decoder.layers.0.fc2"
    jdm.save_specific_layers_state_dict_and_register_urls(str(tmp_path), [name])
    url = jdm.dmx_module_dict[name].state_dict_url
    with open(url[len("file://"):], "rb") as f:
        assert "accum_cast/scale" in pickle.load(f)  # nnx paths
    pipe = thf.pipeline("text-generation", opt_dir, device="cpu")
    with pytest.raises(ValueError, match="state-dict names"):
        pipe.model.configure({name: {"state_dict_url": url}})


# ---------------------------------------------------------------------------
# B2 / B3 / B4 at OPT-2.7b's head_dim 80
# ---------------------------------------------------------------------------

D80 = 80


def test_flash_attention_at_head_dim_80_matches_jax_ref():
    """The plain version, and the kernel's arithmetic on q, k, v zero-padded
    to 128 (flash_attention_planes_ref, the output's first 80 columns, the
    true D's scale), against JAX's reference at B3's card tolerance."""
    rs = np.random.RandomState(80)
    B, H, L, S = 2, 4, 40, 56
    q, k, v = (rs.standard_normal((B, H, n, D80)).astype(np.float32) for n in (L, S, S))
    want = np.asarray(jfa.flash_attention_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                              causal=True))
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    got = tfa.flash_attention(tq, tk, tv, causal=True)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=2e-5)
    pad = [torch.nn.functional.pad(t, (0, 128 - D80)) for t in (tq, tk, tv)]
    planes = tfa.flash_attention_planes_ref(*pad, causal=True, scale=D80 ** -0.5)
    assert not planes[..., D80:].any()
    np.testing.assert_allclose(planes[..., :D80].numpy(), want, rtol=1e-5, atol=2e-5)


def test_flash_decode_at_head_dim_80_matches_jax_ref():
    """B4's plain version and its split transcription, GQA 2:1, ragged rows
    over two chunks, against JAX's flash_decode_ref at B4's tolerance."""
    rs = np.random.RandomState(81)
    B, H, Hkv, S = 3, 8, 4, 1100
    q = rs.standard_normal((B, H, 1, D80)).astype(np.float32)
    k, v = (rs.standard_normal((B, Hkv, S, D80)).astype(np.float32) for _ in range(2))
    le = np.array([1100, 1025, 7], np.int32)
    want = np.asarray(jfd.flash_decode_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                           jnp.asarray(le)))
    args = (torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), torch.from_numpy(le))
    for got in (tfd.flash_decode(*args), tfd.flash_decode_split_ref(*args)):
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=2e-5)


def test_flash_decode_int8_at_head_dim_80_matches_jax_ref():
    """B2's plain version and its split transcription over an int8 cache of
    head_dim 80 (the per-position scale over the 80 dims), against JAX's
    flash_decode_int8_ref at B2's tolerance."""
    rs = np.random.RandomState(82)
    B, H, Hkv, S = 3, 8, 2, 600
    q = rs.standard_normal((B, H, 1, D80)).astype(np.float32)
    k, v = (rs.standard_normal((B, Hkv, S, D80)).astype(np.float32) for _ in range(2))
    jk, jks = jkv.QuantizedKVCache._quantize(jnp.asarray(k))
    jv, jvs = jkv.QuantizedKVCache._quantize(jnp.asarray(v))
    tk_, tks = tkv.QuantizedKVCache._quantize(torch.from_numpy(k))
    tv_, tvs = tkv.QuantizedKVCache._quantize(torch.from_numpy(v))
    np.testing.assert_array_equal(tk_.numpy(), np.asarray(jk))
    le = np.array([600, 257, 1], np.int32)
    want = np.asarray(jfd.flash_decode_int8_ref(jnp.asarray(q), jkv.QuantKV(jk, jv, jks, jvs),
                                                jnp.asarray(le)))
    kv = tkv.QuantKV(tk_, tv_, tks, tvs)
    for got in (tfd.flash_decode_int8(torch.from_numpy(q), kv, torch.from_numpy(le)),
                tfd.flash_decode_int8_split_ref(torch.from_numpy(q), kv, torch.from_numpy(le))):
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=2e-5)


def test_opt_at_head_dim_80_serves_like_jax(tmp_path):
    """A written OPT checkpoint at OPT-2.7b's attention shape cut narrow (2
    heads of 80): the pipeline's greedy tokens over the f32 and the int8
    cache equal JAX's (its attention's plain versions at D 80)."""
    from safetensors.numpy import save_file

    path = str(tmp_path)
    cfg = dict(model_type="opt", vocab_size=256, hidden_size=160, ffn_dim=320,
               num_hidden_layers=2, num_attention_heads=2, max_position_embeddings=64,
               do_layer_norm_before=True)
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(cfg, f)
    save_file(chip_smoke.opt_hf_tensors(cfg, seed=3), os.path.join(path, "model.safetensors"))
    pipe = thf.pipeline("text-generation", path, device="cpu")
    assert pipe.missed_keys == []
    jpipe = jhf.pipeline("text-generation", path)
    ids = ids_of(2, 6, vocab=256, seed=9)
    for quantized in (False, True):
        np.testing.assert_array_equal(
            pipe.generate(ids, max_new_tokens=5, quantized_cache=quantized).numpy(),
            np.asarray(jpipe.generate(jnp.asarray(ids), max_new_tokens=5,
                                      quantized_cache=quantized)))


def test_hf_module_has_every_public_name_of_jax_s():
    from test_torch_modeling import public

    assert public(jhf) - public(thf) == set()


def test_pipeline_launch_counts_are_chip_smoke_s(tmp_path, monkeypatch):
    """chip_smoke.py's hf_launches, held by spies on the kernel wrappers for
    each of its four builds, at an OPT checkpoint of the real path's head
    dim cut narrow (128 wide, 2 heads of 64, 2 layers; chip_smoke.py's
    writer), a cache of 41 slots (off the BFP block) and of 64 (on it)."""
    from dmx_compressor_tpu_torch import kernels
    from dmx_compressor_tpu_torch.models import opt as topt
    from dmx_compressor_tpu_torch.nn.core import DmxModule
    from dmx_compressor_tpu_torch.ops import bfp_cast as tcast
    from dmx_compressor_tpu_torch.ops import compress as tcompress

    for mod, attr, key in [(topt, "flash_attention", "flash_attention"),
                           (topt, "flash_decode", "flash_decode"),
                           (topt, "flash_decode_int8", "flash_decode_int8"),
                           (tcompress, "bfp_linear", "bfp_linear"),
                           (tcast, "bfp_cast", "bfp_cast"), (tcast, "fp16_cast", "bfp_cast")]:
        def wrapped(*a, _fn=getattr(mod, attr), _key=key, **kw):
            kernels.count(_key)
            return _fn(*a, **kw)

        monkeypatch.setattr(mod, attr, wrapped)
    # the spies' counts stay in this test (later tests of the process read them)
    monkeypatch.setattr(kernels, "LAUNCHES", dict.fromkeys(kernels.LAUNCHES, 0))
    monkeypatch.setattr(kernels, "ROUTE_LAUNCHES", {})
    monkeypatch.setattr(DmxModule, "inference_mode", False)
    cfg = chip_smoke.opt_hf_config(vocab_size=512, hidden_size=128, ffn_dim=256,
                                   num_hidden_layers=2, num_attention_heads=2,
                                   max_position_embeddings=256)
    d = chip_smoke.write_opt_checkpoint(torch, str(tmp_path), cfg,
                                        chip_smoke.opt_hf_tensors(cfg, seed=4))["safetensors"]
    ids = torch.from_numpy(ids_of(2, 32, seed=12))
    for build in chip_smoke.hf_builds():
        name, dmx_config, direct_build, _ = build
        if name == "weights":
            target, _ = thf.model_from_checkpoint(d, device="cpu")
            direct_build(target)
        else:
            target = thf.pipeline("text-generation", d, dmx_config=dmx_config, device="cpu")
        for new in (9, 32) if name == "basic" else (9,):
            _, launched, _ = chip_smoke.hf_generate(torch, kernels, build, target, ids, new,
                                                    False)
            assert launched == chip_smoke.hf_launches(name, cfg, 32, new), (name, new)
        DmxModule.inference_mode = False
