"""16-bit float KV caches, every head_dim and any query-head group, on the
CPU: the port against the JAX package.

The same weights (JAX's, carried over with ``load_jax_params``) and the same
seeded numpy prompts go through both packages:

- a tiny OPT and a tiny GQA Llama (4 query heads over 2 KV heads), each over
  a float16 and a bfloat16 float cache made by ``init_cache(dtype=...)`` on
  both sides (the weights and activations stay float32, as
  ``model_from_checkpoint(dtype=...)`` builds them): a prefill, a second
  prompt chunk (Llama's through ``flash_chunked_prefill``, which hands B3
  the cache's 16-bit K/V; OPT's through its modular sdpa over the cache, in
  q's dtype, as JAX's matmuls promote it) and 4 greedy decode steps (B4
  over the 16-bit cache).  Held: every cache entry equal to JAX's or one
  16-bit step from it (the f32 K/V they round are summed in another
  order), the logits within HALF_LOGIT_TOL, the tokens equal;
- shapes no configuration of the zoo has, at 2 layers and narrow widths:
  a Llama of 48 query heads over 1 KV head at head_dim 64 with an int8
  cache (B2's grouped route on the card), and Llamas of head_dim 100 and
  512 (the generic routes of B2 and B4, B3's pad to 128 and its generic
  kernel) over f32 and int8 caches: logits within WIDE_TOL, tokens equal;
- ``attention_route``: no input that the JAX package computes is refused on
  the card, today's paths keep today's routes, and the decode launches'
  grids (chunks, tickets) follow the route.

On the CPU every wrapper runs its plain version: these tests hold the
port's model code, caches and routing to the JAX package; the kernels' routes
are held against the plain versions on the card by tests/test_torch_gpu.py
and chip_smoke.py.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from dmx_compressor_tpu.models.llama import LlamaConfig as JLlamaConfig
from dmx_compressor_tpu.models.llama import LlamaForCausalLM as JLlama
from dmx_compressor_tpu.models.opt import OPTConfig as JOPTConfig
from dmx_compressor_tpu.models.opt import OPTForCausalLM as JOPT

from dmx_compressor_tpu_torch.models import llama as tllama
from dmx_compressor_tpu_torch.models import opt as topt
from dmx_compressor_tpu_torch.ops import flash_attention as tfa
from dmx_compressor_tpu_torch.ops import flash_decode as tfd
from test_torch_opt import flat_params

torch.set_num_threads(2)

B, PROMPT, CHUNK, STEPS, CAP = 2, 12, 6, 4, 32
OPT_CFG = dict(vocab_size=256, hidden_size=64, ffn_dim=128, num_hidden_layers=2,
               num_attention_heads=4, max_position_embeddings=64)
LLAMA_CFG = dict(vocab_size=256, hidden_size=128, intermediate_size=256, num_hidden_layers=2,
                 num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=256)
# the wide Llamas: (query heads, KV heads, head_dim, int8 cache)
WIDE_CFGS = {"rep48_int8": (48, 1, 64, True), "d100": (2, 1, 100, False),
             "d100_int8": (2, 1, 100, True), "d512": (2, 1, 512, False),
             "d512_int8": (2, 1, 512, True)}
# logits, port against JAX, over one 16-bit cache: LOGIT_TOL (1e-4, the f32
# legs' sums in another order; measured at most 3.3e-5); the bf16 Llama's
# cache holds entries one bf16 step (2^-8 relative) from JAX's, which moved
# a logit by up to 1.70e-4 here: twice that
HALF_LOGIT_TOL = {("opt", torch.float16): 1e-4, ("opt", torch.bfloat16): 1e-4,
                  ("llama", torch.float16): 1e-4, ("llama", torch.bfloat16): 3.4e-4}
# the wide Llamas: the f32 cache's sums in another order (1e-4, as above;
# D 512 sums 512 products a logit), an int8 entry that rounds one step
# apart (KV8_TOL of chip_smoke.py, as the int8 legs of test_torch_llama.py)
WIDE_TOL = {False: 1e-4, True: 1e-2}


def _prompt(vocab, n, seed):
    return np.random.default_rng(seed).integers(0, vocab, (B, n)).astype(np.int32)


def _greedy(row):
    """The port's and JAX's tie rule: the largest index among the maxima."""
    return (row.shape[-1] - 1 - np.argmax(row[..., ::-1], axis=-1)).astype(np.int32)


def _run_jax(jm, caches, ids, chunk):
    """Prefill ids[:, :-chunk] (all of ids when chunk is 0), the chunk, then
    STEPS greedy steps: (each call's last logits [STEPS + 1 or 2, B, V],
    the tokens [B, STEPS])."""
    T = ids.shape[1]
    cut = T - chunk
    rows = [np.asarray(jm(jnp.asarray(ids[:, :cut]), caches=caches, position_offset=0))[:, -1]]
    if chunk:
        rows.append(np.asarray(jm(jnp.asarray(ids[:, cut:]), caches=caches,
                                  position_offset=cut))[:, -1])
    toks = []
    for i in range(STEPS):
        toks.append(_greedy(rows[-1]))
        rows.append(np.asarray(jm(jnp.asarray(toks[-1][:, None]), caches=caches,
                                  position_offset=T + i))[:, -1])
    return np.stack(rows), np.stack(toks, 1)


def _run_port(tm, caches, ids, chunk):
    T = ids.shape[1]
    cut = T - chunk
    rows = []
    with torch.no_grad():
        rows.append(tm(torch.from_numpy(ids[:, :cut]), caches=caches, position_offset=0)[:, -1])
        if chunk:
            rows.append(tm(torch.from_numpy(ids[:, cut:]), caches=caches,
                           position_offset=cut)[:, -1])
        toks = []
        for i in range(STEPS):
            toks.append(_greedy(rows[-1].float().numpy()))
            rows.append(tm(torch.from_numpy(toks[-1][:, None]), caches=caches,
                           position_offset=T + i)[:, -1])
    return torch.stack(rows).float().numpy(), np.stack(toks, 1)


def _build(family, cfg):
    if family == "opt":
        jm = JOPT(JOPTConfig(**cfg), rngs=nnx.Rngs(3))
        tm = topt.OPTForCausalLM(topt.OPTConfig(**cfg), device="cpu")
        topt.load_jax_params(tm, flat_params(jm))
    else:
        jm = JLlama(JLlamaConfig(**cfg), rngs=nnx.Rngs(3))
        tm = tllama.LlamaForCausalLM(tllama.LlamaConfig(**cfg), device="cpu")
        tllama.load_jax_params(tm, flat_params(jm))
    return jm, tm


def _jax_float_cache(c):
    """A JAX float cache's K and V as f32 [B, H, S, D] (it stores them
    sequence-minor)."""
    return [np.swapaxes(np.asarray(t.get_value().astype(jnp.float32)), -1, -2)
            for t in (c.k, c.v)]


# the f32 K/V that a 16-bit cache rounds: sums of O(1) products in another
# order, a few f32 ulp of the terms apart in absolute terms (which near 0 is
# more than one 16-bit step of the value)
KV_F32_ATOL = 1e-6


def _within_one_step(got, want, dtype):
    """K or V [B, H, S, D]: each entry the prefill wrote (its f32 K/V the
    same sums in another order) equal, or one step of ``dtype`` apart (up
    to KV_F32_ATOL more); each entry written after it (from hidden states
    that attended over such entries) within one step of its row's largest
    entry.  Returns the share of entries that differ."""
    eps = torch.finfo(dtype).eps
    step = np.maximum(np.abs(got), np.abs(want)) * eps + KV_F32_ATOL
    row = np.maximum(np.abs(got), np.abs(want)).max(axis=-1, keepdims=True) * eps
    step[:, :, PROMPT:] = np.maximum(step[:, :, PROMPT:], row[:, :, PROMPT:])
    diff = np.abs(got - want)
    assert (diff <= step).all(), float((diff - step).max())
    return float((diff > 0).mean())


@functools.lru_cache(maxsize=None)
def _half_case(family, dtype_name):
    dtype = getattr(torch, dtype_name)
    cfg = OPT_CFG if family == "opt" else LLAMA_CFG
    jm, tm = _build(family, cfg)
    ids = _prompt(cfg["vocab_size"], PROMPT + CHUNK, 11)
    jc = jm.init_cache(B, CAP, dtype=getattr(jnp, dtype_name))
    tc = tm.init_cache(B, CAP, dtype=dtype, device="cpu")
    jrows, jtoks = _run_jax(jm, jc, ids, CHUNK)
    trows, ttoks = _run_port(tm, tc, ids, CHUNK)
    return jc, tc, jrows, jtoks, trows, ttoks


@pytest.mark.parametrize("dtype_name", ["float16", "bfloat16"])
@pytest.mark.parametrize("family", ["opt", "llama"])
def test_half_cache_matches_jax(family, dtype_name):
    """Prefill, chunk and 4 greedy steps over a 16-bit cache: the caches hold
    the dtype, every entry JAX's or one step from it (at most 1 % apart),
    the logits within HALF_LOGIT_TOL, the tokens equal."""
    dtype = getattr(torch, dtype_name)
    jc, tc, jrows, jtoks, trows, ttoks = _half_case(family, dtype_name)
    share = []
    for j, t in zip(jc, tc):
        assert t.k.dtype == t.v.dtype == dtype
        assert j.k.get_value().dtype == getattr(jnp, dtype_name)
        jk, jv = _jax_float_cache(j)
        share.append(_within_one_step(t.k.float().numpy(), jk, dtype))
        share.append(_within_one_step(t.v.float().numpy(), jv, dtype))
    assert max(share) <= 0.01, share
    np.testing.assert_allclose(trows, jrows, atol=HALF_LOGIT_TOL[family, dtype], rtol=0)
    np.testing.assert_array_equal(ttoks, jtoks)


@pytest.mark.parametrize("dtype_name", ["float16", "bfloat16"])
@pytest.mark.parametrize("family", ["opt", "llama"])
def test_half_cache_calls_the_attention_wrappers(monkeypatch, family, dtype_name):
    """On the path of test_half_cache_matches_jax: the prefill one B3 a
    layer over f32 q/k/v; Llama's chunk one B3 a layer over an f32 q and
    the cache's 16-bit K/V (OPT's chunk none: its modular sdpa); each step
    one B4 a layer over the 16-bit cache, q f32; and the routes those
    calls take on the card."""
    dtype = getattr(torch, dtype_name)
    cfg = OPT_CFG if family == "opt" else LLAMA_CFG
    _, tm = _build(family, cfg)
    ids = _prompt(cfg["vocab_size"], PROMPT + CHUNK, 11)
    calls = []
    real_b3, real_b4 = tfa.flash_attention, tfd.flash_decode

    def b3(q, k, v, *a, **kw):
        calls.append(("b3", q.dtype, k.dtype, tfa.attention_route(
            "flash_attention", 1, 1, q.shape[-1], (q.dtype, k.dtype, v.dtype))))
        return real_b3(q, k, v, *a, **kw)

    def b4(q, k, v, *a, **kw):
        calls.append(("b4", q.dtype, k.dtype, tfa.attention_route(
            "flash_decode", q.shape[1], k.shape[1], q.shape[-1], (q.dtype, k.dtype, v.dtype))))
        return real_b4(q, k, v, *a, **kw)

    for mod in (tfa, topt):
        if hasattr(mod, "flash_attention"):
            monkeypatch.setattr(mod, "flash_attention", b3)
    monkeypatch.setattr(tfd, "flash_decode", b4)
    monkeypatch.setattr(topt, "flash_decode", b4)
    _run_port(tm, tm.init_cache(B, CAP, dtype=dtype, device="cpu"), ids, CHUNK)
    L = cfg["num_hidden_layers"]
    f32 = torch.float32
    half = "f16" if dtype == torch.float16 else "bf16"
    want = [("b3", f32, f32, None)] * L
    if family == "llama":
        want += [("b3", f32, dtype, "upcast")] * L
    want += [("b4", f32, dtype, half)] * (L * STEPS)
    assert calls == want


def _wide_cfg(kind):
    H, Hkv, D, quantized = WIDE_CFGS[kind]
    return dict(vocab_size=128, hidden_size=H * D, intermediate_size=128, num_hidden_layers=2,
                num_attention_heads=H, num_key_value_heads=Hkv,
                max_position_embeddings=64), quantized


@pytest.mark.parametrize("kind", list(WIDE_CFGS))
def test_wide_llama_matches_jax(kind):
    """The wide Llamas: a prefill and 4 greedy steps (the int8 cache's
    prefill through ``quantized_sdpa``, its steps through B2's plain
    version; the f32 cache's through B3's and B4's); logits within
    WIDE_TOL, tokens equal; and the routes the card takes for them."""
    cfg, quantized = _wide_cfg(kind)
    H, Hkv, D, _ = WIDE_CFGS[kind]
    jm, tm = _build("llama", cfg)
    ids = _prompt(cfg["vocab_size"], 8, 12)
    jrows, jtoks = _run_jax(jm, jm.init_cache(B, CAP, quantized=quantized), ids, 0)
    trows, ttoks = _run_port(tm, tm.init_cache(B, CAP, quantized=quantized, device="cpu"),
                             ids, 0)
    np.testing.assert_allclose(trows, jrows, atol=WIDE_TOL[quantized], rtol=0)
    np.testing.assert_array_equal(ttoks, jtoks)
    if quantized:
        want = "grouped" if H // Hkv > tfa.b2_group(D) and D % 8 == 0 and D <= 256 else "generic"
        assert tfa.attention_route("flash_decode_int8", H, Hkv, D) == want
    else:
        f32 = (torch.float32,) * 3
        assert tfa.attention_route("flash_decode", H, Hkv, D, f32) == "generic"
        assert tfa.attention_route("flash_attention", 1, 1, D, f32) == (
            "generic" if D > 256 else None)


# ---------------------------------------------------------------------------
# attention_route
# ---------------------------------------------------------------------------

KINDS = ("flash_attention", "flash_decode", "flash_decode_int8")
DTYPES = (torch.float32, torch.float16, torch.bfloat16)


@pytest.mark.parametrize("kernel", KINDS)
def test_attention_route_refuses_nothing_jax_computes(kernel):
    """Every head_dim from 1 to 600 and 1 000 and 4 096, every query-head
    group up to 80 and Falcon-7B's 71, every dtype combination: a route,
    never a ValueError; a head count that Hkv does not divide (which JAX
    cannot compute either) raises."""
    dims = list(range(1, 601)) + [1000, 4096]
    groups = [(H, Hkv) for Hkv in (1, 2, 4, 8) for H in range(Hkv, 81 * Hkv, Hkv)] + [(71, 1)]
    seen = set()
    for D in dims:
        for H, Hkv in groups if D in (64, 100, 128, 256, 512) else [(8, 2), (71, 1)]:
            for dts in ((a, b, b) for a in DTYPES for b in DTYPES):
                seen.add(tfa.attention_route(kernel, H, Hkv, D, dts))
    for H, Hkv in ((5, 2), (12, 8), (3, 0)):
        with pytest.raises(ValueError):
            tfa.attention_route(kernel, H, Hkv, 64)
    assert seen == {"flash_attention": {None, "upcast", "generic"},
                    "flash_decode": {None, "f16", "bf16", "generic"},
                    "flash_decode_int8": {None, "grouped", "generic"}}[kernel]


# today's paths (PERF.md §4): (kernel, H, Hkv, D) over f32 operands
TODAYS_PATHS = {
    "OPT-125m B2 / B3 / B4": [("flash_decode_int8", 12, 12, 64), ("flash_attention", 1, 1, 64),
                             ("flash_decode", 12, 12, 64)],
    "llama-1.1b": [("flash_decode_int8", 32, 4, 64), ("flash_decode", 32, 4, 64)],
    "qwen3-0.6b": [("flash_decode_int8", 16, 8, 128), ("flash_attention", 1, 1, 128)],
    "gemma-2b": [("flash_decode_int8", 8, 1, 256), ("flash_decode", 8, 1, 256),
                 ("flash_attention", 1, 1, 256)],
    "hf_head_dim80": [("flash_decode_int8", 32, 32, 80), ("flash_decode", 32, 32, 80),
                      ("flash_attention", 1, 1, 80)],
    "tp-2 ranks": [("flash_decode_int8", 6, 6, 64), ("flash_decode_int8", 16, 2, 64),
                   ("flash_decode_int8", 4, 1, 256)],
}


@pytest.mark.parametrize("path", list(TODAYS_PATHS))
def test_attention_route_keeps_todays_paths(path):
    """The shapes today's paths hand B2, B3 and B4 in f32 keep the main
    route (no route counted), as before this route existed."""
    for kernel, H, Hkv, D in TODAYS_PATHS[path]:
        assert tfa.attention_route(kernel, H, Hkv, D, (torch.float32,) * 3) is None


@pytest.mark.parametrize("kernel,H,Hkv,D,dtypes,want", [
    ("flash_decode", 12, 12, 64, (torch.float32, torch.bfloat16, torch.bfloat16), "bf16"),
    ("flash_decode", 32, 4, 80, (torch.bfloat16, torch.float16, torch.float16), "f16"),
    ("flash_decode", 12, 12, 64, (torch.float32, torch.float16, torch.bfloat16), None),
    ("flash_decode", 12, 12, 64, (torch.float32, torch.float64, torch.float64), None),
    ("flash_decode", 4, 4, 84, (torch.float32, torch.bfloat16, torch.bfloat16), "generic"),
    ("flash_decode", 4, 4, 264, (torch.float32,) * 3, "generic"),
    ("flash_attention", 1, 1, 64, (torch.float32, torch.bfloat16, torch.bfloat16), "upcast"),
    ("flash_attention", 1, 1, 100, (torch.float32,) * 4, None),
    ("flash_attention", 1, 1, 64, (torch.float32,) * 3 + (torch.bfloat16,), "upcast"),
    ("flash_attention", 1, 1, 257, (torch.bfloat16,) * 3, "generic"),
    ("flash_decode_int8", 48, 1, 128, (), "grouped"),
    ("flash_decode_int8", 32, 1, 128, (), None),
    ("flash_decode_int8", 17, 1, 256, (), "grouped"),
    ("flash_decode_int8", 16, 1, 136, (), None),
    ("flash_decode_int8", 64, 1, 100, (), "generic"),
])
def test_attention_route_names_the_new_routes(kernel, H, Hkv, D, dtypes, want):
    assert tfa.attention_route(kernel, H, Hkv, D, dtypes) == want


F32 = (torch.float32,) * 3


# B3's wgmma route: head_dim 128, f32 q / k / v, no bias, from
# WGMMA_MIN_KEYS keys (WGMMA_MIN_KEYS_GQA where Hkv < H); (H, Hkv, D,
# dtypes, S, want)
@pytest.mark.parametrize("H,Hkv,D,dtypes,S,want", [
    (16, 8, 128, F32, 4096, "wgmma"),                    # Qwen3's scoring
    (16, 8, 128, F32, 128, "wgmma"),                     # its bring-up prefill
    (16, 8, 128, F32, 127, None),
    (8, 1, 128, F32, 128, "wgmma"),
    (16, 16, 128, F32, 144, "wgmma"),
    (16, 16, 128, F32, 143, None),
    (16, 16, 128, F32, 128, None),                       # MHA below the crossover
    (16, 8, 128, F32 + (torch.float32,), 4096, None),    # a bias
    (16, 8, 128, (torch.bfloat16,) * 3, 4096, "upcast"),
    (16, 8, 128, (torch.float32, torch.float16, torch.float16), 4096, "upcast"),
    (16, 8, 64, F32, 4096, None),
    (16, 8, 80, F32, 4096, None),                        # padded to 128, not on the route
    (8, 1, 256, F32, 4096, None),
    (16, 8, 512, F32, 4096, "generic"),
    (16, 8, 128, F32, None, None),                       # keys not given: today's route
])
def test_attention_route_names_the_wgmma_route(H, Hkv, D, dtypes, S, want):
    assert tfa.attention_route("flash_attention", H, Hkv, D, dtypes, S=S) == want


@pytest.mark.parametrize("route,H,Hkv,S,D,chunk,want", [
    (None, 12, 12, 256, 64, tfd.B4_CHUNK, (1, 12)),
    ("bf16", 32, 4, 3000, 64, tfd.B4_CHUNK, (3, 4)),
    (None, 12, 12, 600, 64, tfd.B2_CHUNK, (3, 12)),
    ("grouped", 48, 1, 600, 128, tfd.B2_CHUNK, (3, 2)),
    ("grouped", 71, 1, 256, 64, tfd.B2_CHUNK, (1, 3)),
    ("grouped", 80, 2, 256, 136, tfd.B2_CHUNK, (1, 6)),
    ("generic", 24, 2, 700, 100, tfd.B4_CHUNK, (3, 4)),
    ("generic", 8, 8, 256, 512, tfd.B2_CHUNK, (1, 8)),
])
def test_decode_grid_follows_the_route(route, H, Hkv, S, D, chunk, want):
    """(chunks a row, tickets a batch row) as the kernels' C entry points
    size their grids: CHUNK keys a block on the main and grouped routes,
    GENERIC_CHUNK on the generic one; one ticket a (KV head, head group)."""
    assert tfd._decode_grid(route, H, Hkv, S, D, chunk) == want
