"""The port's continuous-batching engine and row caches against the JAX
package's, on the CPU.

The tiny OPT of tests/test_serving.py is built by the JAX package and its
weights are carried into the port with ``load_jax_params``.  The same
submissions go through both engines in lockstep, and every ``step()`` must
return the same results (request id, tokens, finish reason) with the same
admission and chunk counters; the port's tokens must also equal its own
isolated generation (a batch-1 cache at the prompt's true length).  The
JAX side is built with ``DMX_DECODE_FUSED=1``, so its packed linears compute
in f32 from the int8 payload as the port's do.  Sampling is held by
statistics: the JAX and torch random streams differ."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from flax import nnx

from dmx_compressor_tpu.functional.approximate import NoApproximation as JNoApprox
from dmx_compressor_tpu.modeling.model import DmxModel as JDmxModel
from dmx_compressor_tpu.models.opt import OPTConfig as JOPTConfig
from dmx_compressor_tpu.models.opt import OPTForCausalLM as JOPT
from dmx_compressor_tpu.ops import compress as jcompress
from dmx_compressor_tpu.ops import kv_cache as jkv
from dmx_compressor_tpu.serving import ContinuousBatchingEngine as JEngine
from dmx_compressor_tpu.serving import engine as jengine

from dmx_compressor_tpu_torch.models.opt import (
    OPTConfig,
    OPTForCausalLM,
    greedy_decode,
    greedy_prefill,
    load_jax_params,
    take_rows,
)
from dmx_compressor_tpu_torch.nn.core import DmxModule
from dmx_compressor_tpu_torch.ops import compress as tcompress
from dmx_compressor_tpu_torch.ops import kv_cache as tkv
from dmx_compressor_tpu_torch.serving import ContinuousBatchingEngine, GenerationResult
from dmx_compressor_tpu_torch.serving import engine as tengine

torch.set_num_threads(2)

CFG = dict(vocab_size=97, hidden_size=64, ffn_dim=128, num_hidden_layers=2,
           num_attention_heads=4, max_position_embeddings=64)
# BASIC at head_dim 64 and a 64-slot cache, whose decode attention takes the
# fused basic_sdpa_decode (its BFP block of 64 divides both)
BASIC_CFG = dict(CFG, hidden_size=128, ffn_dim=256, num_attention_heads=2)
RNG = np.random.default_rng(0)


def prompts(*lens):
    return [RNG.integers(1, CFG["vocab_size"], (n,)).astype(np.int32) for n in lens]


def flat_params(model):
    return {".".join(str(p) for p in path): np.asarray(v.get_value())
            for path, v in nnx.to_flat_state(nnx.state(model))}


def _weights_config(jdm):
    jdm.to_basic_mode()
    for _, m in jdm.named_dmx_modules():
        m.input_casts.set_format(["SAME"] * len(m.input_casts))
        m.output_casts.set_format(["SAME"] * len(m.output_casts))
        m.approximator.function = JNoApprox()


@pytest.fixture(scope="module")
def models():
    """(JAX model, port model) per configuration: raw, weights-only packed
    BFP (SAME casts) and full BASIC (at ``BASIC_CFG``), each from the JAX
    model of seed 0."""
    prev = DmxModule.inference_mode
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("DMX_DECODE_FUSED", "1")
        for kind in ("raw", "weights", "basic"):
            cfg = BASIC_CFG if kind == "basic" else CFG
            jm = JOPT(JOPTConfig(**cfg), rngs=nnx.Rngs(0))
            tm = OPTForCausalLM(OPTConfig(**cfg), device="cpu")
            load_jax_params(tm, flat_params(jm))
            if kind == "weights":
                _weights_config(JDmxModel.from_raw(jm))
                jcompress.compress_for_inference(jm)
                tcompress.build_weights_mode(tm)
            elif kind == "basic":
                JDmxModel.from_raw(jm).to_basic_mode()
                jcompress.compress_for_inference(jm)
                tcompress.build_basic_mode(tm)
            out[kind] = (jm, tm)
    DmxModule.inference_mode = prev
    return out


@pytest.fixture(autouse=True)
def _inference_mode_on_both_sides():
    """Serving runs in inference mode (values unchanged, no gradient path),
    entered and left on both sides by each package's ``inference_mode()``."""
    with jcompress.inference_mode(), tcompress.inference_mode():
        yield


def busy(e):
    return bool(e.queue or e._prefilling or e._pending or any(s.active for s in e.slots))


def results(rs):
    return [(r.request_id, r.tokens, r.finish_reason) for r in rs]


def lockstep(pair, subs, burst=1, on_step=None, **kw):
    """Both engines built with ``kw``, the same submissions, stepped in
    lockstep; every step's results and counters equal.  ``on_step(engines,
    i)`` may submit more after step i.  Returns the port engine, its results
    by request id and the JAX engine."""
    jm, tm = pair
    je, te = JEngine(jm, **kw), ContinuousBatchingEngine(tm, **kw)
    for s in subs:
        assert je.submit(**s) == te.submit(**s)
    i = 0
    while busy(je) or busy(te):
        assert busy(je) == busy(te), f"step {i}"
        want, got = results(je.step(burst)), results(te.step(burst))
        assert got == want, f"step {i}"
        assert (te.last_step_admissions, te.last_step_chunks) == (
            je.last_step_admissions, je.last_step_chunks), f"step {i}"
        if on_step is not None:
            on_step((je, te), i)
        i += 1
        assert i < 500
    je._sync_to_live()
    return te, {r.request_id: r for r in te.finished}, je


def isolated(tm, prompt, n_new, quantized=False, max_len=48):
    """The port's isolated greedy generation: a batch-1 cache at the
    prompt's true length."""
    caches = tm.init_cache(1, max_len, quantized=quantized, device="cpu")
    _, tok = greedy_prefill(tm, caches, torch.from_numpy(prompt[None]))
    if n_new == 1:
        return [int(tok[0])]
    toks, _ = greedy_decode(tm, caches, tok, int(prompt.size), n_new - 1)
    return [int(tok[0])] + toks[0].tolist()


def check_isolated(tm, res, rids, ps, gens, quantized=False, max_len=48):
    for i, (rid, p, g) in enumerate(zip(rids, ps, gens)):
        assert res[rid].tokens == isolated(tm, p, g, quantized, max_len), f"request {i}"


# ---------------------------------------------------------------------------
# the engine, step for step against the JAX engine
# ---------------------------------------------------------------------------


def test_single_request(models):
    (p,) = prompts(7)
    te, res, _ = lockstep(models["raw"], [dict(prompt_ids=p, max_new_tokens=6)],
                          max_slots=2, max_len=48, prompt_buckets=(8, 16))
    assert len(res) == 1 and res[0].finish_reason == "length"
    check_isolated(models["raw"][1], res, [0], [p], [6])


@pytest.mark.parametrize("burst,depth", [(1, 1), (2, 0), (3, 2)])
def test_mixed_lengths_slot_reuse_and_pipelining(models, burst, depth):
    """Four prompts through two slots: queueing, decode at different
    offsets, slot reuse; with a burst and with other pipeline depths."""
    ps = prompts(3, 11, 8, 5)
    gens = [5 + i for i in range(4)]
    te, res, _ = lockstep(models["raw"], [dict(prompt_ids=p, max_new_tokens=g)
                                          for p, g in zip(ps, gens)],
                          burst=burst, max_slots=2, max_len=48, prompt_buckets=(4, 8, 16),
                          pipeline_depth=depth)
    check_isolated(models["raw"][1], res, range(4), ps, gens)


def test_eos_stops_early_and_frees_slot(models):
    tm = models["raw"][1]
    p, q = prompts(6, 6)
    ref = isolated(tm, p, 12)
    eos = ref[2]
    stop = ref.index(eos) + 1
    te, res, _ = lockstep(models["raw"], [dict(prompt_ids=p, max_new_tokens=12, eos_token_id=eos),
                                          dict(prompt_ids=q, max_new_tokens=3)],
                          max_slots=1, max_len=48, prompt_buckets=(8,))
    assert res[0].finish_reason == "eos" and res[0].tokens == ref[:stop]
    assert res[1].tokens == isolated(tm, q, 3)


@pytest.mark.parametrize("kind,max_len", [("weights", 48), ("basic", 64)])
def test_engine_under_quantized_configs(models, kind, max_len, monkeypatch):
    """Weights-only packed BFP (SAME casts), and full BASIC mode, whose
    decode steps run the fused BASIC layer step and, over the whole f32 row
    cache with per-row masks, ``basic_sdpa_decode`` (JAX opt.py:266-283):
    once per layer and decode forward."""
    from dmx_compressor_tpu_torch.models import opt as topt

    masks = []
    real = topt.basic_sdpa_decode
    monkeypatch.setattr(topt, "basic_sdpa_decode",
                        lambda *a, **k: masks.append(tuple(a[3].shape)) or real(*a, **k))
    ps = prompts(5, 9)
    te, res, _ = lockstep(models[kind], [dict(prompt_ids=p, max_new_tokens=4) for p in ps],
                          max_slots=2, max_len=max_len, prompt_buckets=(8, 16))
    if kind == "basic":
        L = BASIC_CFG["num_hidden_layers"]
        assert masks and len(masks) % L == 0 and set(masks) == {(2, 1, 1, max_len)}
    else:
        assert not masks
    check_isolated(models[kind][1], res, range(2), ps, [4, 4], max_len=max_len)


def test_int8_kv_cache(models):
    ps = prompts(5, 9)
    te, res, _ = lockstep(models["raw"], [dict(prompt_ids=p, max_new_tokens=4) for p in ps],
                          max_slots=2, max_len=48, prompt_buckets=(8, 16), quantized_kv=True)
    assert isinstance(te.caches[0], tkv.RowQuantizedKVCache)
    check_isolated(models["raw"][1], res, range(2), ps, [4, 4], quantized=True)


def test_burst_equals_single_step(models):
    """Burst decoding (several tokens a dispatch, each step's token kept on
    the device) gives the trajectories of stepwise decode, mid-burst eos
    truncation and mid-run admission included."""
    tm = models["raw"][1]
    ps = prompts(5, 9, 4)
    eos = isolated(tm, ps[0], 9)[1]
    subs = [dict(prompt_ids=ps[0], max_new_tokens=9, eos_token_id=eos),
            dict(prompt_ids=ps[1], max_new_tokens=7), dict(prompt_ids=ps[2], max_new_tokens=5)]

    def run(burst):
        _, res, _ = lockstep(models["raw"], subs, burst=burst, max_slots=2, max_len=48,
                             prompt_buckets=(8, 16))
        return [(res[r].tokens, res[r].finish_reason) for r in range(3)]

    assert run(3) == run(1)


def test_submit_validations(models):
    eng = ContinuousBatchingEngine(models["raw"][1], max_slots=1, max_len=32,
                                   prompt_buckets=(8,))
    with pytest.raises(AssertionError):
        eng.submit(np.arange(9), max_new_tokens=2)  # exceeds the largest bucket
    with pytest.raises(AssertionError):
        eng.submit(np.arange(4), max_new_tokens=40)  # exceeds max_len
    with pytest.raises(AssertionError):
        eng.submit(np.arange(0), max_new_tokens=2)  # empty
    with pytest.raises(AssertionError):
        ContinuousBatchingEngine(models["raw"][1], max_len=8, prompt_buckets=(16,))


@pytest.mark.parametrize("kind,quantized", [("raw", False), ("weights", True)])
def test_chunked_prefill_matches_isolated(models, kind, quantized):
    """Prompts longer than the chunk prefill a chunk per step (the first at
    offset 0 through B3's route, the rest masked); short prompts take the
    single prefill."""
    long_p, short_p = prompts(21, 5)
    te, res, _ = lockstep(models[kind], [dict(prompt_ids=long_p, max_new_tokens=6),
                                         dict(prompt_ids=short_p, max_new_tokens=6)],
                          max_slots=2, max_len=48, prompt_buckets=(8, 24), prefill_chunk=8,
                          quantized_kv=quantized)
    check_isolated(models[kind][1], res, range(2), [long_p, short_p], [6, 6], quantized)


def test_chunked_prefill_interleaves_decode(models):
    """A resident slot emits one token a step while a 22-token prompt
    prefills over three chunk steps."""
    resident, newcomer = prompts(5, 22)
    seen = []

    def on_step(engines, i):
        je, te = engines
        if i == 1:
            assert len(te.slots[0].generated) >= 1
            for e in engines:
                e.submit(newcomer, max_new_tokens=4)
        elif 2 <= i <= 4:
            assert 1 in te._prefilling or te.slots[1].active
            seen.append(len(te.slots[0].generated))

    te, res, _ = lockstep(models["raw"], [dict(prompt_ids=resident, max_new_tokens=12)],
                          on_step=on_step, max_slots=2, max_len=64, prompt_buckets=(8, 24),
                          prefill_chunk=8)
    assert seen == [seen[0] + i for i in range(3)]
    check_isolated(models["raw"][1], res, range(2), [resident, newcomer], [12, 4], max_len=64)


def test_chunked_prefill_quantized_kv_equals_monolithic(models):
    (p,) = prompts(19)
    kw = dict(max_slots=1, max_len=48, prompt_buckets=(24,), quantized_kv=True)
    _, mono, _ = lockstep(models["raw"], [dict(prompt_ids=p, max_new_tokens=6)], **kw)
    _, chunked, _ = lockstep(models["raw"], [dict(prompt_ids=p, max_new_tokens=6)],
                             prefill_chunk=8, **kw)
    assert chunked[0].tokens == mono[0].tokens


def test_warmup_then_results_unchanged(models):
    """warmup() runs one full-bucket request per bucket (the bucket-16
    prompt over chunks of 4) and leaves nothing behind."""
    jm, tm = models["raw"]
    kw = dict(max_slots=2, max_len=48, prompt_buckets=(8, 16), prefill_chunk=4)
    je, te = JEngine(jm, **kw), ContinuousBatchingEngine(tm, **kw)
    started = []
    real = te._start_chunked
    te._start_chunked = lambda b, req: started.append(req.prompt.size) or real(b, req)
    je.warmup(burst=2)
    te.warmup(burst=2)
    assert started == [8, 16]
    assert not te.finished and not te.queue and not busy(te)
    ps = prompts(7, 11)
    for p in ps:
        assert je.submit(p, max_new_tokens=4) == te.submit(p, max_new_tokens=4)
    assert results(te.run()) == results(je.run())
    check_isolated(tm, {r.request_id: r for r in te.finished}, [2, 3], ps, [4, 4])


def test_chunk_cadence_finishes_admission_in_one_step(models):
    resident, newcomer = prompts(5, 22)

    def on_step(engines, i):
        je, te = engines
        if i == 0:
            for e in engines:
                e.submit(newcomer, max_new_tokens=4)
        elif i == 1:  # 22 tokens = 3 chunks, all consumed this step
            assert 1 not in te._prefilling and te.slots[1].active
            assert te.last_step_chunks == 3

    te, res, _ = lockstep(models["raw"], [dict(prompt_ids=resident, max_new_tokens=12)],
                          on_step=on_step, max_slots=2, max_len=64, prompt_buckets=(8, 24),
                          prefill_chunk=8, chunks_per_step=3)
    check_isolated(models["raw"][1], res, range(2), [resident, newcomer], [12, 4], max_len=64)


def test_queue_fed_turnover_readmits_in_drain_step(models):
    ps = prompts(5, 6, 7)
    te, res, _ = lockstep(models["raw"], [dict(prompt_ids=p, max_new_tokens=3) for p in ps],
                          max_slots=1, max_len=48, prompt_buckets=(8,))
    check_isolated(models["raw"][1], res, range(3), ps, [3, 3, 3])
    # a retirement and a readmission inside one step
    eng = ContinuousBatchingEngine(models["raw"][1], max_slots=1, max_len=48,
                                   prompt_buckets=(8,))
    for p in ps:
        eng.submit(p, max_new_tokens=3)
    same_step = 0
    while busy(eng):
        n_done = len(eng.finished)
        eng.step()
        same_step += len(eng.finished) > n_done and eng.last_step_admissions > 0
    assert same_step >= 1


def test_per_request_sampling(models):
    """A greedy row is unaffected by a sampled neighbour, sampled tokens are
    valid, sampling is deterministic per seed and the seed steers it."""
    tm = models["raw"][1]
    pg, ps_ = prompts(6, 8)

    def run(seed):
        eng = ContinuousBatchingEngine(tm, max_slots=2, max_len=48, prompt_buckets=(8,),
                                       top_k=5, seed=seed)
        rg = eng.submit(pg, max_new_tokens=5)
        rs = eng.submit(ps_, max_new_tokens=5, temperature=1.0)
        res = {r.request_id: r for r in eng.run()}
        return res[rg].tokens, res[rs].tokens

    g1, s1 = run(0)
    assert g1 == isolated(tm, pg, 5)
    assert run(0) == (g1, s1)
    assert all(0 <= t < CFG["vocab_size"] for t in s1)
    assert any(run(seed)[1] != s1 for seed in (3, 5, 7, 11))


def test_idle_rows_past_max_len_and_the_position_table(models):
    """An idle slot keeps decoding garbage: its row cache clamps its writes
    to the last window past max_len (48) and its positions run past the
    table (64 + 2), where the lookup gives NaN in that row only; the other
    rows' results are unchanged, step for step as in the JAX engine, and
    the fill points grow alike on both sides."""
    a, b, c = prompts(5, 5, 5)
    lengths, submitted = [], []

    def on_step(engines, i):
        je, te = engines
        if len(te.finished) == 2 and not submitted:  # slot 0 free: c goes there
            submitted.append(i)
            for e in engines:
                e.submit(c, max_new_tokens=40)
        lengths.append(te.caches[0].lengths.tolist())

    te, res, je = lockstep(models["raw"], [dict(prompt_ids=a, max_new_tokens=40),
                                           dict(prompt_ids=b, max_new_tokens=1)],
                           on_step=on_step, burst=2, max_slots=2, max_len=48,
                           prompt_buckets=(8,))
    idle = max(row[1] for row in lengths)
    assert idle > CFG["max_position_embeddings"] + 2  # past the table, so NaN rows
    assert te.caches[0].lengths.tolist() == np.asarray(je.caches[0].lengths.value).tolist()
    assert not torch.isfinite(te.caches[0].k[1, :, 47]).all()  # the clamped window
    assert torch.isfinite(te.caches[0].k[0]).all()
    check_isolated(models["raw"][1], res, range(3), [a, b, c], [40, 1, 40])


def test_readmission_over_a_nan_window_differs_from_jax_on_the_cpu(models):
    """A difference from the JAX package kept on purpose.  A slot readmitted
    after idling past the position table keeps NaN keys and values in its
    clamped last window, beyond its new length.  On the CPU the JAX engine
    attends over the whole cache with the mask added to the scores (its
    flash-decode kernel is TPU-only): NaN + mask stays NaN and 0 x NaN is
    NaN, so the readmitted request's tokens become -1.  The port's decode
    kernels read only the keys below each row's length, and their plain
    versions leave the rest out too, so its tokens equal isolated
    generation."""
    a, b, c, d, e = prompts(5, 5, 5, 5, 6)
    finished, submitted = [], []

    def on_step(engines, i):
        je, te = engines
        if len(te.finished) == 2 and not submitted:  # slot 0 free: c goes there
            submitted.append(i)
            for x in engines:
                x.submit(c, max_new_tokens=40)
        if len(te.finished) == 3 and not finished:
            finished.append(i)
            for x in engines:
                x.submit(d, max_new_tokens=6)
                x.submit(e, max_new_tokens=6)  # into the slot with the NaN window

    jm, tm = models["raw"]
    kw = dict(max_slots=2, max_len=48, prompt_buckets=(8,))
    je, te = JEngine(jm, **kw), ContinuousBatchingEngine(tm, **kw)
    for p, g in ((a, 40), (b, 1)):
        je.submit(p, max_new_tokens=g)
        te.submit(p, max_new_tokens=g)
    i = 0
    while busy(je) or busy(te):
        je.step(2)
        te.step(2)
        on_step((je, te), i)
        i += 1
        assert i < 500
    jres = {r.request_id: r.tokens for r in je.finished}
    tres = {r.request_id: r.tokens for r in te.finished}
    assert tres[4] == isolated(tm, e, 6)
    assert -1 in jres[4]  # the JAX engine on the CPU: NaN logits
    assert tres[3] == jres[3] == isolated(tm, d, 6)


def test_serving_safety_check(models):
    """A decode step keeps only the caches: an enabled observer fails the
    first dispatch."""
    tm = models["weights"][1]
    cast = next(m for m in tm.modules() if isinstance(m, tengine.CastTo))
    eng = ContinuousBatchingEngine(tm, max_slots=1, max_len=48, prompt_buckets=(8,))
    eng.submit(prompts(5)[0], max_new_tokens=2)
    cast.observer_enabled = True
    try:
        with pytest.raises(AssertionError, match="observer enabled"):
            eng.run()
    finally:
        cast.observer_enabled = False


def test_generation_result_and_inference_mode():
    assert [f for f in GenerationResult.__dataclass_fields__] == [
        f for f in jengine.GenerationResult.__dataclass_fields__]
    prev = DmxModule.inference_mode
    DmxModule.inference_mode = False
    with tcompress.inference_mode():
        assert DmxModule.inference_mode
        with tcompress.inference_mode():
            pass
        assert DmxModule.inference_mode
    assert DmxModule.inference_mode is False
    DmxModule.inference_mode = prev


# ---------------------------------------------------------------------------
# row caches against the JAX package's
# ---------------------------------------------------------------------------


def _jrow(x):
    """A JAX s_minor buffer [B, H, D, S] in the port's [B, H, S, D]."""
    return np.asarray(x).swapaxes(-1, -2)


def _rand(rs, *shape):
    return rs.standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("quantized", [False, True])
def test_row_cache_updates_and_write_row_match_jax(quantized):
    """write_row then per-row appends of T = 1 and T = 2, rows at different
    fill points, one driven past max_len (it writes its last window, its
    fill point keeps growing): f32 buffers and int8 payloads bit for bit,
    scales at rtol 1e-6 (the quantizer on equal inputs), lengths exact."""
    rs = np.random.RandomState(7)
    B, H, S, D = 3, 2, 8, 4
    jc = (jkv.RowQuantizedKVCache if quantized else jkv.RowKVCache)(B, H, S, D)
    tc = tkv.make_caches(1, B, H, S, D, quantized=quantized, device="cpu", per_row=True)[0]
    assert isinstance(tc, tkv.RowQuantizedKVCache if quantized else tkv.RowKVCache)
    for b, T, length in ((0, 2, 2), (1, 5, 4), (2, 7, None)):
        k, v = _rand(rs, H, T, D), _rand(rs, H, T, D)
        if quantized:
            kq, ks = tkv.QuantizedKVCache._quantize(torch.from_numpy(k))
            vq, vs = tkv.QuantizedKVCache._quantize(torch.from_numpy(v))
            jc.write_row(b, jnp.asarray(kq.numpy()).swapaxes(-1, -2),
                         jnp.asarray(vq.numpy()).swapaxes(-1, -2), jnp.asarray(ks.numpy()),
                         jnp.asarray(vs.numpy()), length=length)
            tc.write_row(b, kq, vq, ks, vs, length=length)
        else:
            jc.write_row(b, jnp.asarray(k).swapaxes(-1, -2), jnp.asarray(v).swapaxes(-1, -2),
                         length=length)
            tc.write_row(b, torch.from_numpy(k), torch.from_numpy(v), length=length)
    for T in (1, 2, 1, 1, 2, 1):
        k, v = _rand(rs, B, H, T, D), _rand(rs, B, H, T, D)
        if quantized:
            jkv_ = jc.update_quantized(jnp.asarray(k), jnp.asarray(v))
            tkv_ = tc.update_quantized(torch.from_numpy(k), torch.from_numpy(v))
            np.testing.assert_array_equal(tkv_.k_q.numpy(), _jrow(jkv_.k_q))
            np.testing.assert_array_equal(tkv_.v_q.numpy(), _jrow(jkv_.v_q))
            np.testing.assert_allclose(tkv_.k_scale.numpy(), np.asarray(jkv_.k_scale), rtol=1e-6)
            np.testing.assert_allclose(tkv_.v_scale.numpy(), np.asarray(jkv_.v_scale), rtol=1e-6)
            jk, jv, jlen = jc.update(jnp.asarray(k), jnp.asarray(v))
            tk, tv, tlen = tc.update(torch.from_numpy(k), torch.from_numpy(v))
            np.testing.assert_allclose(tk.numpy(), np.asarray(jk), rtol=1e-6)
        else:
            jk, jv, jlen = jc.update(jnp.asarray(k), jnp.asarray(v))
            tk, tv, tlen = tc.update(torch.from_numpy(k), torch.from_numpy(v))
            np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
            np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
        assert tlen.tolist() == np.asarray(jlen).tolist()
    grown = 16 if quantized else 8  # update_quantized and update both append
    assert tc.lengths.tolist() == [2 + grown, 4 + grown, 7 + grown]  # all past S = 8
    assert int(tc.length) == 7 + grown == int(jnp.max(jc.lengths.value))


def test_row_cache_keeps_its_fill_point_on_the_device():
    """The fill point is a tensor: no host integer, and ``length`` is a
    device scalar."""
    c = tkv.RowKVCache(2, 1, 8, 4, device="cpu")
    c.lengths.copy_(torch.tensor([0, 3], dtype=torch.int32))
    k = torch.ones(2, 1, 1, 4)
    kf, _, lens = c.update(k, 2 * k)
    assert lens is c.lengths and lens.tolist() == [1, 4]
    assert isinstance(c.length, torch.Tensor) and c.length.ndim == 0
    assert kf[0, 0, 0, 0] == 1 and kf[0, 0, 3, 0] == 0
    assert kf[1, 0, 3, 0] == 1 and kf[1, 0, 0, 0] == 0
    with pytest.raises(ValueError):
        tkv.make_caches(1, 2, 1, 8, 4, device="cpu", per_row=True, split_base_len=4)


def test_take_rows_matches_jnp_take():
    n = 5
    table = np.arange(n * 3, dtype=np.float32).reshape(n, 3)
    idx = np.array([[-7, -6, -5, -1], [0, 4, 5, 11]], np.int32)
    emb = torch.nn.Embedding(n, 3)
    with torch.no_grad():
        emb.weight.copy_(torch.from_numpy(table))
        got = take_rows(emb, torch.from_numpy(idx)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jnp.take(jnp.asarray(table), idx, axis=0)))


def test_idle_row_past_the_position_table_gives_nan_in_its_row_only(models):
    """One decode step over a row cache with per-row offsets, one row past
    the position table: its logits are NaN on both sides; the other rows'
    logits match JAX and are those of a step where that row is in range."""
    jm, tm = models["raw"]
    B, S = 3, 48
    toks = np.array([[3], [-1], [17]], np.int32)  # -1: a NaN row's argmax
    out = {}
    for far in (20, 64):
        lens = np.array([5, far, 12], np.int32)
        jc = jm.init_cache(B, S, per_row=True)
        tc = tm.init_cache(B, S, per_row=True, device="cpu")
        for c in jc:
            c.lengths.value = jnp.asarray(lens)
        for c in tc:
            c.lengths.copy_(torch.from_numpy(lens))
        jl = np.asarray(jm(jnp.asarray(toks), caches=jc, position_offset=jnp.asarray(lens)))
        with torch.no_grad():
            tl = tm(torch.from_numpy(toks), caches=tc,
                    position_offset=tc[0].lengths.clone()).numpy()
        np.testing.assert_allclose(tl, jl, atol=1e-4)  # NaN where JAX has NaN
        out[far] = tl
    assert np.isnan(out[64][1]).all() and np.isfinite(out[20]).all()
    np.testing.assert_array_equal(out[64][[0, 2]], out[20][[0, 2]])


# ---------------------------------------------------------------------------
# _pick: the sampler
# ---------------------------------------------------------------------------


def _logits(seed, B, V):
    lg = np.random.default_rng(seed).standard_normal((B, V)).astype(np.float32)
    lg[0, [3, 9]] = lg[0].max() + 1.0  # a tie at the top
    return lg


def test_pick_greedy_rows_equal_jax():
    lg = _logits(1, 4, 33)
    temps = np.array([0.0, 1.0, 0.0, 0.5], np.float32)
    want = np.asarray(jengine._pick(jnp.asarray(lg), jax.random.key(0), jnp.asarray(temps), 5))
    gen = torch.Generator().manual_seed(0)
    got = tengine._pick(torch.from_numpy(lg), gen, torch.from_numpy(temps), 5).numpy()
    np.testing.assert_array_equal(got[temps == 0], want[temps == 0])
    assert got[0] == 9  # the largest index among the maxima


def test_pick_samples_within_top_k_and_per_seed():
    B, V, k = 256, 40, 5
    lg = torch.from_numpy(_logits(2, B, V))
    lg[1, :] = 0.0  # every logit tied: all of them are kept
    temps = torch.full((B,), 0.8)

    def draw(seed):
        return tengine._pick(lg, torch.Generator().manual_seed(seed), temps, k)

    got = draw(3)
    kth = torch.sort(lg, dim=-1).values[:, -k]
    assert bool((lg.gather(1, got.long()[:, None])[:, 0] >= kth).all())
    assert torch.equal(got, draw(3))
    assert not torch.equal(got, draw(4))


def test_pick_frequencies_follow_the_truncated_softmax():
    """20k draws of one row: each token's count within 4 sigma of N p, p
    the temperature softmax over the top-k logits (0 outside them)."""
    N, k, temp = 20000, 5, 0.7
    row = np.array([1.2, -0.3, 0.8, 2.0, 0.1, -1.5, 0.9, 1.1], np.float32)
    lg = torch.from_numpy(np.tile(row, (N, 1)))
    got = tengine._pick(lg, torch.Generator().manual_seed(11), torch.full((N,), temp), k)
    counts = np.bincount(got.numpy(), minlength=row.size)
    top = np.argsort(row)[-k:]
    p = np.zeros(row.size)
    e = np.exp((row[top] - row[top].max()) / temp)
    p[top] = e / e.sum()
    sigma = np.sqrt(N * p * (1 - p))
    assert (counts[p == 0] == 0).all()
    assert (np.abs(counts - N * p) <= 4 * sigma + 1e-9).all(), (counts, N * p)


# ---------------------------------------------------------------------------
# examples/serving_bench.py
# ---------------------------------------------------------------------------


def test_serving_bench_prints_the_jax_scripts_json(monkeypatch, capsys):
    """The port's serving_bench at a tiny OPT on the CPU: one JSON line with
    the JAX script's keys.  ``--spread`` with gen / 4 above the burst runs
    (max_len from the longest generation), where the JAX script's submit()
    assertion fires."""
    import json
    import pathlib
    import re

    from dmx_compressor_tpu_torch.examples import serving_bench as sb

    monkeypatch.setitem(sb.CONFIGS, "opt-125m", lambda: OPTConfig(**CFG))
    sb.main(["opt-125m", "weights", "--device", "cpu", "--slots", "2", "--burst", "2",
             "--requests", "3", "--prompt", "8", "--gen", "16", "--spread", "--chunk", "4"])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    src = (pathlib.Path(__file__).parent.parent / "examples" / "serving_bench.py").read_text()
    jax_keys = re.findall(r'^\s+"(\w+)":', src.split("json.dumps(")[1], re.M)
    assert list(out) == jax_keys
    assert out["metric"] == "opt-125m_weights_serving_tokens_per_sec"
    assert out["requests"] == 3 and out["prefill_chunk"] == 4 and out["chunks_per_step"] == 1
    reqs = sb.make_requests(CFG["vocab_size"], 3, 8, 16, spread=True)
    assert max(g for _, g in reqs) > 16 + 2  # past the JAX script's max_len
