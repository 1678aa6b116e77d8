"""Continuous-batching serving throughput (serving/engine.py).

Port of ``examples/serving_bench.py``.  Measures aggregate decode tokens/s
of the slot engine under a closed-loop workload (every request is queued up
front and a waiting one is admitted the moment a slot frees), the
slot-utilization counterpart of fixed-batch decode.  From the root of a
checkout:

    python -m dmx_compressor_tpu_torch.examples.serving_bench \\
        [opt-125m|opt-350m|opt-1.3b] [raw|weights] [--slots N] [--burst N] \\
        [--requests N] [--prompt N] [--gen N] [--chunk N] [--cps N] \\
        [--depth N] [--spread] [--device cpu]

``weights`` packs BFP16_64 weights (``build_weights_mode``) and serves them
with an int8 row KV cache; ``raw`` serves the model as built, with an f32
row cache.  The model runs on the card unless ``--device cpu``; its weights
are random, from seed 0.  Prints one JSON line with tokens/s, slot
utilization and step times (the JAX script's keys).

One deviation from the JAX script: ``max_len`` is sized from the largest
``--spread`` generation length (prompt + that length + burst).  The JAX
script sizes it from ``--gen`` alone, so its submit() assertion fires
whenever gen / 4 exceeds the burst.
"""

from __future__ import annotations

import json
import sys
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..models.opt import OPTConfig, OPTForCausalLM
from ..ops.compress import build_weights_mode
from ..serving import ContinuousBatchingEngine, Seq2SeqBatchingEngine

CONFIGS = {"opt-125m": OPTConfig.opt_125m, "opt-350m": OPTConfig.opt_350m,
           "opt-1.3b": OPTConfig.opt_1_3b}


def build_model(name: str, mode: str, device=None, seed: int = 0) -> Tuple[OPTForCausalLM, bool]:
    """The model to serve and whether its KV cache is int8: ``weights``
    packs BFP16_64 weights (int8 KV), ``raw`` leaves the model as built
    (f32 KV)."""
    model = OPTForCausalLM(CONFIGS[name](), device=device, seed=seed)
    if mode == "weights":
        build_weights_mode(model)
        return model, True
    if mode != "raw":
        raise ValueError(f"mode {mode!r}: raw or weights")
    return model, False


def make_requests(vocab_size: int, n_requests: int, prompt_len: int, gen_len: int,
                  spread: bool, seed: int = 0) -> List[Tuple[np.ndarray, int]]:
    """(prompt, max_new_tokens) of each request, from ``seed``.  With
    ``spread`` the generation lengths vary over 0.75x-1.25x ``gen_len``
    (deterministically): uniform lengths make every slot finish in the same
    step, so admissions arrive in waves that idle the whole batch."""
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(1, vocab_size, (prompt_len,)).astype(np.int32)
               for _ in range(n_requests)]
    n = len(prompts)
    gens = [int(gen_len * (0.75 + 0.5 * ((i * 7) % n) / max(n - 1, 1))) if spread else gen_len
            for i in range(n)]
    return [(p, max(g, 1)) for p, g in zip(prompts, gens)]


def make_engine(model, quantized_kv: bool, requests, prompt_len: int, slots: int, burst: int,
                chunk: Optional[int], cps: int, depth: int) -> ContinuousBatchingEngine:
    """The engine for ``requests``: ``max_len`` = prompt + the longest
    generation + burst, one prompt bucket."""
    max_gen = max(g for _, g in requests)
    return ContinuousBatchingEngine(
        model, max_slots=slots, max_len=prompt_len + max_gen + burst,
        prompt_buckets=(prompt_len,), quantized_kv=quantized_kv,
        prefill_chunk=chunk, chunks_per_step=cps, pipeline_depth=depth,
    )


def make_seq2seq_engine(model, quantized_kv: bool, requests, slots: int, burst: int,
                        enc_capacity: Optional[int] = None) -> Seq2SeqBatchingEngine:
    """The encoder-decoder engine for ``requests`` (``(dict(encoder_input=,
    decoder_start_ids=), max_new_tokens)`` each): one prompt bucket of the
    start tokens' length, ``max_len`` = start + the longest generation +
    burst; ragged token-id inputs padded to ``enc_capacity``."""
    start = max(np.asarray(r.get("decoder_start_ids", [0])).size for r, _ in requests)
    max_gen = max(g for _, g in requests)
    return Seq2SeqBatchingEngine(
        model, max_slots=slots, max_len=start + max_gen + burst, prompt_buckets=(start,),
        quantized_kv=quantized_kv, enc_capacity=enc_capacity,
    )


def submit(eng: ContinuousBatchingEngine, prompt, gen: int) -> int:
    """Queue one request: ``prompt`` is a causal LM's prompt ids, or an
    encoder-decoder request's submit arguments (a dict)."""
    if isinstance(prompt, dict):
        return eng.submit(**prompt, max_new_tokens=gen)
    return eng.submit(prompt, max_new_tokens=gen)


def closed_loop(eng: ContinuousBatchingEngine, requests, burst: int) -> Dict:
    """Queue every request, then step the engine until all have finished.
    Returns the request ids, each step's wall time (host clock), whether it
    was steady (no admission and no chunk), its admissions and chunks, the
    busy and total slot-steps, the tokens emitted and the wall time."""
    rids = [submit(eng, p, g) for p, g in requests]

    def emitted():
        return (sum(len(r.tokens) for r in eng.finished)
                + sum(len(s.generated) for s in eng.slots if s.active))

    base = emitted()
    steps: List[Dict] = []
    busy_slot_steps = total_slot_steps = 0
    t0 = time.perf_counter()
    while eng.queue or eng._prefilling or eng._pending or any(s.active for s in eng.slots):
        ts = time.perf_counter()
        eng.step(burst)
        dt = time.perf_counter() - ts
        steps.append(dict(seconds=dt, admissions=eng.last_step_admissions,
                          chunks=eng.last_step_chunks,
                          steady=not (eng.last_step_admissions or eng.last_step_chunks)))
        busy_slot_steps += sum(1 for s in eng.slots if s.active)
        total_slot_steps += eng.max_slots
    wall = time.perf_counter() - t0
    return dict(rids=rids, steps=steps, busy_slot_steps=busy_slot_steps,
                total_slot_steps=total_slot_steps, tokens=emitted() - base, wall_s=wall)


def _pct(sorted_s: np.ndarray, q: float) -> float:
    return float(sorted_s[min(int(len(sorted_s) * q), len(sorted_s) - 1)])


def summary(stats: Dict) -> Dict:
    """tokens/s, slot utilization and the p50 / p99 step times (all steps,
    and the steady ones) of a :func:`closed_loop` run."""
    st = np.sort(np.asarray([s["seconds"] for s in stats["steps"]]))
    steady = [s["seconds"] for s in stats["steps"] if s["steady"]]
    sst = np.sort(np.asarray(steady if steady else st))
    return {
        "tokens_per_s": stats["tokens"] / stats["wall_s"],
        "slot_utilization": stats["busy_slot_steps"] / max(stats["total_slot_steps"], 1),
        "p50_step_ms": float(st[len(st) // 2]) * 1e3,
        "p99_step_ms": _pct(st, 0.99) * 1e3,
        "steady_p50_step_ms": float(sst[len(sst) // 2]) * 1e3,
        "steady_p99_step_ms": _pct(sst, 0.99) * 1e3,
        "steady_steps": len(steady),
    }


def main(argv=None) -> None:
    argv = sys.argv[1:] if argv is None else argv
    pos = [a for a in argv if not a.startswith("--")]
    name = pos[0] if len(pos) > 0 else "opt-125m"
    mode = pos[1] if len(pos) > 1 else "weights"

    def arg(flag, default):
        return int(argv[argv.index(flag) + 1]) if flag in argv else default

    slots = arg("--slots", 8)
    burst = arg("--burst", 16)
    n_requests = arg("--requests", 32)
    prompt_len = arg("--prompt", 96)
    gen_len = arg("--gen", 64)
    chunk = arg("--chunk", 0) or None  # chunked-prefill admission
    # chunk cadence: prompt consumption in step with a burst-token decode
    cps = arg("--cps", 0) or (max(1, burst // chunk) if chunk else 1)
    depth = arg("--depth", 1)  # pipelined readback
    device = argv[argv.index("--device") + 1] if "--device" in argv else None

    with torch.no_grad():
        model, quantized_kv = build_model(name, mode, device)
    requests = make_requests(model.cfg.vocab_size, n_requests, prompt_len, gen_len,
                             "--spread" in argv)
    eng = make_engine(model, quantized_kv, requests, prompt_len, slots, burst, chunk, cps, depth)
    # every dispatch shape once (chunk offsets, finalize, decode) before the
    # timed loop
    eng.warmup(burst)
    stats = closed_loop(eng, requests, burst)
    s = summary(stats)
    print(json.dumps({
        "metric": f"{name}_{mode}_serving_tokens_per_sec",
        "value": round(s["tokens_per_s"], 2),
        "unit": "tokens/s",
        "slots": slots,
        "burst": burst,
        "prefill_chunk": chunk,
        "chunks_per_step": cps if chunk else None,
        "pipeline_depth": depth,
        "prompt_len": prompt_len,
        "gen_len": gen_len,
        "requests": len(eng.finished),
        "slot_utilization": round(s["slot_utilization"], 3),
        "p50_step_ms": round(s["p50_step_ms"], 2),
        "p99_step_ms": round(s["p99_step_ms"], 2),
        "steady_p50_step_ms": round(s["steady_p50_step_ms"], 2),
        "steady_p99_step_ms": round(s["steady_p99_step_ms"], 2),
        "steady_steps": s["steady_steps"],
        "wall_s": round(stats["wall_s"], 3),
    }))


if __name__ == "__main__":
    main()
