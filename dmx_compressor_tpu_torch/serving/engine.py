"""Continuous-batching serving engine (slot-based, static shapes).

Port of ``ContinuousBatchingEngine``, ``Seq2SeqBatchingEngine``,
``GenerationResult`` and their helpers (``_slot_layout``, ``_write_rows``,
``_greedy``, ``_pick``) of ``dmx_compressor_tpu/serving/engine.py``.  The design is the JAX package's:

- **Fixed slots.**  The engine owns ``max_slots`` batch rows and a row KV
  cache of ``max_len`` positions per layer (``ops/kv_cache.RowKVCache`` or
  ``RowQuantizedKVCache``); shapes never change as requests come and go.
- **Per-row offsets.**  Each slot sits at its own fill point
  (``RowKVCache.lengths``, on the device); one decode dispatch advances
  every slot by one token with per-row positions and masks (the model's
  per-row ``position_offset``).
- **Prefill to a slot.**  A new request prefills alone (batch 1, prompt
  right-padded to a bucket) into a fresh batch-1 cache whose rows are then
  copied into the free slot.
- **Chunked prefill** (``prefill_chunk=N``): a prompt longer than N fills
  its batch-1 cache N tokens per engine step, interleaved with the resident
  slots' decode.

PyTorch runs eagerly and the modules are updated in place, so the JAX
package's jit caches and its split of the module state disappear: a
"dispatch" here is the launch sequence of one step, queued on the device
without waiting.  ``burst`` decode steps are a Python loop in which each
step's tokens stay on the device as the next step's input (the JAX
package's ``lax.scan``); the slots' last tokens and temperatures
(``_dtoks``, ``_dtemps``) live on the device, and a decode dispatch without
admission makes no host sync.  The tokens are read back later, in
:meth:`ContinuousBatchingEngine._apply_oldest` (``.tolist()``), the one
readback of the loop.

The engine runs where the model's parameters are: on the card unless the
model was built or moved to the CPU.
"""

from __future__ import annotations

import dataclasses
import inspect
import itertools
from collections import deque
from typing import List, Optional

import numpy as np
import torch

from ..models.shared import greedy_token
from ..numerics.cast import CastTo


def _slot_layout(row, cache):
    """A batch-1 cache row in the slot caches' layout: the identity, since
    the port's batch-1 and row caches are both D-minor ``[B, H, S, D]``
    (the JAX package swaps axes where a cache class is sequence-minor)."""
    return row


def _write_rows(slot_caches, b: int, caches, length: int, quantized: bool) -> None:
    """Install a freshly prefilled batch-1 cache into slot ``b`` of every
    layer's row cache."""
    for sc, c in zip(slot_caches, caches):
        if quantized:
            sc.write_row(b, _slot_layout(c.k_q[0], c), _slot_layout(c.v_q[0], c),
                         c.k_scale[0], c.v_scale[0], length=length)
        else:
            sc.write_row(b, _slot_layout(c.k[0], c), _slot_layout(c.v[0], c), length=length)


# greedy choice: the largest index among the maxima (the JAX package's tie
# rule), int32 [B]
_greedy = greedy_token


def _pick(logits: torch.Tensor, gen: torch.Generator, temps: torch.Tensor,
          top_k: Optional[int]) -> torch.Tensor:
    """Per-row token choice: greedy where ``temps`` == 0, otherwise a sample
    of the temperature softmax truncated to the ``top_k`` largest logits
    (ties at the k-th kept).  Sampling is Gumbel-max, as
    ``jax.random.categorical``: argmax(logit + Gumbel noise), the noise drawn
    from ``gen`` on the logits' device with no host sync."""
    greedy = _greedy(logits)
    lg = logits.to(torch.float32) / torch.clamp(temps, min=1e-6)[:, None]
    if top_k is not None:
        kth = torch.sort(lg, dim=-1).values[:, -top_k][:, None]
        lg = torch.where(lg < kth, -torch.inf, lg)
    u = torch.rand(lg.shape, generator=gen, device=lg.device)
    u = torch.clamp(u, min=torch.finfo(torch.float32).tiny)
    sampled = torch.argmax(lg - torch.log(-torch.log(u)), dim=-1).to(torch.int32)
    return torch.where(temps > 0.0, sampled, greedy)


@dataclasses.dataclass
class GenerationResult:
    request_id: int
    prompt_len: int
    tokens: List[int]  # generated tokens (prompt excluded)
    finish_reason: str  # "eos" | "length"


@dataclasses.dataclass
class _Request:
    request_id: int
    prompt: np.ndarray  # [T] int32
    max_new_tokens: int
    eos_token_id: Optional[int]
    temperature: float = 0.0  # 0 = greedy; per-request sampling


@dataclasses.dataclass
class _ChunkedPrefill:
    """An in-flight chunked prefill occupying (not yet decoding in) a slot:
    a batch-1 cache filled ``prefill_chunk`` tokens per engine step."""

    request: _Request
    caches: list  # the request's batch-1 caches, one per layer
    filled: int = 0
    last_logits: Optional[torch.Tensor] = None  # [1, C, V] of the latest chunk


@dataclasses.dataclass
class _Slot:
    request: Optional[_Request] = None
    generated: List[int] = dataclasses.field(default_factory=list)
    last_token: int = 0

    @property
    def active(self) -> bool:
        return self.request is not None


class ContinuousBatchingEngine:
    """Slot-based continuous batching over a causal LM of the port's zoo.

    The model must expose ``init_cache(..., per_row=True)`` and accept a
    per-row ``position_offset`` tensor: OPT and GPT-2 (learned positions,
    looked up per row), Llama, Qwen3 and Gemma (per-row RoPE) and Mistral
    (per-row banded masks).  Any Dmx configuration applies: the engine runs
    the live module tree.

    ``pipeline_depth=N`` reads a decode step's tokens back only after later
    steps were dispatched.  As in the JAX package, the in-flight results
    past the depth are applied at the start of :meth:`step`, before its
    admission and its own dispatch, so N + 1 dispatches are in flight when
    a step's dispatch is queued (the JAX package's docstring says N).
    """

    def __init__(
        self,
        model,
        *,
        max_slots: int = 4,
        max_len: int = 512,
        prompt_buckets: tuple = (16, 32, 64, 128),
        pad_id: int = 0,
        quantized_kv: bool = False,
        top_k: Optional[int] = None,
        seed: int = 0,
        prefill_chunk: Optional[int] = None,
        chunks_per_step: int = 1,
        pipeline_depth: int = 1,
    ):
        self.model = model
        self.device = next(model.parameters()).device
        self.max_slots = max_slots
        self.max_len = max_len
        usable = tuple(b for b in sorted(prompt_buckets) if b <= max_len)
        assert usable, f"no prompt bucket fits max_len={max_len}: {prompt_buckets}"
        self.prompt_buckets = usable
        self.pad_id = pad_id
        self.quantized_kv = quantized_kv
        self.top_k = top_k  # static truncation shared by all sampled rows
        self._gen = torch.Generator(device=self.device).manual_seed(seed)
        self.caches = model.init_cache(max_slots, max_len, per_row=True,
                                       quantized=quantized_kv, device=self.device)
        self.slots = [_Slot() for _ in range(max_slots)]
        self.queue: deque[_Request] = deque()
        self.finished: List[GenerationResult] = []
        self._ids = itertools.count()
        self.prefill_chunk = prefill_chunk
        # chunks dispatched per prefilling slot per engine step (each chunk
        # its own dispatch); ~burst / prefill_chunk keeps a prefilling
        # slot's prompt consumption in step with the decoders' tokens
        self.chunks_per_step = max(1, int(chunks_per_step))
        self._prefilling: dict = {}  # slot -> _ChunkedPrefill
        # per-step admission counters (benches classify steady steps with
        # them; callers may read, never write)
        self.last_step_admissions = 0
        self.last_step_chunks = 0
        # (burst, sampling) pairs whose decode passed _assert_serving_safe
        self._checked = set()
        # the slots' last tokens and temperatures, on the device: the decode
        # dispatch reads them and writes the next tokens there
        self._dtoks = torch.zeros((max_slots, 1), dtype=torch.int32, device=self.device)
        self._dtemps = torch.zeros((max_slots,), dtype=torch.float32, device=self.device)
        # in-flight results whose readback is deferred (see step()):
        # ("prefill", token, slot, request id) or
        # ("decode", tokens [B, burst], burst, [(slot, request id)])
        self.pipeline_depth = max(0, int(pipeline_depth))
        self._pending: deque = deque()

    # ------------------------------------------------------------- intake

    def submit(self, prompt_ids, max_new_tokens: int = 16, eos_token_id: Optional[int] = None,
               temperature: float = 0.0) -> int:
        prompt = np.asarray(prompt_ids, np.int32).reshape(-1)
        assert prompt.size > 0, "empty prompt"
        assert prompt.size <= max(self.prompt_buckets), (
            f"prompt length {prompt.size} exceeds the largest bucket {max(self.prompt_buckets)}"
        )
        assert prompt.size + max_new_tokens <= self.max_len
        rid = next(self._ids)
        self.queue.append(_Request(rid, prompt, max_new_tokens, eos_token_id, float(temperature)))
        return rid

    # ------------------------------------------------------------ warmup

    def _busy(self) -> bool:
        return bool(self.queue or self._prefilling or self._pending
                    or any(s.active for s in self.slots))

    def warmup(self, burst: int = 1) -> None:
        """Run one synthetic full-bucket request per prompt bucket end to end
        (every chunk offset and the finalize when chunked prefill is on, and
        the ``burst`` decode), then discard the results: the kernels' first
        launches (their build included) happen here and not in the serving
        loop."""
        assert not (self._busy() or self.finished), (
            "warmup() must run on an idle engine (before any submit())"
        )
        for bucket in self.prompt_buckets:
            # a full-bucket prompt may leave < 2 tokens under max_len
            headroom = self.max_len - bucket
            if headroom < 1:
                continue
            self._warmup_submit(bucket, min(2, headroom))
            guard = 0
            while self._busy():
                self.step(burst)
                guard += 1
                assert guard < 10_000, "warmup request failed to finish"
        self.finished.clear()

    def _warmup_submit(self, bucket: int, max_new_tokens: int) -> None:
        """Queue :meth:`warmup`'s synthetic full-bucket request."""
        self.submit(np.ones((bucket,), np.int32), max_new_tokens=max_new_tokens)

    # ------------------------------------------------------------ prefill

    def _bucket_for(self, n: int) -> int:
        for b in self.prompt_buckets:
            if n <= b:
                return b
        raise AssertionError("submit() bounds-checked this")

    def _ids_tensor(self, ids: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(ids).to(self.device)

    def _install(self, b: int, req: _Request, caches, boundary: torch.Tensor) -> None:
        """Pick the request's first token from its boundary logits [1, V],
        copy its batch-1 cache into slot ``b`` and refresh the slot's decode
        inputs; the token's readback rides ``_pending``."""
        temp = req.temperature
        if temp > 0.0:
            temps = torch.full((1,), temp, dtype=torch.float32, device=self.device)
            nxt = _pick(boundary, self._gen, temps, self.top_k)[0]
        else:
            nxt = _greedy(boundary)[0]
        _write_rows(self.caches, b, caches, int(req.prompt.size), self.quantized_kv)
        self._dtoks[b, 0] = nxt
        self._dtemps[b:b + 1].fill_(temp)
        slot = self.slots[b]
        slot.request = req
        slot.generated = []
        self._pending.append(("prefill", nxt, b, req.request_id))

    def _prefill(self, b: int, req: _Request) -> None:
        """One request's prefill at its bucket into a fresh batch-1 cache,
        installed into slot ``b``."""
        n = int(req.prompt.size)
        bucket = self._bucket_for(n)
        ids = np.full((1, bucket), self.pad_id, np.int32)
        ids[0, :n] = req.prompt
        caches = self.model.init_cache(1, bucket, quantized=self.quantized_kv, device=self.device)
        logits = self.model(self._ids_tensor(ids), caches=caches, position_offset=0)
        self._install(b, req, caches, logits[0, n - 1:n])

    # ----------------------------------- chunked prefill (interleaved)

    def _chunk_cap(self, n: int) -> int:
        """A chunked prefill's batch-1 cache capacity: the prompt bucket
        rounded up to whole chunks (each chunk appends exactly
        ``prefill_chunk`` tokens, padding included)."""
        c = self.prefill_chunk
        return -(-self._bucket_for(n) // c) * c

    def _start_chunked(self, b: int, req: _Request) -> None:
        caches = self.model.init_cache(1, self._chunk_cap(req.prompt.size),
                                       quantized=self.quantized_kv, device=self.device)
        self._prefilling[b] = _ChunkedPrefill(req, caches)

    def _advance_prefills(self) -> None:
        """Up to ``chunks_per_step`` chunk dispatches per prefilling slot;
        a finished prefill installs its rows into the slot, which joins this
        step's decode."""
        if not self._prefilling:
            return
        C = self.prefill_chunk
        for b in list(self._prefilling):
            st = self._prefilling[b]
            req = st.request
            for _ in range(self.chunks_per_step):
                ids = np.full((1, C), self.pad_id, np.int32)
                seg = req.prompt[st.filled:st.filled + C]
                ids[0, :seg.size] = seg
                st.last_logits = self.model(self._ids_tensor(ids), caches=st.caches,
                                            position_offset=st.filled)
                st.filled += C
                self.last_step_chunks += 1
                if st.filled < req.prompt.size:
                    continue
                pos = int(req.prompt.size) - 1 - (st.filled - C)
                self._install(b, req, st.caches, st.last_logits[0, pos:pos + 1])
                del self._prefilling[b]
                break

    def _admit(self) -> None:
        for b, slot in enumerate(self.slots):
            if not self.queue:
                return
            if slot.active or b in self._prefilling:
                continue
            req = self.queue.popleft()
            if self.prefill_chunk is not None and req.prompt.size > self.prefill_chunk:
                self._start_chunked(b, req)
            else:
                self._prefill(b, req)
            self.last_step_admissions += 1

    # ------------------------------------------------------------- decode

    def _assert_serving_safe(self) -> None:
        """A decode step keeps only the caches: fail loudly on state the
        model would mutate in its forward (an enabled observer, a
        calibrating SmoothQuant) instead of recording nothing."""
        bad = []
        for name, node in self.model.named_modules():
            if isinstance(node, CastTo) and node.observer_enabled:
                bad.append(f"{name}: observer enabled")
            sq = getattr(node, "smoothquant", None)
            if sq is not None and getattr(sq, "calibrating", False):
                bad.append(f"{name}: smoothquant calibrating")
        assert not bad, (
            "serving decode discards model-state mutations; disable these stateful "
            "subsystems before serving (freeze/calibrate offline): " + "; ".join(bad)
        )

    def _retire_if_done(self, b: int) -> None:
        slot = self.slots[b]
        req = slot.request
        done_eos = (req.eos_token_id is not None and slot.generated
                    and slot.generated[-1] == req.eos_token_id)
        done_len = len(slot.generated) >= req.max_new_tokens
        if done_eos or done_len:
            self.finished.append(GenerationResult(
                request_id=req.request_id, prompt_len=int(req.prompt.size),
                tokens=list(slot.generated), finish_reason="eos" if done_eos else "length",
            ))
            slot.request = None
            slot.generated = []

    @torch.no_grad()
    def step(self, burst: int = 1) -> List[GenerationResult]:
        """Admit queued requests into free slots, advance every active slot
        by ``burst`` tokens in one dispatch, and return the results that
        finished.  Slots that finish mid-burst decode garbage until the
        burst ends (truncated on the host).

        The readback is pipelined: a dispatch's tokens are read back only
        after later dispatches were queued (see the class docstring); the
        decode inputs live on the device, so a dispatch needs nothing from
        the readback."""
        n_done = len(self.finished)
        # apply readbacks past the pipeline depth FIRST: slots retired by an
        # earlier dispatch free up before this step's admission, and the
        # refilled slot joins this step's decode
        while len(self._pending) > self.pipeline_depth:
            self._apply_oldest()
        self.last_step_admissions = 0
        self.last_step_chunks = 0
        self._admit()
        self._advance_prefills()
        if any(s.active for s in self.slots):
            sampling = any(s.request.temperature > 0.0 for s in self.slots if s.active)
            seq = self._dispatch(burst, sampling)
            snapshot = [(b, s.request.request_id) for b, s in enumerate(self.slots) if s.active]
            self._pending.append(("decode", seq, burst, snapshot))
        if not (self.queue or self._prefilling):
            # no upstream work left: drain in-flight steps so callers see
            # every result without extra garbage dispatches
            while self._pending and not any(s.active for s in self.slots):
                self._apply_oldest()

            def in_flight(b):
                n = 0
                for e in self._pending:
                    if e[0] == "prefill" and e[2] == b:
                        n += 1
                    elif e[0] == "decode" and any(bb == b for bb, _ in e[3]):
                        n += e[2]
                return n

            if self._pending and all(
                len(s.generated) + in_flight(b) >= s.request.max_new_tokens
                for b, s in enumerate(self.slots) if s.active
            ):
                # every remaining token is already in flight
                while self._pending:
                    self._apply_oldest()
        return self.finished[n_done:]

    def _dispatch(self, burst: int, sampling: bool) -> torch.Tensor:
        """Queue ``burst`` decode steps of every slot; returns the (not yet
        read back) tokens [B, burst]."""
        if (burst, sampling) not in self._checked:
            self._assert_serving_safe()
            self._checked.add((burst, sampling))
        toks, cols = self._dtoks, []
        for _ in range(burst):
            off = self.caches[0].lengths.clone()  # [B] per-row positions
            logits = self.model(toks, caches=self.caches, position_offset=off)
            if sampling:
                nxt = _pick(logits[:, -1], self._gen, self._dtemps, self.top_k)
            else:
                nxt = _greedy(logits[:, -1])
            toks = nxt[:, None]
            cols.append(nxt)
        self._dtoks = toks
        return torch.stack(cols, dim=1)

    def _apply_oldest(self) -> None:
        """Read back the oldest in-flight result (a decode dispatch's tokens
        or an admission's first token) and apply it to the slots that were
        active at its dispatch (by request id: a slot retired and readmitted
        since then skips the stale tokens)."""
        entry = self._pending.popleft()
        if entry[0] == "prefill":
            _, nxt, b, rid = entry
            tok = nxt.tolist()
            slot = self.slots[b]
            if slot.request is not None and slot.request.request_id == rid:
                slot.generated.append(tok)
                slot.last_token = tok
                self._retire_if_done(b)
            return
        _, seq, burst, snapshot = entry
        seq = seq.tolist()  # the one host sync of the steady-state loop
        for j in range(burst):
            for b, rid in snapshot:
                slot = self.slots[b]
                if slot.request is None or slot.request.request_id != rid:
                    continue
                slot.generated.append(seq[b][j])
                slot.last_token = seq[b][j]
                self._retire_if_done(b)

    def run(self, burst: int = 1) -> List[GenerationResult]:
        """Drain the queue and all active slots to completion."""
        while self._busy():
            self.step(burst)
        return self.finished


@dataclasses.dataclass
class _Seq2SeqRequest(_Request):
    encoder_input: Optional[np.ndarray] = None


class Seq2SeqBatchingEngine(ContinuousBatchingEngine):
    """Continuous batching for the encoder-decoder families of the port's
    zoo: T5 (ragged token-id encoder inputs, padded to ``enc_capacity`` and
    masked) and Whisper (fixed-shape feature inputs).

    Each slot also owns a row of an encoder-output buffer ``[max_slots,
    S_enc, D]`` on the device: an admission encodes the request's input
    once (batch 1, with its prefill) and writes its row; a decode step
    recomputes the cross-attention K/V from each slot's row per token (the
    model's own decode semantics).  The decoder's self-attention uses the
    causal-LM engine's row caches.  A T5 decode builds the additive ``-1e4``
    mask over the encoder keys on the device from the slots' encoder lengths
    (``_enc_lens``, on the device): a steady dispatch makes no host sync.

    The model must expose ``encode(features)`` and ``decode(ids, enc,
    caches, position_offset)`` with per-row ``position_offset`` support; a
    model whose ``encode`` takes ``attn_mask`` and ``decode`` ``enc_mask``
    (T5) takes ragged token ids.  Chunked prefill is refused: a seq2seq
    decoder prompt is its start tokens, and the encoder pass is one
    fixed-shape call.
    """

    def __init__(self, model, *, enc_capacity: Optional[int] = None, **kwargs):
        if kwargs.get("prefill_chunk") is not None:
            raise ValueError(
                "chunked prefill applies to decoder-only engines (a seq2seq decoder "
                "prompt is its start tokens; the encoder pass is one fixed-shape call)")
        super().__init__(model, **kwargs)
        self._enc = None  # [max_slots, S_enc, D], allocated at the first admission
        # ragged token-id encoder inputs (T5) are right-padded to enc_capacity
        # and masked; fixed-shape feature inputs (Whisper) must share one shape
        self.enc_capacity = enc_capacity
        self._enc_lens = torch.zeros((self.max_slots,), dtype=torch.int32, device=self.device)
        self._warm_input = None
        self._masked_encoder = (
            "enc_mask" in inspect.signature(model.decode).parameters
            and "attn_mask" in inspect.signature(model.encode).parameters
        )

    # ------------------------------------------------------------- intake

    def submit(self, encoder_input, decoder_start_ids=None, max_new_tokens: int = 16,
               eos_token_id: Optional[int] = None, temperature: float = 0.0) -> int:
        feats = np.asarray(encoder_input)  # audio features or token ids
        if feats.ndim == 1:
            assert self._masked_encoder, (
                "ragged token-id encoder inputs need a model with "
                "encode(attn_mask) / decode(enc_mask) support")
            if self.enc_capacity is None:
                self.enc_capacity = int(feats.size)
            assert feats.size <= self.enc_capacity, (
                f"encoder input length {feats.size} exceeds enc_capacity={self.enc_capacity}")
        if decoder_start_ids is None:
            decoder_start_ids = np.zeros((1,), np.int32)
        prompt = np.asarray(decoder_start_ids, np.int32).reshape(-1)
        assert prompt.size > 0
        assert prompt.size <= max(self.prompt_buckets)
        assert prompt.size + max_new_tokens <= self.max_len
        if self._warm_input is None:
            self._warm_input = feats
        rid = next(self._ids)
        self.queue.append(_Seq2SeqRequest(rid, prompt, max_new_tokens, eos_token_id,
                                          float(temperature), encoder_input=feats))
        return rid

    def warmup(self, burst: int = 1, encoder_input=None) -> None:
        """:meth:`ContinuousBatchingEngine.warmup` with ``encoder_input``
        (default: ones of ``enc_capacity`` for a token-id model) as every
        synthetic request's encoder input."""
        if encoder_input is None:
            assert self._masked_encoder and self.enc_capacity, (
                "warmup() of a feature-input model needs an example encoder_input")
            encoder_input = np.ones((self.enc_capacity,), np.int32)
        self._warm_input = np.asarray(encoder_input)
        super().warmup(burst)

    def _warmup_submit(self, bucket: int, max_new_tokens: int) -> None:
        self.submit(self._warm_input, np.ones((bucket,), np.int32),
                    max_new_tokens=max_new_tokens)

    # ------------------------------------------------------------ prefill

    def _enc_mask(self, S: int, enc_lens: torch.Tensor) -> torch.Tensor:
        """The additive mask over the encoder keys, [B, 1, 1, S] f32: 0
        below each row's encoder length, -1e4 past it."""
        keep = torch.arange(S, device=enc_lens.device)[None, :] < enc_lens[:, None]
        return torch.where(keep, 0.0, -1e4).to(torch.float32)[:, None, None, :]

    def _prefill(self, b: int, req: _Request) -> None:
        """Encode the request's input (batch 1), prefill its start ids at
        their bucket into a fresh batch-1 cache, install both into slot
        ``b``: the cache rows, and the encoder row and length."""
        n = int(req.prompt.size)
        bucket = self._bucket_for(n)
        ids = np.full((1, bucket), self.pad_id, np.int32)
        ids[0, :n] = req.prompt
        feats = req.encoder_input
        enc_len = feats.shape[-1]
        if feats.ndim == 1:  # ragged token ids: pad to capacity
            enc_len = feats.size
            padded = np.full((self.enc_capacity,), self.pad_id, feats.dtype)
            padded[:feats.size] = feats
            feats = padded
        x = torch.from_numpy(np.ascontiguousarray(feats[None])).to(self.device)
        caches = self.model.init_cache(1, bucket, quantized=self.quantized_kv, device=self.device)
        if self._masked_encoder:
            lens = torch.full((1,), enc_len, dtype=torch.int32, device=self.device)
            emask = self._enc_mask(x.shape[-1], lens)
            enc = self.model.encode(x, attn_mask=emask)  # [1, S_enc, D]
            logits = self.model.decode(self._ids_tensor(ids), enc, caches=caches,
                                       position_offset=0, enc_mask=emask)
        else:
            enc = self.model.encode(x)  # [1, S_enc, D]
            logits = self.model.decode(self._ids_tensor(ids), enc, caches=caches,
                                       position_offset=0)
        self._install(b, req, caches, logits[0, n - 1:n])
        if self._enc is None:
            self._enc = torch.zeros((self.max_slots, *enc.shape[1:]), dtype=enc.dtype,
                                    device=self.device)
        self._enc[b] = enc[0]
        self._enc_lens[b:b + 1].fill_(enc_len)

    # ------------------------------------------------------------- decode

    def _dispatch(self, burst: int, sampling: bool) -> torch.Tensor:
        """The causal-LM dispatch over the slots' encoder rows: ``burst``
        decode steps of every slot, each through ``model.decode`` with the
        slots' per-row offsets (and, for a masked encoder, the mask built
        once on the device from ``_enc_lens``); returns the (not yet read
        back) tokens [B, burst]."""
        if (burst, sampling) not in self._checked:
            self._assert_serving_safe()
            self._checked.add((burst, sampling))
        kw = ({"enc_mask": self._enc_mask(self._enc.shape[1], self._enc_lens)}
              if self._masked_encoder else {})
        toks, cols = self._dtoks, []
        for _ in range(burst):
            off = self.caches[0].lengths.clone()  # [B] per-row positions
            logits = self.model.decode(toks, self._enc, caches=self.caches,
                                       position_offset=off, **kw)
            if sampling:
                nxt = _pick(logits[:, -1], self._gen, self._dtemps, self.top_k)
            else:
                nxt = _greedy(logits[:, -1])
            toks = nxt[:, None]
            cols.append(nxt)
        self._dtoks = toks
        return torch.stack(cols, dim=1)
