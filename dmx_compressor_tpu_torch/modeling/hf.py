"""Hugging Face integration: local checkpoints in, the pipeline, evaluation.

Port of ``dmx_compressor_tpu/modeling/hf.py``.  A local HF checkpoint
directory (``config.json`` and ``*.safetensors`` or ``*.bin`` files) is read
into numpy (:func:`read_hf_checkpoint`, with the port's own reader of the
safetensors format: no ``safetensors`` package), its tensors copied into the
port's model of the family that ``config.json`` names
(:func:`model_from_checkpoint`), which :class:`Pipeline` then wraps as a
``DmxModel`` and configures by name.  Generation is a prefill, then single
token steps over the port's caches in an eager loop; evaluation is the
strided sliding-window perplexity (:func:`do_forward_on`), SQuAD EM/F1 over
generated answers, and registries of local metrics and tasks.

``transformers``, ``datasets``, ``evaluate`` and ``huggingface_hub`` are
optional, imported where the JAX package imports them: without them the
tokenizer is None and a dataset, metric or hub name raises as it does there.
Entry points build on the card unless the caller names the CPU.
"""

from __future__ import annotations

import json
import math
import os
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..kernels import resolve_device
from .model import DmxConfig, DmxModel

# dataset column names for common LM eval sets
column_mapping = {
    "wikitext": "text",
    "ptb_text_only": "sentence",
    "lambada": "text",
    "EleutherAI/lambada_openai": "text",
}


# ---------------------------------------------------------------------------
# checkpoint import
# ---------------------------------------------------------------------------

# safetensors dtype codes -> numpy; BF16 has no numpy type and is read
# through torch.bfloat16 into float32
_ST_DTYPES = {
    "F64": np.float64, "F32": np.float32, "F16": np.float16,
    "I64": np.int64, "I32": np.int32, "I16": np.int16, "I8": np.int8,
    "U64": np.uint64, "U32": np.uint32, "U16": np.uint16, "U8": np.uint8, "BOOL": np.bool_,
}


def read_safetensors(fname: str) -> Dict[str, np.ndarray]:
    """The tensors of one ``.safetensors`` file: an 8-byte little-endian
    header length, a JSON header (per tensor ``dtype``, ``shape`` and
    ``data_offsets`` into the buffer; an optional ``__metadata__``), then
    the raw little-endian buffer.  F16 stays float16 (as
    ``safetensors.numpy.load_file`` gives it); BF16 becomes float32."""
    with open(fname, "rb") as f:
        data = f.read()
    n = int.from_bytes(data[:8], "little")
    header = json.loads(data[8:8 + n])
    base = 8 + n
    out = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        b0, b1 = info["data_offsets"]
        buf = data[base + b0: base + b1]
        shape = tuple(info["shape"])
        if info["dtype"] == "BF16":
            raw = torch.frombuffer(bytearray(buf), dtype=torch.bfloat16) if buf else \
                torch.empty(0, dtype=torch.bfloat16)
            out[name] = raw.float().numpy().reshape(shape)
        elif info["dtype"] in _ST_DTYPES:
            dt = np.dtype(_ST_DTYPES[info["dtype"]]).newbyteorder("<")
            out[name] = np.frombuffer(buf, dtype=dt).astype(dt.newbyteorder("=")).reshape(shape)
        else:
            raise ValueError(f"{fname}: tensor {name} has dtype {info['dtype']}, which this "
                             f"reader does not take")
    return out


def read_hf_checkpoint(path: str) -> Dict[str, np.ndarray]:
    """Load all tensors of a local HF checkpoint directory to numpy: every
    ``*.safetensors`` file (in name order), else every ``*.bin`` file
    (``torch.load(weights_only=True)``, as float32)."""
    tensors: Dict[str, np.ndarray] = {}
    st_files = [f for f in os.listdir(path) if f.endswith(".safetensors")]
    if st_files:
        for f in sorted(st_files):
            tensors.update(read_safetensors(os.path.join(path, f)))
        return tensors
    bin_files = [f for f in os.listdir(path) if f.endswith(".bin")]
    if bin_files:
        for f in sorted(bin_files):
            sd = torch.load(os.path.join(path, f), map_location="cpu", weights_only=True)
            tensors.update({k: v.float().numpy() for k, v in sd.items()})
        return tensors
    raise FileNotFoundError(f"no safetensors/bin checkpoint under {path}")


def _resolve(obj, path: str):
    if path == "":  # a top-level parameter (e.g. CLIP's logit_scale)
        return obj
    for part in path.split("."):
        if part.isdigit():
            obj = obj[int(part)]
        else:
            obj = getattr(obj, part)
    return obj


def load_hf_state_dict(model: torch.nn.Module, tensors: Dict[str, np.ndarray]) -> List[str]:
    """Copy HF-named tensors into the model's parameters and buffers, in
    place and on their device.  The port's modules keep HF's [out, in]
    layout, so each tensor goes as it is (reshaped to its target) into the
    parameter or buffer that its owner registers under the last name; a
    name that resolves to none (a head tied to the embedding, whose owner
    holds no weight of its own; a fixed table whose owner sets
    ``from_checkpoints = False``, as Whisper's encoder positions) is
    returned among the unmatched keys, as the JAX package returns it."""
    missed = []
    with torch.no_grad():
        for name, arr in tensors.items():
            parts = name.split(".")
            leaf = parts[-1]  # weight | bias | ...
            try:
                owner = _resolve(model, ".".join(parts[:-1]))
            except (AttributeError, IndexError, KeyError, TypeError):
                missed.append(name)
                continue
            target = None
            if isinstance(owner, torch.nn.Module) and getattr(owner, "from_checkpoints", True):
                target = owner._parameters.get(leaf)
                if target is None:
                    target = owner._buffers.get(leaf)
            if target is None:
                missed.append(name)
                continue
            value = torch.as_tensor(np.asarray(arr, np.float32))
            target.copy_(value.reshape(target.shape).to(target.dtype))
    return missed


def _clip_config(cfg_json, dtype):
    from ..models.clip import CLIPConfig, CLIPTextConfig, CLIPVisionConfig

    v, t = cfg_json["vision_config"], cfg_json["text_config"]
    return CLIPConfig(
        vision=CLIPVisionConfig(
            hidden_size=v.get("hidden_size", 768),
            intermediate_size=v.get("intermediate_size", 3072),
            num_hidden_layers=v.get("num_hidden_layers", 12),
            num_attention_heads=v.get("num_attention_heads", 12),
            image_size=v.get("image_size", 224),
            patch_size=v.get("patch_size", 32),
        ),
        text=CLIPTextConfig(
            vocab_size=t.get("vocab_size", 49408),
            hidden_size=t.get("hidden_size", 512),
            intermediate_size=t.get("intermediate_size", 2048),
            num_hidden_layers=t.get("num_hidden_layers", 12),
            num_attention_heads=t.get("num_attention_heads", 8),
            max_position_embeddings=t.get("max_position_embeddings", 77),
        ),
        projection_dim=cfg_json.get("projection_dim", 512),
        dtype=dtype,
    )


def model_from_checkpoint(path: str, *, dtype=torch.float32, device="cuda"):
    """Build the port's model of the family that the directory's
    ``config.json`` names (``model_type`` opt, gpt2, llama, mistral, gemma,
    qwen3, t5, whisper or clip) on ``device``, and load the checkpoint's
    tensors into it (through the family's ``hf_tensor_converter`` where it
    has one).  Returns (model, the unmatched keys)."""
    device = resolve_device(device)
    with open(os.path.join(path, "config.json")) as f:
        cfg_json = json.load(f)
    model_type = cfg_json.get("model_type")
    if model_type == "opt":
        from ..models.opt import OPTConfig, OPTForCausalLM

        cfg = OPTConfig(
            vocab_size=cfg_json["vocab_size"],
            hidden_size=cfg_json["hidden_size"],
            ffn_dim=cfg_json["ffn_dim"],
            num_hidden_layers=cfg_json["num_hidden_layers"],
            num_attention_heads=cfg_json["num_attention_heads"],
            max_position_embeddings=cfg_json["max_position_embeddings"],
            do_layer_norm_before=cfg_json.get("do_layer_norm_before", True),
            dtype=dtype,
        )
        cls = OPTForCausalLM
    elif model_type == "clip":
        from ..models.clip import CLIPModel

        cfg, cls = _clip_config(cfg_json, dtype), CLIPModel
    else:
        families = {
            "gpt2": ("gpt2", "GPT2Config", "GPT2LMHeadModel"),
            "llama": ("llama", "LlamaConfig", "LlamaForCausalLM"),
            "mistral": ("mistral", "MistralConfig", "MistralForCausalLM"),
            "gemma": ("gemma", "GemmaConfig", "GemmaForCausalLM"),
            "qwen3": ("qwen3", "Qwen3Config", "Qwen3ForCausalLM"),
            "t5": ("t5", "T5Config", "T5ForConditionalGeneration"),
            "whisper": ("whisper", "WhisperConfig", "WhisperForConditionalGeneration"),
        }
        if model_type not in families:
            raise NotImplementedError(f"model_type {model_type}")
        import importlib

        mod_name, cfg_name, cls_name = families[model_type]
        mod = importlib.import_module(f"..models.{mod_name}", __package__)
        cfg, cls = getattr(mod, cfg_name).from_hf(cfg_json), getattr(mod, cls_name)
        if hasattr(cfg, "dtype"):
            cfg.dtype = dtype
    model = cls(cfg, device=device)
    tensors = read_hf_checkpoint(path)
    converter = getattr(cls, "hf_tensor_converter", None)
    if converter is not None:
        tensors = converter(tensors)
    missed = load_hf_state_dict(model, tensors)
    return model, missed


# ---------------------------------------------------------------------------
# perplexity evaluation
# ---------------------------------------------------------------------------


def do_forward_on(model, input_ids: np.ndarray, max_length: Optional[int] = None,
                  stride: Optional[int] = None, batch: int = 1,
                  forward_fn=None) -> Dict[str, float]:
    """Strided sliding-window NLL over a token stream; ppl = exp(sum nll / N).
    Each window is padded to ``max_length`` (with 0) and run on the model's
    device; only the tokens past the previous window's end are scored."""
    ids = np.asarray(input_ids).reshape(-1)
    max_length = max_length or 1024
    stride = stride or max_length
    if forward_fn is None:
        device = next(model.parameters()).device

        def forward_fn(window):
            with torch.no_grad():
                return model(torch.as_tensor(window, dtype=torch.long, device=device))

    seq_len = len(ids)
    nll_sum = 0.0
    n_tokens = 0
    prev_end = 0
    for begin in range(0, seq_len, stride):
        end = min(begin + max_length, seq_len)
        trg_len = end - prev_end
        window = ids[begin:end]
        if len(window) < 2:
            break
        pad = max_length - len(window)
        w = np.pad(window, (0, pad)) if pad else window
        logits = forward_fn(w[None].astype(np.int64))[0][: len(window)]
        logp = torch.log_softmax(logits.to(torch.float32), dim=-1)
        tgt = torch.as_tensor(window[1:], dtype=torch.long, device=logp.device)
        token_nll = -torch.gather(logp[:-1], -1, tgt[:, None])[:, 0]
        token_nll = token_nll[-(trg_len if prev_end else len(window) - 1):]
        nll_sum += float(torch.sum(token_nll))
        n_tokens += int(token_nll.shape[0])
        prev_end = end
        if end == seq_len:
            break
    nll = nll_sum / max(n_tokens, 1)
    return {"loss": nll, "perplexity": math.exp(nll)}


# ---------------------------------------------------------------------------
# task evaluation beyond perplexity
# ---------------------------------------------------------------------------


def _normalize_answer(s: str) -> str:
    """SQuAD answer normalization: lowercase, strip punctuation, articles
    and extra whitespace."""
    import re
    import string

    s = s.lower()
    s = "".join(ch for ch in s if ch not in set(string.punctuation))
    s = re.sub(r"\b(a|an|the)\b", " ", s)
    return " ".join(s.split())


def squad_em_f1(prediction: str, references: List[str]) -> Dict[str, float]:
    """Exact-match and token-F1 of one prediction against reference answers."""
    pred = _normalize_answer(prediction)
    em, f1 = 0.0, 0.0
    for ref in references:
        gold = _normalize_answer(ref)
        em = max(em, float(pred == gold))
        p_toks, g_toks = pred.split(), gold.split()
        if not p_toks or not g_toks:
            f1 = max(f1, float(p_toks == g_toks))
            continue
        common: Dict[str, int] = {}
        for t in p_toks:
            common[t] = common.get(t, 0) + 1
        overlap = sum(min(common.get(t, 0), g_toks.count(t)) for t in set(g_toks))
        if overlap == 0:
            continue
        prec = overlap / len(p_toks)
        rec = overlap / len(g_toks)
        f1 = max(f1, 2 * prec * rec / (prec + rec))
    return {"exact_match": em, "f1": f1}


def eval_question_answering(
    pipe: "Pipeline",
    examples: List[Dict[str, Any]],
    max_new_tokens: int = 24,
    prompt_template: str = "Context: {context}\nQuestion: {question}\nAnswer:",
) -> Dict[str, float]:
    """Generative QA: the answer generated from the prompt, up to its first
    newline, scored by SQuAD exact-match / F1 and averaged.

    ``examples``: dicts with "context", "question", "answers" (list[str])."""
    assert pipe.tokenizer is not None, "QA evaluation needs a tokenizer"
    em_sum = f1_sum = 0.0
    for ex in examples:
        prompt = prompt_template.format(**ex)
        ids = pipe.tokenizer(prompt, return_tensors="np").input_ids
        out = np.asarray(pipe.generate(ids, max_new_tokens=max_new_tokens).cpu())
        answer = pipe.tokenizer.decode(out[0, ids.shape[1]:])
        answer = answer.split("\n")[0]
        scores = squad_em_f1(answer, ex["answers"])
        em_sum += scores["exact_match"]
        f1_sum += scores["f1"]
    n = max(len(examples), 1)
    return {"exact_match": em_sum / n, "f1": f1_sum / n, "n": float(n)}


def eval_text_generation(
    pipe: "Pipeline",
    metric: str,
    references: Optional[List[str]] = None,
    dataset_ids: Optional[np.ndarray] = None,
    **kwargs,
) -> Dict[str, float]:
    """Metric-driven text-generation evaluation: "perplexity" /
    "dmx_perplexity" / "d-matrix/dmx_perplexity" compute locally, a
    registered metric runs its function, any other name goes through
    ``evaluate.load`` where the optional ``evaluate`` package imports."""
    if metric in ("perplexity", "dmx_perplexity", "d-matrix/dmx_perplexity"):
        if dataset_ids is None:
            assert references is not None and pipe.tokenizer is not None
            text = "\n\n".join(references)
            dataset_ids = pipe.tokenizer(text, return_tensors="np").input_ids
        return pipe.do_forward_on(dataset_ids, **kwargs)
    if metric in METRIC_REGISTRY:
        return METRIC_REGISTRY[metric](
            pipe, references=references, dataset_ids=dataset_ids, **kwargs
        )
    try:
        import evaluate  # optional
    except ImportError as e:
        raise NotImplementedError(
            f"metric {metric!r} needs the optional `evaluate` package "
            f"(or register_metric({metric!r}, fn))"
        ) from e
    m = evaluate.load(metric, module_type="metric")
    return m.compute(model=pipe.raw_model, references=references, **kwargs)


# ---------------------------------------------------------------------------
# pluggable metric / task registries
# ---------------------------------------------------------------------------

METRIC_REGISTRY: Dict[str, Any] = {}
TASK_REGISTRY: Dict[str, Any] = {}


def register_metric(name: str, fn=None):
    """Register ``fn(pipe, references=..., dataset_ids=..., **kw) -> dict``
    under a metric name for ``eval_text_generation`` /
    ``Pipeline.evaluate_task("text-generation", metric=name)``.  Usable as
    a decorator (``@register_metric("my-metric")``) or directly."""
    if fn is None:
        return lambda f: register_metric(name, f)
    METRIC_REGISTRY[name] = fn
    return fn


def register_task(name: str, fn=None):
    """Register ``fn(pipe, **kw) -> dict`` as an evaluation task for
    ``Pipeline.evaluate_task(name, ...)``."""
    if fn is None:
        return lambda f: register_task(name, f)
    TASK_REGISTRY[name] = fn
    return fn


def pipe_eval(pipe: "Pipeline", task: str, **kwargs) -> Dict[str, float]:
    """Task-dispatching evaluation: the built-in tasks and TASK_REGISTRY's."""
    mapping = {
        "text-generation": eval_text_generation,
        "question-answering": eval_question_answering,
        **TASK_REGISTRY,
    }
    if task not in mapping:
        raise ValueError(f"Unsupported task type '{task}'.")
    return mapping[task](pipe, **kwargs)


# ---------------------------------------------------------------------------
# pipeline
# ---------------------------------------------------------------------------


def _pick(logits: torch.Tensor, temperature: float, top_k: Optional[int],
          gen: torch.Generator) -> torch.Tensor:
    """The next token of each row, int32 [B]: a draw from softmax(logits /
    temperature) over the logits at or above the k-th largest (every tie at
    the k-th value kept), from ``gen``."""
    lg = logits.to(torch.float32) / temperature
    if top_k is not None:
        kth = torch.sort(lg, dim=-1).values[:, -top_k][:, None]
        lg = lg.masked_fill(lg < kth, -math.inf)
    p = torch.softmax(lg, dim=-1)
    return torch.multinomial(p, 1, generator=gen)[:, 0].to(torch.int32)


# the files a local checkpoint's tokenizer loads from (transformers' names);
# without one, AutoTokenizer.from_pretrained fails as surely as its import
# costs seconds
_TOKENIZER_FILES = ("tokenizer.json", "tokenizer_config.json", "vocab.json", "vocab.txt",
                    "merges.txt", "spiece.model", "tokenizer.model")


def _has_tokenizer_files(model_path) -> bool:
    return any(os.path.exists(os.path.join(str(model_path), f)) for f in _TOKENIZER_FILES)


class Pipeline:
    """Task pipeline over a Dmx-transformed model of the port's zoo, loaded
    from a local HF checkpoint.

    ``dmx_config`` in {"BASELINE", "BASIC", "FP8"} or a yaml name applies
    the named rule set at construction (:meth:`configure_by_name`).  The
    model is built on the card unless ``device='cpu'``."""

    def __init__(self, task: str, model_path: str, dmx_config: Optional[str] = None,
                 tokenizer=None, dtype=torch.float32, device="cuda"):
        self.task = task
        self.model_path = model_path
        raw, self.missed_keys = model_from_checkpoint(model_path, dtype=dtype, device=device)
        self.raw_model = raw
        self.model = DmxModel.from_raw(raw)
        self.tokenizer = tokenizer
        if tokenizer is None and _has_tokenizer_files(model_path):
            try:
                from transformers import AutoTokenizer

                self.tokenizer = AutoTokenizer.from_pretrained(model_path)
            except Exception:
                self.tokenizer = None
        if dmx_config is not None:
            self.configure_by_name(dmx_config)

    def configure_by_name(self, name: str) -> None:
        """Resolve ``dmx_config``: a built-in rule-set name, then an explicit
        path, then ``configs/<name>.yaml`` beside a local checkpoint, then
        ``DMX_CONFIG_PATH`` (colon-separated directories), then the HF hub
        (where ``huggingface_hub`` imports and a network answers)."""
        from .. import config_rules

        if name.upper() in ("BASELINE", "BASIC", "FP8"):
            self.model.configure(None, *getattr(config_rules, name.upper()))
            return
        candidates = [name]
        base = name if name.endswith((".yaml", ".yml")) else f"{name}.yaml"
        if os.path.isdir(self.model_path):
            candidates.append(os.path.join(self.model_path, "configs", base))
        for d in os.environ.get("DMX_CONFIG_PATH", "").split(":"):
            if d:
                candidates.append(os.path.join(d, base))
        for c in candidates:
            if os.path.exists(c):
                self.model.configure(DmxConfig.from_yaml(c))
                return
        try:
            from huggingface_hub import hf_hub_download

            p = hf_hub_download(repo_id=self.model_path, filename=f"configs/{base}")
            self.model.configure(DmxConfig.from_yaml(p))
            return
        except Exception:
            pass
        raise ValueError(f"unknown dmx_config {name} (searched: {candidates}, hub)")

    def evaluate(self, metric: str = "perplexity", dataset_ids: Optional[np.ndarray] = None,
                 dataset: Optional[str] = None, column: Optional[str] = None,
                 max_length: Optional[int] = None) -> Dict[str, float]:
        """Perplexity over pre-tokenized ids, or over a ``datasets`` split
        where the tokenizer and ``datasets`` are there."""
        if dataset_ids is None:
            assert self.tokenizer is not None, "need tokenizer or dataset_ids"
            import datasets as hfds

            col = column or column_mapping.get(dataset, "text")
            ds = hfds.load_dataset(dataset, split="test")
            text = "\n\n".join(ds[col])
            dataset_ids = self.tokenizer(text, return_tensors="np").input_ids
        max_length = max_length or getattr(self.raw_model.config, "max_position_embeddings",
                                           1024)
        return self.do_forward_on(dataset_ids, max_length=max_length)

    def do_forward_on(self, input_ids, **kwargs):
        return do_forward_on(self.raw_model, input_ids, **kwargs)

    def evaluate_task(self, task: str, **kwargs) -> Dict[str, float]:
        """"question-answering" scores generated answers with SQuAD EM/F1;
        "text-generation" dispatches on the metric name; any registered
        task runs its function."""
        return pipe_eval(self, task, **kwargs)

    @torch.no_grad()
    def generate(self, input_ids, max_new_tokens: int = 16, quantized_cache: bool = False,
                 temperature: float = 0.0, top_k: Optional[int] = None, seed: int = 0):
        """A prefill into fresh caches of T + ``max_new_tokens`` slots (int8
        with ``quantized_cache``), then ``max_new_tokens - 1`` single-token
        steps, in an eager loop on the model's device.  ``temperature == 0``
        is greedy (``models.shared.greedy_prefill`` / ``greedy_decode``: a
        tie goes to the largest index); otherwise each token is drawn from
        softmax(logits / temperature), truncated to the ``top_k`` largest
        logits, from a ``torch.Generator`` on the model's device seeded by
        ``seed`` (not the JAX package's stream).  Returns int32 [B, T +
        max_new_tokens] on the model's device."""
        from ..models.shared import greedy_decode, greedy_prefill

        dev = next(self.raw_model.parameters()).device
        ids = torch.as_tensor(np.asarray(input_ids) if not torch.is_tensor(input_ids)
                              else input_ids).to(device=dev, dtype=torch.int32)
        B, T = ids.shape
        model = self.raw_model
        caches = model.init_cache(B, T + max_new_tokens, quantized=quantized_cache, device=dev)
        if temperature <= 0.0:
            _, tok = greedy_prefill(model, caches, ids)
            toks, _ = greedy_decode(model, caches, tok, T, max_new_tokens - 1)
            return torch.cat([ids, tok[:, None], toks], dim=1)
        gen = torch.Generator(device=dev).manual_seed(seed)
        tok = _pick(model(ids, caches=caches, position_offset=0)[:, -1], temperature, top_k, gen)
        out = [tok]
        for i in range(max_new_tokens - 1):
            logits = model(tok[:, None], caches=caches, position_offset=T + i)
            tok = _pick(logits[:, -1], temperature, top_k, gen)
            out.append(tok)
        return torch.cat([ids, torch.stack(out, dim=1)], dim=1)

    def generate_seq2seq(self, encoder_input, decoder_start_ids=None, max_new_tokens: int = 16,
                         eos_token_id: Optional[int] = None):
        """Seq2seq generation for the encoder-decoder models (T5, Whisper):
        encode once, then the model's own greedy ``generate``."""
        gen = getattr(self.raw_model, "generate", None)
        assert gen is not None and hasattr(self.raw_model, "encode"), (
            "generate_seq2seq requires an encoder-decoder zoo model"
        )
        if decoder_start_ids is None:
            B = np.asarray(encoder_input).shape[0]
            decoder_start_ids = np.zeros((B, 1), np.int32)
        return gen(encoder_input, decoder_start_ids, max_new_tokens=max_new_tokens,
                   eos_token_id=eos_token_id)

    def generate_batch(self, prompts: List[np.ndarray], pad_id: int = 0, **kwargs):
        """Ragged prompts left-padded with ``pad_id`` to a common length (the
        pads are not masked) and generated together; returns the [B, T_max +
        max_new_tokens] ids and the prompts' lengths."""
        lens = [int(np.asarray(p).reshape(-1).shape[0]) for p in prompts]
        T = max(lens)
        batch = np.full((len(prompts), T), pad_id, np.int32)
        for i, p in enumerate(prompts):
            arr = np.asarray(p, np.int32).reshape(-1)
            batch[i, T - arr.shape[0]:] = arr
        return self.generate(batch, **kwargs), lens

    def __call__(self, text_or_ids, **kwargs):
        if isinstance(text_or_ids, str):
            assert self.tokenizer is not None
            ids = self.tokenizer(text_or_ids, return_tensors="np").input_ids
            out = self.generate(ids, **kwargs)
            return self.tokenizer.batch_decode(np.asarray(out.cpu()))
        return self.generate(text_or_ids, **kwargs)


def pipeline(task: str, model: str, dmx_config: Optional[str] = None, **kwargs) -> Pipeline:
    """A :class:`Pipeline` over the local checkpoint directory ``model``."""
    return Pipeline(task, model, dmx_config=dmx_config, **kwargs)
