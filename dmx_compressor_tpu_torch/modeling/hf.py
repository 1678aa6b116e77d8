"""Perplexity evaluation over a token stream.

Port of ``do_forward_on`` of ``dmx_compressor_tpu/modeling/hf.py``; the rest
of that module (loading Hugging Face checkpoints, pipelines) is not ported.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import numpy as np
import torch


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
