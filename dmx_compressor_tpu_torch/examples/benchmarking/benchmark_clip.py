"""CLIP retrieval benchmark across evaluation modes, over the port.

Port of ``examples/benchmarking/benchmark_clip.py``: a CLIP model wrapped and
configured per ``EVALUATION_MODE``, then the runtime (each DmxModule timed),
accuracy and per-layer error tables of ``utils/benchmark.py``.  The corpus
is synthetic, as in the JAX example: ``N_PAIRS`` paired standard-normal
images and token-id captions (image i with caption i) from numpy's
``default_rng(0)``; the accuracy is text-to-image retrieval top-K and the
top-1 agreement with the Vanilla model.  From the root of a checkout:

    python -m dmx_compressor_tpu_torch.examples.benchmarking.benchmark_clip \\
        [--full] [--device cuda|cpu] [--ckpt DIR]

``--full`` runs CLIP ViT-B/32 (CLIP tiny otherwise); the weights are random
(seed 0), or those of the local HF checkpoint ``--ckpt DIR``
(``modeling.hf.read_hf_checkpoint`` and ``load_hf_state_dict``) at that
width.  The model runs on the card unless ``--device cpu``.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from ...modeling.hf import load_hf_state_dict, read_hf_checkpoint
from ...models.clip import CLIPConfig, CLIPModel
from ...utils.benchmark import (
    EVALUATION_MODE,
    measure_model_accuracy,
    measure_model_error,
    measure_model_runtime,
)

N_PAIRS = 64
BATCH = 8
TOP_K = (1, 5, 10)
MODES = [EVALUATION_MODE.VANILLA, EVALUATION_MODE.BASELINE, EVALUATION_MODE.BASIC_NOVSIMD,
         EVALUATION_MODE.BASIC]


def make_dataset(cfg: CLIPConfig, n: int):
    """The synthetic paired corpus, deterministic by index."""
    rng = np.random.default_rng(0)
    v = cfg.vision
    images = rng.standard_normal((n, 3, v.image_size, v.image_size), np.float32)
    texts = rng.integers(0, cfg.text.vocab_size,
                         (n, cfg.text.max_position_embeddings)).astype(np.int32)
    return images, texts


def make_model_maker(full: bool, device, ckpt=None):
    """The model_maker of ``utils/benchmark.py``: a fresh model a call (the
    checkpoint's weights loaded into it where ``ckpt`` names one), its
    runner (one batch through ``__call__``) and its evaluator."""
    cfg = CLIPConfig.vit_b_32() if full else CLIPConfig.tiny()
    tensors = (CLIPModel.hf_tensor_converter(read_hf_checkpoint(ckpt))
               if ckpt is not None else None)
    images, texts = make_dataset(cfg, N_PAIRS)
    images = torch.from_numpy(images).to(device)
    texts = torch.from_numpy(texts).to(device)
    vanilla = {}

    @torch.no_grad()
    def model_runner(m):
        return m(texts[:BATCH], images[:BATCH])

    @torch.no_grad()
    def model_evaluator(m, desc: str):
        """Text-to-image retrieval top-K over the corpus, and the top-1
        agreement with the Vanilla model's (informative with random
        weights)."""
        print(f"evaluating clip model {desc}")
        img_e, txt_e = [], []
        for i in range(0, N_PAIRS, BATCH):
            img = m.get_image_features(images[i:i + BATCH])
            txt = m.get_text_features(texts[i:i + BATCH])
            img_e.append(img / torch.linalg.norm(img, dim=-1, keepdim=True))
            txt_e.append(txt / torch.linalg.norm(txt, dim=-1, keepdim=True))
        sim = torch.cat(txt_e) @ torch.cat(img_e).T  # [n_text, n_image]
        order = torch.argsort(-sim, dim=-1, stable=True)
        correct = order == torch.arange(sim.shape[0], device=sim.device)[:, None]
        retrieved = order[:, 0].cpu().numpy()
        if desc == EVALUATION_MODE.VANILLA.value:
            vanilla["top1"] = retrieved
        ref = vanilla.get("top1", retrieved)
        metrics = {f"top{k}_acc": float(correct[:, :k].any(-1).float().mean()) for k in TOP_K}
        metrics["retrieval_agreement_vs_vanilla"] = float(np.mean(retrieved == ref))
        return metrics

    def model_maker():
        model = CLIPModel(cfg, device=device, seed=0)
        if tensors is not None:
            load_hf_state_dict(model, tensors)
        return model, model_runner, model_evaluator

    return model_maker


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--full", action="store_true", help="CLIP ViT-B/32 (CLIP tiny otherwise)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--ckpt", default=None, help="a local HF checkpoint directory")
    args = ap.parse_args(argv)
    maker = make_model_maker(args.full, torch.device(args.device), args.ckpt)
    runtime = measure_model_runtime(maker, MODES)
    print()
    accuracy = measure_model_accuracy(maker, MODES)
    print()
    error = measure_model_error(maker, [EVALUATION_MODE.BASIC],
                                reference_mode=EVALUATION_MODE.BASELINE)
    return dict(runtime=runtime, accuracy=accuracy, error=error)


if __name__ == "__main__":
    main()
