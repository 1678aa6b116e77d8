"""CLIP dual encoder (ViT-B/32 shapes): a vision and a text transformer.

Port of ``dmx_compressor_tpu/models/clip.py``.  The vision patch embedding
is ``nn.experimental.Conv2dUnfold`` (the im2col lowering of the reference's
CLIP recipe: a GEMM on the 3 x 32 x 32 patches, its weight
``[768, 3072]``); module paths follow HF's ``CLIPModel`` without its
``embeddings.`` / ``encoder.`` levels (:meth:`CLIPModel.hf_tensor_converter`
maps HF's checkpoint).

Every attention is the modular ``rawnn.ScaledDotProductAttention`` with no
cache, as in the JAX package: CLIP reaches no flash kernel.  The text
tower's causal mask is additive (-1e4 above the diagonal) and it pools at
``argmax(input_ids)`` (the end-of-text token has the largest id, HF's
convention); the vision tower pools at its CLS token.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch
from torch import nn

from .. import rawnn
from ..kernels import resolve_device
from ..nn.experimental import Conv2dUnfold
from .shared import load_jax_seq2seq_params

__all__ = ["CLIPVisionConfig", "CLIPTextConfig", "CLIPConfig", "CLIPAttention", "CLIPMLP",
           "CLIPEncoderLayer", "CLIPVisionTransformer", "CLIPTextTransformer", "CLIPModel",
           "load_jax_params"]


@dataclasses.dataclass
class CLIPVisionConfig:
    hidden_size: int = 768
    intermediate_size: int = 3072
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    image_size: int = 224
    patch_size: int = 32
    num_channels: int = 3


@dataclasses.dataclass
class CLIPTextConfig:
    vocab_size: int = 49408
    hidden_size: int = 512
    intermediate_size: int = 2048
    num_hidden_layers: int = 12
    num_attention_heads: int = 8
    max_position_embeddings: int = 77


@dataclasses.dataclass
class CLIPConfig:
    vision: CLIPVisionConfig = dataclasses.field(default_factory=CLIPVisionConfig)
    text: CLIPTextConfig = dataclasses.field(default_factory=CLIPTextConfig)
    projection_dim: int = 512
    logit_scale_init: float = 2.6592
    dtype: torch.dtype = torch.float32

    @classmethod
    def vit_b_32(cls):
        """CLIP ViT-B/32: vision 12 layers of 768 (12 heads of 64, MLP 3072)
        over 224 x 224 images in 32 x 32 patches (49 + CLS); text 12 layers
        of 512 (8 heads of 64, MLP 2048), vocab 49408, 77 positions;
        projections to 512."""
        return cls()

    @classmethod
    def tiny(cls):  # test-sized
        return cls(
            vision=CLIPVisionConfig(hidden_size=64, intermediate_size=128, num_hidden_layers=2,
                                    num_attention_heads=4, image_size=32, patch_size=8),
            text=CLIPTextConfig(vocab_size=256, hidden_size=64, intermediate_size=128,
                                num_hidden_layers=2, num_attention_heads=4,
                                max_position_embeddings=16),
            projection_dim=32,
        )


class CLIPAttention(nn.Module):
    def __init__(self, d: int, heads: int, device=None):
        super().__init__()
        self.num_heads = heads
        self.head_dim = d // heads
        self.q_proj = nn.Linear(d, d, device=device)
        self.k_proj = nn.Linear(d, d, device=device)
        self.v_proj = nn.Linear(d, d, device=device)
        self.out_proj = nn.Linear(d, d, device=device)
        self.sdpa = rawnn.ScaledDotProductAttention()

    def forward(self, x, attn_mask=None):
        B, T, _ = x.shape
        D = self.num_heads * self.head_dim  # the local heads' on a tensor-parallel rank

        def split(t):
            return t.reshape(B, T, self.num_heads, self.head_dim).transpose(1, 2)

        out = self.sdpa(split(self.q_proj(x)), split(self.k_proj(x)), split(self.v_proj(x)),
                        attn_mask=attn_mask)
        return self.out_proj(out.transpose(1, 2).reshape(B, T, D))


class CLIPMLP(nn.Module):
    def __init__(self, d: int, m: int, device=None):
        super().__init__()
        self.fc1 = nn.Linear(d, m, device=device)
        self.activation_fn = rawnn.QuickGELU()
        self.fc2 = nn.Linear(m, d, device=device)

    def forward(self, x):
        return self.fc2(self.activation_fn(self.fc1(x)))


class CLIPEncoderLayer(nn.Module):
    def __init__(self, d: int, m: int, heads: int, device=None):
        super().__init__()
        self.self_attn = CLIPAttention(d, heads, device)
        self.layer_norm1 = nn.LayerNorm(d, eps=1e-5, device=device)
        self.mlp = CLIPMLP(d, m, device)
        self.layer_norm2 = nn.LayerNorm(d, eps=1e-5, device=device)
        self.resadd1 = rawnn.ResAdd()
        self.resadd2 = rawnn.ResAdd()

    def forward(self, x, attn_mask=None):
        x = self.resadd1(self.self_attn(self.layer_norm1(x), attn_mask), x)
        return self.resadd2(self.mlp(self.layer_norm2(x)), x)


class CLIPVisionTransformer(nn.Module):
    def __init__(self, cfg: CLIPVisionConfig, device=None, generator=None):
        super().__init__()
        self.cfg = cfg
        d = cfg.hidden_size
        # the im2col-lowered patch embedding (stride = kernel = patch size)
        self.patch_embedding = Conv2dUnfold(cfg.num_channels, d, cfg.patch_size,
                                            stride=cfg.patch_size, bias=False, device=device,
                                            generator=generator)
        n_patches = (cfg.image_size // cfg.patch_size) ** 2
        self.class_embedding = nn.Parameter(torch.empty(d, device=device))
        self.position_embedding = nn.Embedding(n_patches + 1, d, device=device)
        self.pre_layrnorm = nn.LayerNorm(d, eps=1e-5, device=device)
        self.layers = nn.ModuleList(
            CLIPEncoderLayer(d, cfg.intermediate_size, cfg.num_attention_heads, device)
            for _ in range(cfg.num_hidden_layers))
        self.post_layernorm = nn.LayerNorm(d, eps=1e-5, device=device)

    def forward(self, pixel_values):
        """``pixel_values`` [B, C, H, W] -> the pooled CLS state [B, d]."""
        B = pixel_values.shape[0]
        patches = self.patch_embedding(pixel_values)  # [B, d, h, w]
        x = patches.reshape(B, patches.shape[1], -1).transpose(1, 2)
        x = torch.cat([self.class_embedding.expand(B, 1, -1), x], dim=1)
        x = x + self.position_embedding(torch.arange(x.shape[1], device=x.device))[None]
        x = self.pre_layrnorm(x)
        for layer in self.layers:
            x = layer(x)
        return self.post_layernorm(x[:, 0])


class CLIPTextTransformer(nn.Module):
    def __init__(self, cfg: CLIPTextConfig, device=None):
        super().__init__()
        self.cfg = cfg
        d = cfg.hidden_size
        self.token_embedding = nn.Embedding(cfg.vocab_size, d, device=device)
        self.position_embedding = nn.Embedding(cfg.max_position_embeddings, d, device=device)
        self.layers = nn.ModuleList(
            CLIPEncoderLayer(d, cfg.intermediate_size, cfg.num_attention_heads, device)
            for _ in range(cfg.num_hidden_layers))
        self.final_layer_norm = nn.LayerNorm(d, eps=1e-5, device=device)

    def forward(self, input_ids):
        """``input_ids`` [B, T] -> the state at each row's end-of-text token
        (its largest id) [B, d]."""
        B, T = input_ids.shape
        pos = torch.arange(T, device=input_ids.device)
        x = self.token_embedding(input_ids) + self.position_embedding(pos)[None]
        mask = torch.where(pos[None, :] <= pos[:, None], 0.0, -1e4).to(x.dtype)
        for layer in self.layers:
            x = layer(x, attn_mask=mask)
        x = self.final_layer_norm(x)
        eot = torch.argmax(input_ids, dim=-1)
        return x[torch.arange(B, device=x.device), eot]


def _unit_rows(x):
    return x / torch.linalg.vector_norm(x, dim=-1, keepdim=True)


class CLIPModel(nn.Module):
    """CLIP: ``get_image_features`` / ``get_text_features`` (the towers'
    pooled states through their projections), ``forward`` (the scaled
    cosine logits per image and per text) and ``zero_shot_classify``.

    Built on the card unless ``device='cpu'``.  Weights are random, drawn
    from ``seed``: normal(0, 0.02) for the linears, the embeddings, the
    patch embedding and the CLS token, zero biases, unit LayerNorm scales,
    ``logit_scale`` its init (log 14.28); :func:`load_jax_params` replaces
    them."""

    def __init__(self, cfg: CLIPConfig, device=None, seed: int = 0):
        super().__init__()
        device = resolve_device(device)
        self.cfg = cfg
        gen = torch.Generator(device=device).manual_seed(seed)
        self.vision_model = CLIPVisionTransformer(cfg.vision, device, gen)
        self.text_model = CLIPTextTransformer(cfg.text, device)
        self.visual_projection = nn.Linear(cfg.vision.hidden_size, cfg.projection_dim,
                                           bias=False, device=device)
        self.text_projection = nn.Linear(cfg.text.hidden_size, cfg.projection_dim, bias=False,
                                         device=device)
        self.logit_scale = nn.Parameter(torch.tensor(cfg.logit_scale_init, device=device))
        with torch.no_grad():
            self.vision_model.class_embedding.normal_(0.0, 0.02, generator=gen)
            for m in self.modules():
                if isinstance(m, (nn.Linear, nn.Embedding, Conv2dUnfold)):
                    m.weight.normal_(0.0, 0.02, generator=gen)
                if isinstance(m, nn.Linear) and m.bias is not None:
                    m.bias.zero_()

    @property
    def config(self):
        return self.cfg

    def get_image_features(self, pixel_values):
        return self.visual_projection(self.vision_model(pixel_values))

    def get_text_features(self, input_ids):
        return self.text_projection(self.text_model(input_ids))

    def forward(self, input_ids, pixel_values):
        """(logits per image [B_img, B_txt], logits per text [B_txt, B_img]):
        exp(logit_scale) times the cosine of the two features."""
        img = _unit_rows(self.get_image_features(pixel_values))
        txt = _unit_rows(self.get_text_features(input_ids))
        logits_per_text = torch.exp(self.logit_scale) * (txt @ img.T)
        return logits_per_text.T, logits_per_text

    def zero_shot_classify(self, pixel_values, class_text_ids):
        """Zero-shot classification (the reference's CLIP benchmark task):
        softmax over each image's scaled cosine against one tokenized prompt
        per class.  ``class_text_ids`` [n_classes, T]; returns the
        probabilities [B, n_classes]."""
        dev = pixel_values.device
        ids = torch.as_tensor(np.asarray(class_text_ids, dtype=np.int32)
                              if not torch.is_tensor(class_text_ids) else class_text_ids)
        img = _unit_rows(self.get_image_features(pixel_values))
        txt = _unit_rows(self.get_text_features(ids.to(device=dev, dtype=torch.int32)))
        logits = torch.exp(self.logit_scale) * (img @ txt.T)
        return torch.softmax(logits, dim=-1)

    @staticmethod
    def hf_tensor_converter(tensors):
        """HF CLIP layout -> this model's paths: drop the ``embeddings.`` and
        ``encoder.`` levels, and reshape the patch conv weight [out, in, k,
        k] to the im2col GEMM layout [out, in * k * k]."""
        out = {}
        for k, v in tensors.items():
            if "patch_embedding.weight" in k:
                v = v.reshape(v.shape[0], -1)
            k = k.replace(".embeddings.", ".").replace(".encoder.layers.", ".layers.")
            out[k] = v
        return out


def load_jax_params(model: CLIPModel, params: Dict[str, np.ndarray]) -> None:
    """Copy a raw JAX CLIP's weights into a raw port model, in place
    (``models.shared.load_jax_seq2seq_params``): the patch embedding's
    GEMM-shaped weight as it is (its cast state skipped), the CLS token and
    ``logit_scale`` (bare parameters) as they are."""
    load_jax_seq2seq_params(model, params, aliases={},
                            as_is=("vision_model.class_embedding", "logit_scale"))
