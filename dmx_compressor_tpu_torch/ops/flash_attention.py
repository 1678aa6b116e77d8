"""Blockwise (flash) attention (kernel B3).

Port of ``flash_attention_ref``, ``flash_attention``, ``sdpa_transparent``,
``flash_prefill`` and ``flash_chunked_prefill`` of
``dmx_compressor_tpu/ops/flash_attention.py``.  The CUDA kernel
(``csrc/flash_attention.cu``) streams K/V tiles through shared memory with
an online softmax in f32, so the [L, S] logits never reach device memory;
its two products run on the bf16 tensor cores over exact planes of their
f32 operands (:func:`flash_attention_planes_ref` transcribes them).
``flash_attention`` launches it for CUDA tensors and runs the plain version
for CPU tensors; K/V may hold fewer heads than q (GQA: query head h reads KV
head h // (H / Hkv)), read as they are on the wgmma route and repeated to
the query heads on the others.  ``flash_prefill`` and
``flash_chunked_prefill`` route a decoder family's prefill (Llama's; OPT has
its own routing) through it.  :func:`attention_route` names the route an
input takes through B2, B3 and B4: every input the JAX package computes has
one.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from .. import kernels
from .bfp_linear import split_bf16x3_ref

NEG_INF = -1e30
# the head dims the kernels are built for (B3: 32 and 64 one kernel, 128
# and 256 its wide form); B3 zero-pads any other D up to 256 to the next of
# them (:func:`flash_attention`), B2 and B4 take a multiple of 8 up to 256
# at run time; the rest takes each kernel's generic route
HEAD_DIMS = (32, 64, 128, 256)
# B3's wgmma route (head_dim 128, f32 q / k / v, no bias) from this many keys
# S on, and from WGMMA_MIN_KEYS_GQA where K/V hold fewer heads than q (the
# wide kernel then needs them repeated first): the crossover against the
# wide kernel measured on an H100 (chip_smoke.py's B3_CROSSOVER, PERF.md),
# which depends on S and not on the number of query tiles; over fewer KV
# heads the route won at 64 keys too, but short prefills and engine
# admissions stay on today's kernels
WGMMA_MIN_KEYS = 144
WGMMA_MIN_KEYS_GQA = 128


def kernel_head_dim(D: int) -> bool:
    """True for a head_dim that B2 and B4 take on their main kernels (B3 on
    its main kernels after the pad): a multiple of 8 up to 256."""
    return D % 8 == 0 and 8 <= D <= HEAD_DIMS[-1]


def b2_group(D: int) -> int:
    """The most query heads a KV head that one block of B2's main kernel
    serves (its shared memory and ``sm_m`` / ``sm_l``): more take the
    grouped route (csrc/flash_decode_int8.cu's ``max_group``)."""
    return 16 if D > 128 else 32


def attention_route(kernel: str, H: int, Hkv: int, D: int, dtypes=(), *,
                    S: Optional[int] = None) -> Optional[str]:
    """The route a launch of ``kernel`` ("flash_attention" B3,
    "flash_decode" B4 or "flash_decode_int8" B2) takes on the card for H
    query heads over Hkv KV heads of head_dim D and operands of ``dtypes``
    (B3: q, k, v and the bias where there is one; B4: q, k, v), B3 over S
    keys: None for the kernel's main route (today's paths), else the name its
    wrapper counts in ``kernels.ROUTE_LAUNCHES`` under ``<kernel>/``:

    - B3: "generic" above D 256 (f32 on the CUDA cores, any D), else
      "upcast" where an operand is not f32 (f32 copies made in the wrapper),
      else "wgmma" at D 128 without a bias from WGMMA_MIN_KEYS keys on
      (WGMMA_MIN_KEYS_GQA where Hkv < H; K/V read per KV head); any other D
      up to 256 is zero-padded to the next of HEAD_DIMS;
    - B4: "generic" for a D that is no multiple of 8 or above 256, else
      "f16" / "bf16" over a 16-bit cache read as stored (K and V of one
      such dtype; K/V of any other dtype, or of two, are widened to f32
      first, as the plain version does);
    - B2: "generic" as B4, else "grouped" above ``b2_group(D)`` query heads
      a KV head.

    Raises ValueError only where the JAX package cannot compute either: H
    not a multiple of Hkv, or no heads or dims."""
    if H < 1 or Hkv < 1 or D < 1 or H % Hkv:
        raise ValueError(f"attention needs H % Hkv == 0 and H, Hkv, D >= 1, got H={H}, "
                         f"Hkv={Hkv}, D={D}")
    if kernel == "flash_attention":
        if D > HEAD_DIMS[-1]:
            return "generic"
        if any(dt != torch.float32 for dt in dtypes):
            return "upcast"
        if D == 128 and len(dtypes) == 3 and S is not None and S >= (
                WGMMA_MIN_KEYS_GQA if Hkv < H else WGMMA_MIN_KEYS):
            return "wgmma"
        return None
    if kernel not in ("flash_decode", "flash_decode_int8"):
        raise ValueError(f"no attention kernel {kernel!r}")
    if not kernel_head_dim(D):
        return "generic"
    if kernel == "flash_decode_int8":
        return "grouped" if H // Hkv > b2_group(D) else None
    kv = tuple(dtypes[1:3])
    if len(kv) == 2 and kv[0] == kv[1] and kv[0] in (torch.float16, torch.bfloat16):
        return "f16" if kv[0] == torch.float16 else "bf16"
    return None


# the plane products (a's plane, b's plane; 0 = h, 1 = m, 2 = l) that the
# kernel takes of each of its two products: ml, lm and ll lie below 2^-21
# of |a||b| per term and are dropped
KEPT_PLANE_PRODUCTS = ((0, 0), (0, 1), (1, 0), (0, 2), (2, 0), (1, 1))


def _heads(q: torch.Tensor, k: torch.Tensor):
    """(H, Hkv): the query heads of q [..., H, L, D] and the KV heads of k
    [..., Hkv, S, D] (1, 1 without a head axis)."""
    if q.dim() < 3 or k.dim() < 3:
        return 1, 1
    H, Hkv = q.shape[-3], k.shape[-3]
    if H % Hkv:
        raise ValueError(f"attention needs H % Hkv == 0, got H={H}, Hkv={Hkv}")
    return H, Hkv


def _repeat_kv(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor):
    """K/V [..., Hkv, S, D] repeated to q's query heads (each KV head
    ``rep`` times in a row, ``jnp.repeat``'s order)."""
    H, Hkv = _heads(q, k)
    if H != Hkv:
        k = torch.repeat_interleave(k, H // Hkv, dim=-3)
        v = torch.repeat_interleave(v, H // Hkv, dim=-3)
    return k, v


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        bias: Optional[torch.Tensor] = None, scale: Optional[float] = None,
                        causal: bool = False) -> torch.Tensor:
    """Plain version, unblocked; same contract as the kernel (K/V of fewer
    heads than q repeated to them)."""
    k, v = _repeat_kv(q, k, v)
    L, D = q.shape[-2], q.shape[-1]
    S = k.shape[-2]
    scale = (D**-0.5) if scale is None else scale
    logits = torch.matmul(q.to(torch.float32), k.to(torch.float32).transpose(-1, -2)) * scale
    if bias is not None:
        logits = logits + bias.to(torch.float32)
    if causal:
        mask = torch.ones((L, S), dtype=torch.bool, device=q.device).tril(S - L)
        logits = logits.masked_fill(~mask, NEG_INF)
    w = torch.softmax(logits, dim=-1)
    return torch.matmul(w, v.to(torch.float32)).to(q.dtype)


def _plane_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b as the kernel takes it: the sum, in f32, of the kept products
    of the bf16 planes of a and b (each product exact in f32)."""
    pa = [p.float() for p in split_bf16x3_ref(a)]
    pb = [p.float() for p in split_bf16x3_ref(b)]
    out = torch.zeros(a.shape[:-1] + b.shape[-1:], dtype=torch.float32)
    for i, j in KEPT_PLANE_PRODUCTS[::-1]:  # the small products first
        out = out + torch.matmul(pa[i], pb[j])
    return out


def flash_attention_planes_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                               bias: Optional[torch.Tensor] = None,
                               scale: Optional[float] = None,
                               causal: bool = False) -> torch.Tensor:
    """Plain transcription of the kernel's arithmetic, for tests (f32 CPU
    tensors): q k^T and P v each from the six kept plane products, P =
    exp(logits - row max) unnormalized, the output divided by max(row sum,
    1e-30).  Unblocked: the kernel's online softmax differs from it only in
    the order of its f32 sums."""
    k, v = _repeat_kv(q, k, v)
    L, D = q.shape[-2], q.shape[-1]
    S = k.shape[-2]
    scale = (D**-0.5) if scale is None else scale
    logits = _plane_matmul(q, k.transpose(-1, -2)) * scale
    if bias is not None:
        logits = logits + bias
    if causal:
        mask = torch.ones((L, S), dtype=torch.bool).tril(S - L)
        logits = logits.masked_fill(~mask, -math.inf)
    p = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
    return _plane_matmul(p, v) / p.sum(dim=-1, keepdim=True).clamp_min(1e-30)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    bias: Optional[torch.Tensor] = None, scale: Optional[float] = None,
                    causal: bool = False) -> torch.Tensor:
    """softmax(q k^T * scale + bias) v, blockwise; in q's dtype.

    q: [..., L, D] ([..., H, L, D]); k, v: [..., S, D] ([..., Hkv, S, D],
    Hkv dividing H: query head h reads KV head h // (H / Hkv)); bias
    broadcastable to [..., L, S].  Causal masking puts the diagonal at S - L
    and needs S >= L.  The kernel
    takes float32 q, k, v and bias: operands of another dtype (fp16, bf16;
    an f32 q over a 16-bit cache's K/V at a chunked prefill) are copied to
    f32 first, which is what the plain version computes in.  Its main
    kernels take head_dim 32, 64, 128 or 256; any other D up to 256
    (OPT-2.7b's 80, or 100) runs at the next of them over q, k, v
    zero-padded along D, which is exact: the zero columns add nothing to q
    k^T, the padded output columns (P times zeros) are dropped, and the
    scale stays the true D's.  A D above 256 takes the generic kernel
    (:func:`attention_route`).  The wgmma route (D 128, f32, no bias, enough
    keys) reads K/V per KV head through their strides; the others take them
    repeated to the query heads, contiguous.
    """
    *lead, L, D = q.shape
    S = k.shape[-2]
    if causal and S < L:
        raise ValueError(f"causal attention needs S >= L, got L={L}, S={S}")
    H, Hkv = _heads(q, k)
    if not kernels.plain_or_kernel(q):
        return flash_attention_ref(q, k, v, bias, scale, causal)
    dtypes = (q.dtype, k.dtype, v.dtype) + ((bias.dtype,) if bias is not None else ())
    BH = math.prod(lead)
    route = attention_route("flash_attention", H, Hkv, D, dtypes, S=S)
    scale = (D**-0.5) if scale is None else float(scale)
    if route == "wgmma":
        return _flash_wgmma(q, k, v, scale, causal, H, Hkv)
    k, v = _repeat_kv(q, k, v)
    # the width launched: D itself on the generic route, else the next
    # instantiated one
    DP = D if route == "generic" else next(d for d in HEAD_DIMS if d >= D)
    f32 = torch.float32
    q2 = q.reshape(BH, L, D).to(f32).contiguous()
    k2 = k.reshape(BH, S, D).to(f32).contiguous()
    v2 = v.reshape(BH, S, D).to(f32).contiguous()
    if DP != D:
        q2, k2, v2 = (torch.nn.functional.pad(t, (0, DP - D)) for t in (q2, k2, v2))
    operands = [q2, k2, v2]
    b2 = None
    if bias is not None:
        b2 = torch.broadcast_to(bias, (*lead, L, S)).reshape(BH, L, S).to(f32).contiguous()
        operands.append(b2)
    kernels.check_cuda(*operands, dtypes=(f32,) * len(operands))
    out = torch.empty_like(q2)
    kernels.launch(
        "flash_attention",
        q2.data_ptr(), k2.data_ptr(), v2.data_ptr(),
        b2.data_ptr() if b2 is not None else None, out.data_ptr(),
        BH, L, S, DP, scale, int(causal), S - L, None, 1, 1, 0, 0, 0, 0, 0, 0, route=route,
    )
    return out[..., :D].reshape(*lead, L, D).to(q.dtype)


def _per_kv_head(t: torch.Tensor, Hkv: int):
    """K or V [..., Hkv, S, 128] f32 as [B, Hkv, S, 128] and its (b, head,
    key) strides, read in place where d is contiguous and the rows stay
    16-byte aligned (k after RoPE, v a view of the merged q/k/v projection);
    else a contiguous copy."""
    t4 = t.reshape(-1, Hkv, *t.shape[-2:])
    st = t4.stride()
    if st[-1] != 1 or any(x % 4 for x in st[:3]) or t4.data_ptr() % 16:
        t4 = t4.contiguous()
        st = t4.stride()
    return t4, st[:3]


def _flash_wgmma(q, k, v, scale: float, causal: bool, H: int, Hkv: int) -> torch.Tensor:
    """B3's wgmma route: one launch whose pre-pass splits K and V of each KV
    head into their planes in a scratch made here (K [B * Hkv, 3, S, 128],
    V^T [B * Hkv, 3, 128, Sp], Sp = S rounded up to 64), then the main
    kernel (csrc/flash_attention.cu)."""
    *lead, L, D = q.shape
    S = k.shape[-2]
    BH = math.prod(lead)
    f32 = torch.float32
    q2 = q.reshape(BH, L, D).contiguous()
    k4, ks = _per_kv_head(k, Hkv)
    v4, vs = _per_kv_head(v, Hkv)
    if k4.shape[0] * H != BH or v4.shape[0] * H != BH:
        raise ValueError(f"K/V {tuple(k.shape)} / {tuple(v.shape)} do not match q {tuple(q.shape)}")
    kernels.check_cuda(q2, dtypes=(f32,))
    kernels.check_cuda(k4, v4, dtypes=(f32, f32), contiguous=False)
    BHkv = BH // H * Hkv
    Sp = -(-S // 64) * 64
    planes = torch.empty(BHkv * 3 * D * (S + Sp), dtype=torch.bfloat16, device=q.device)
    out = torch.empty_like(q2)
    kernels.launch(
        "flash_attention",
        q2.data_ptr(), k4.data_ptr(), v4.data_ptr(), None, out.data_ptr(),
        BH, L, S, D, scale, int(causal), S - L, planes.data_ptr(), Hkv, H // Hkv, *ks, *vs,
        route="wgmma",
    )
    return out.reshape(*lead, L, D)


def sdpa_transparent(sdpa) -> bool:
    """True when the sdpa module applies no fake-quant cast or surrogate
    anywhere in its compound pipeline (weights-only serving): the flash and
    int8 kernels are then exact up to f32 summation order."""
    from ..functional.approximate import NoApproximation
    from ..numerics.format import Same

    def module_transparent(m) -> bool:
        casts = getattr(m, "input_casts", None)
        if casts is None:
            return True
        ok = all(isinstance(casts[kk].format, Same) for kk in casts.keys())
        outs = getattr(m, "output_casts", None)
        if outs is not None:
            ok = ok and all(isinstance(outs[kk].format, Same) for kk in outs.keys())
        apx = getattr(m, "approximator", None)
        if apx is not None:
            ok = ok and isinstance(apx.function, NoApproximation)
        return ok

    subs = [
        getattr(sdpa, name)
        for name in ("actmatmul", "resadd", "mul", "softmax", "dropout")
        if getattr(sdpa, name, None) is not None
    ]
    return module_transparent(sdpa) and all(module_transparent(s) for s in subs)


def flash_prefill(sdpa, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  scale: Optional[float] = None, cache=None,
                  transparent: Optional[bool] = None) -> Optional[torch.Tensor]:
    """A whole causal prefill from position 0 through the flash kernel when
    ``sdpa`` is transparent; None where the routing does not apply (the
    caller runs the masked sdpa).  ``cache`` (optional) is filled with k / v
    on the way.  A quantized cache is refused: its contract attends over the
    dequantized K/V even at prefill, so the fresh values would change the
    numerics.  ``transparent`` is the frozen ``sdpa_transparent(sdpa)``
    (None: asked here)."""
    if transparent is None:
        transparent = sdpa_transparent(sdpa)
    if q.shape[-2] <= 1 or not transparent:
        return None
    if cache is not None and cache.quantized:
        return None
    if cache is not None:
        if hasattr(cache, "write_base"):
            cache.write_base(k, v)
        else:
            cache.update(k, v)
    return flash_attention(q, k, v, causal=True, scale=scale)


def flash_chunked_prefill(sdpa, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, cache,
                          offset: int, scale: Optional[float] = None,
                          transparent: Optional[bool] = None) -> Optional[torch.Tensor]:
    """A prefill chunk: queries at [offset, offset + T) attend the cache's
    prefix [0, offset) and the fresh chunk, the kernel's causal diagonal at
    S - L.  Fills the cache.  None where the routing does not apply (a
    quantized or split cache, no cache, T == 1, an sdpa with casts)."""
    if transparent is None:
        transparent = sdpa_transparent(sdpa)
    T = q.shape[-2]
    if T <= 1 or not transparent:
        return None
    if cache is None or cache.quantized or hasattr(cache, "write_base"):
        return None
    kf, vf, _ = cache.update(k, v)
    return flash_attention(q, kf[..., :offset + T, :], vf[..., :offset + T, :], causal=True,
                           scale=scale)
