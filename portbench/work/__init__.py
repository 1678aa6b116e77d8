"""The yardstick: operations and bytes of each operation, counted from the
configuration and the shapes the traffic ran, whatever implements them.

- A matrix product counts 2 FLOPs per multiply-add of the product the
  configuration states, at the bf16 dense peak, never the exact bf16 planes
  that a kernel splits it into.
- Every input byte is read once and every output byte written once, at the
  HBM peak; a packed BFP16_64 weight is its int8 mantissas and one exponent
  byte a block of 64.
- A bound is the larger of the two times, so no implementation reads above
  100 %.

Peaks: NVIDIA H100 SXM data sheet, dense, at its 700 W limit.
"""

from __future__ import annotations

PEAK_FLOP_S = 989e12  # bf16 / fp16 dense
PEAK_BYTES_S = 3.35e12  # HBM3
F32 = 4


def bound_s(flops: float, nbytes: float) -> float:
    return max(flops / PEAK_FLOP_S, nbytes / PEAK_BYTES_S)


def linear(M: int, K: int, N: int, block: int = 64):
    """(flops, bytes) of y [M, N] = x [M, K] @ W^T, W packed BFP16_64, x and y
    float32."""
    w_bytes = K * N + (K // block) * N
    return 2.0 * M * K * N, float(M * K * F32 + w_bytes + M * N * F32)


def linears_bound_s(fam, cfg, M: int) -> float:
    """Σ of the bounds of one forward's packed linears at M rows."""
    total = 0.0
    for K, N, n in fam.linears(cfg):
        total += n * bound_s(*linear(M, K, N))
    return total


def attention_prefill(H: int, Hkv: int, D: int, T: int, batch: int = 1):
    """(flops, bytes) of causal attention over T positions from position 0:
    QK^T and PV over the T(T+1)/2 attended pairs; q, k, v (KV heads) read,
    out written, float32."""
    pairs = T * (T + 1) / 2
    flops = 4.0 * batch * H * D * pairs
    nbytes = batch * T * D * F32 * (2 * H + 2 * Hkv)
    return flops, float(nbytes)


def linear_params(fam, cfg) -> int:
    """Multiply-adds a token of every linear and the head."""
    return sum(K * N * n for K, N, n in fam.linears(cfg))


def model_flops_prompt(fam, cfg, n: int) -> float:
    """Model FLOPs of a causal forward over n tokens from position 0."""
    H, _, D = fam.heads(cfg)
    L = cfg["num_hidden_layers"]
    return 2.0 * linear_params(fam, cfg) * n + 4.0 * H * D * L * n * (n + 1) / 2
