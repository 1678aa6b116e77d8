"""``work/`` against shapes worked by hand for one layer of each configuration."""

import pytest

from portbench import catalog, work
from portbench.families import opt, qwen3


def test_opt_layer_by_hand():
    cfg = catalog.config("opt-6.7b")
    # q/k/v merged 4096 -> 12288, out 4096 -> 4096, fc1 4096 -> 16384, fc2 16384 -> 4096
    per_layer = 4096 * 12288 + 4096 * 4096 + 2 * 4096 * 16384
    assert work.linear_params(opt, cfg) == 32 * per_layer + 4096 * 50272
    flops, nbytes = work.linear(2048, 4096, 16384)
    assert flops == 2 * 2048 * 4096 * 16384
    assert nbytes == 2048 * 4096 * 4 + 4096 * 16384 * (1 + 1 / 64) + 2048 * 16384 * 4
    # causal attention of one layer over 2048 positions, 32 heads of 128
    f, b = work.attention_prefill(32, 32, 128, 2048)
    assert f == 4 * 32 * 128 * 2048 * 2049 / 2
    assert b == 4 * 2048 * 128 * 4 * 32
    assert work.model_flops_prompt(opt, cfg, 2048) == pytest.approx(
        2 * work.linear_params(opt, cfg) * 2048 + 32 * f)


def test_qwen3_layer_by_hand():
    cfg = catalog.config("qwen3-0.6b")
    # q/k/v merged 1024 -> (16 + 8 + 8) x 128, o 2048 -> 1024, gate/up 1024 -> 6144,
    # down 3072 -> 1024
    per_layer = 1024 * 4096 + 2048 * 1024 + 1024 * 6144 + 3072 * 1024
    assert work.linear_params(qwen3, cfg) == 28 * per_layer + 1024 * 151936
    f, b = work.attention_prefill(16, 8, 128, 4096, batch=4)
    assert f == 4 * 4 * 16 * 128 * 4096 * 4097 / 2
    assert b == 4 * 4096 * 128 * 4 * (32 + 16)


def test_bounds_never_pass_the_peak():
    for M in (1, 16, 1024, 16384):
        f, b = work.linear(M, 4096, 4096)
        t = work.bound_s(f, b)
        assert f / t <= work.PEAK_FLOP_S * (1 + 1e-12) and b / t <= work.PEAK_BYTES_S * (1 + 1e-12)
