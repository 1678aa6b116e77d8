"""The seeded traffic and weights repeat exactly."""

from types import SimpleNamespace

import torch

from portbench import weights

from .tiny import cell


def test_score_ids_repeat():
    from portbench.traffic import score

    c, cfg = cell("qwen3-0.6b.weights-score")

    def draw(seed):
        ctx = SimpleNamespace(cell=c, cfg=cfg, device=torch.device("cpu"),
                              ids_gen=score.ids_generator(seed, "cpu"))
        return [score._next_ids(ctx) for _ in range(3)]

    a, b, other = draw(2**33 + 5), draw(2**33 + 5), draw(12345)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not torch.equal(a[0], a[1]) and not torch.equal(a[0], other[0])
    assert a[0].shape == (c["params"]["batch"], c["params"]["seq"])


def test_weights_repeat_by_layer():
    from portbench.families import opt

    cfg = cell("opt-6.7b.weights-score")[1]
    a = weights.layer(opt, cfg, 7, 1, "cpu")
    b = weights.layer(opt, cfg, 7, 1, "cpu")
    c = weights.layer(opt, cfg, 7, 0, "cpu")
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["fc1.weight"], c["fc1.weight"])
    assert abs(a["fc1.weight"].std().item() - 0.02) < 2e-3
