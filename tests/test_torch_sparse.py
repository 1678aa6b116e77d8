"""Sparsity of the port held against the JAX package on the CPU: the
shorthands' round trip, every mask bit for bit (ties included), the STE /
supermask / joint gradients against ``jax.grad``, Bernoulli masks by their
statistics (the streams differ), a sparsified Linear's forward, fold and
config round trip.  The JAX sparsifier draws its score from
``jax.random.key(0)``: each test carries that score across, as weights are
carried."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from flax import nnx

import dmx_compressor_tpu as jdmx
from dmx_compressor_tpu import nn as jdmxnn
from dmx_compressor_tpu import sparse as jsp

import dmx_compressor_tpu_torch as tdmx
from dmx_compressor_tpu_torch import nn as tdmxnn
from dmx_compressor_tpu_torch import sparse as tsp
from dmx_compressor_tpu_torch.nn.core import DmxModuleConfig

torch.set_num_threads(2)

SHORTHANDS = ["DENSE", "TOPK{0.5}(M)", "TOPK{0.25}(U)", "BTOPK{4:8,-1}(U)",
              "BTOPK{2:8,1}(M)", "BTOPK{1:4,0}(U)", "BERN"]


def rand(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def ties(shape, seed=0, levels=3):
    """Scores drawn from a few values: most blocks hold ties at the
    threshold."""
    return np.random.default_rng(seed).integers(0, levels, shape).astype(np.float32)


@pytest.mark.parametrize("sh", SHORTHANDS)
def test_shorthand_round_trip_as_jax(sh):
    s = tsp.Sparseness.from_shorthand(sh)
    assert repr(s) == sh == repr(jsp.Sparseness.from_shorthand(sh))
    assert s.density == jsp.Sparseness.from_shorthand(sh).density
    assert s.blocked == jsp.Sparseness.from_shorthand(sh).blocked


def test_malformed_shorthands_raise():
    for sh in ("SPARSE", "TOPK{x}(U)", "BTOPK{4,8}(U)"):
        with pytest.raises(ValueError):
            tsp.Sparseness.from_shorthand(sh)


def test_sparseness_presets_are_jax_s():
    for name in ("BTK8_4_LD", "BTK8_4_FD", "BTK8_2_LD", "BTK8_2_FD"):
        assert repr(getattr(tdmx.sparseness, name)) == repr(getattr(jdmx.sparseness, name))


@pytest.mark.parametrize("name", ["BTK8_4_LD", "BTK8_4_FD", "BTK8_2_LD", "BTK8_2_FD"])
@pytest.mark.parametrize("make", [rand, ties])
def test_block_masks_bit_for_bit(name, make):
    """The four N:M presets over random scores and scores full of ties:
    JAX's mask exactly (the earliest tied entries pruned), K per block."""
    score = make((16, 32), 3)
    t = getattr(tdmx.sparseness, name).get_mask(torch.from_numpy(score))
    j = getattr(jdmx.sparseness, name).get_mask(jnp.asarray(score))
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    s = getattr(tdmx.sparseness, name)
    per_block = np.moveaxis(t.numpy(), s.block_dim, -1).reshape(-1, s.block_size).sum(-1)
    assert (per_block == s.K).all()


@pytest.mark.parametrize("density", [0.5, 0.25, 0.9, 1.0])
@pytest.mark.parametrize("make", [rand, ties])
def test_topk_mask_bit_for_bit(density, make):
    score = make((12, 20), 4)
    t = tsp.TopK(density=density).get_mask(torch.from_numpy(score))
    j = jsp.TopK(density=density).get_mask(jnp.asarray(score))
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))


def test_bernoulli_masks_by_statistics():
    s = tsp.Bernoulli()
    score = torch.full((20000,), 0.7)
    m = s.get_mask(score, generator=torch.Generator().manual_seed(3))
    assert set(m.unique().tolist()) <= {0.0, 1.0}
    assert abs(m.mean().item() - 0.7) < 0.02
    jm = np.asarray(jsp.Bernoulli().get_mask(jnp.full((20000,), 0.7), key=jax.random.key(0)))
    assert abs(jm.mean() - m.mean().item()) < 0.03
    assert tsp.Bernoulli().get_mask(score).equal(tsp.Bernoulli().get_mask(score))  # seed 0


def _pair(sh, mode, shape=(4, 16), seed=1):
    """A JAX and a port Sparsify of ``sh`` / ``mode``, training, the JAX
    score (key 0) carried into the port."""
    jsps = jsp.Sparsify(sparseness=sh, backward_mode=mode)
    jsps.training = True
    jsps._materialize(shape)
    tsps = tsp.Sparsify(sparseness=sh, backward_mode=mode)
    tsps.training = True
    tsps.score = torch.nn.Parameter(torch.from_numpy(np.asarray(jsps.score.get_value())))
    return jsps, tsps


@pytest.mark.parametrize("mode", ["STE", "supermask", "joint"])
@pytest.mark.parametrize("sh", ["BTOPK{4:8,-1}(U)", "TOPK{0.5}(U)", "BTOPK{2:8,-1}(M)"])
def test_gradients_match_jax_grad(sh, mode):
    """d/dw and d/dscore of sum(sparsify(w) * up), both packages: STE passes
    the mask to the weight, supermask the weight to the score (unless the
    pattern's own mask-gradient flag keeps the mask's zero gradient), joint
    both."""
    jsps, tsps = _pair(sh, mode)
    w = rand((4, 16), 2)
    up = rand((4, 16), 5)

    def jloss(m, x):
        return jnp.sum(m(x) * up)

    jgw = np.asarray(jax.grad(lambda x: jloss(jsps, x))(jnp.asarray(w)))
    jgs = np.asarray(nnx.grad(jloss)(jsps, jnp.asarray(w)).score.get_value())
    wt = torch.from_numpy(w).requires_grad_(True)
    loss = (tsps(wt) * torch.from_numpy(up)).sum()
    if loss.requires_grad:  # supermask over an "(M)" pattern: no gradient at all
        loss.backward()
    tgw = wt.grad.numpy() if wt.grad is not None else np.zeros_like(w)
    tgs = tsps.score.grad.numpy() if tsps.score.grad is not None else np.zeros_like(w)
    np.testing.assert_array_equal(tgw, jgw)
    np.testing.assert_array_equal(tgs, jgs)
    assert (np.abs(tgw).sum() > 0) == (mode != "supermask")


def test_dense_is_identity_and_adds_no_parameter():
    sp = tsp.Sparsify()
    w = torch.randn(4, 8)
    assert sp(w) is w and sp.score is None and list(sp.parameters()) == []
    assert tdmxnn.Linear(8, 4).weight_sparsifier.mask is None


def _linear_pair(sh, seed=0):
    jl = jdmxnn.Linear(16, 8, rngs=nnx.Rngs(seed))
    jl.configure(dict(weight_sparseness=sh))
    tl = tdmxnn.Linear(16, 8, device="cpu")
    with torch.no_grad():
        tl.weight.copy_(torch.from_numpy(np.asarray(jl.weight.get_value())))
        tl.bias.copy_(torch.from_numpy(np.asarray(jl.bias.get_value())))
    tl.configure(dict(weight_sparseness=sh))
    jl.weight_sparsifier._materialize(jl.weight.get_value().shape)
    tl.weight_sparsifier.score = torch.nn.Parameter(
        torch.from_numpy(np.asarray(jl.weight_sparsifier.score.get_value())))
    return jl, tl


@pytest.mark.parametrize("sh", ["BTOPK{4:8,-1}(U)", "BTOPK{2:8,1}(U)", "TOPK{0.25}(U)"])
def test_sparsified_linear_forward_fold_and_config_round_trip(sh):
    """The forward (within f32 summation order); the effective weight, the
    masked weight, bit for bit;
    ``fold_weight_and_bias`` bakes the mask in (the sparsifier dense after)
    with the same output; ``dmx_config`` names the pattern and configures a
    fresh module alike."""
    jl, tl = _linear_pair(sh)
    x = rand((3, 16), 7)
    want = np.asarray(jl(jnp.asarray(x)))
    with torch.no_grad():
        got = tl(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)  # f32 summation order
    np.testing.assert_array_equal(tl.effective_weight.detach().numpy(),
                                  np.asarray(jl.effective_weight))
    cfg = tl.dmx_config()
    assert repr(cfg["weight_sparseness"]) == sh == repr(jl.dmx_config()["weight_sparseness"])
    assert isinstance(cfg, DmxModuleConfig) and cfg["instance_of"] is tdmxnn.Linear
    fresh = tdmxnn.Linear(16, 8)
    fresh.configure(cfg)
    assert repr(fresh.weight_sparseness) == sh
    tl.fold_weight_and_bias()
    jl.fold_weight_and_bias()
    assert isinstance(tl.weight_sparseness, tsp.Dense)
    np.testing.assert_array_equal(tl.weight.detach().numpy(), np.asarray(jl.weight.get_value()))
    with torch.no_grad():
        np.testing.assert_array_equal(tl(torch.from_numpy(x)).numpy(), got)
    assert "weight_sparseness" not in tl.dmx_config()
    assert "weight_sparseness" in tl.dmx_config(freeze=True)


def test_density_and_flops_scale_with_the_pattern():
    jl, tl = _linear_pair("BTOPK{2:8,-1}(U)")
    assert tl.weight_sparsifier.density == 0.25 == jl.weight_sparsifier.density
    assert tl.weight_elem_count == 16 * 8 * 0.25 == jl.weight_elem_count
    # a default BERN sparsifier draws its score and its mask from the same
    # seed-0 stream (JAX: key(0) for both), so u < score never holds and it
    # prunes every weight, in both packages
    bern, jbern = tsp.Sparsify(sparseness="BERN"), jsp.Sparsify(sparseness="BERN")
    bern(torch.full((50, 40), 0.5))
    jbern(jnp.full((50, 40), 0.5))
    assert bern.density == jbern.density == 0.0
    bern.score = torch.nn.Parameter(torch.full((50, 40), 0.5))
    assert 0.4 < bern.density < 0.6


def test_sparsification_manager_reconfigures_every_sparsifier():
    mods = [tdmxnn.Linear(16, 8) for _ in range(3)]
    mgr = tsp.SparsificationManager([m.weight_sparsifier for m in mods])
    mgr.step(sparseness="BTOPK{4:8,-1}(U)", backward_mode="joint")
    assert all(repr(m.weight_sparseness) == "BTOPK{4:8,-1}(U)" for m in mods)
    assert all(m.weight_sparsifier.enable_mask_gradient for m in mods)
    assert tsp.LazySparsify is tsp.Sparsify
