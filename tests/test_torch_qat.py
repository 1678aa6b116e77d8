"""Quantization-aware training in the port against the JAX package, on the
CPU: ``loss_fn``, the first BASIC training step's loss and gradients, the
two cases of tests/test_qat.py ported to ``torch.optim``, and the STE over
T2's wrapper under autograd.

The JAX OPT tiny of seed 0 carries its weights into the port
(``models.opt.load_jax_params``); the JAX side trains as tests/test_qat.py
does (``optax.adam(1e-3)`` on the Params of the BASIC model under
``jax.jit``), the port the same model through the modular BASIC forward
(``DmxModel.from_raw(m).to_basic_mode()``, ``DmxModule.inference_mode``
false) with ``torch.optim.Adam(lr=1e-3, eps=1e-8)``: optax's defaults.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import nnx

from dmx_compressor_tpu.modeling.model import DmxModel as JDmxModel
from dmx_compressor_tpu.models.opt import OPTConfig as JOPTConfig
from dmx_compressor_tpu.models.opt import OPTForCausalLM as JOPT
from dmx_compressor_tpu.models.opt import loss_fn as jloss_fn

import chip_smoke
from dmx_compressor_tpu_torch import DmxConfigRule
from dmx_compressor_tpu_torch import nn as dmxnn
from dmx_compressor_tpu_torch.modeling.model import DmxModel
from dmx_compressor_tpu_torch.models import loss_fn
from dmx_compressor_tpu_torch.models.opt import OPTConfig, OPTForCausalLM, load_jax_params
from dmx_compressor_tpu_torch.nn.core import DmxModule
from dmx_compressor_tpu_torch.numerics.cast import CastTo
from test_torch_opt import flat_params
from torch_seq2seq import spy

torch.set_num_threads(2)

STEPS = 12  # tests/test_qat.py's
# the first step's loss, port vs JAX: f32 sums in another order (measured
# 4.8e-7 of 7.06)
LOSS_RTOL = 1e-6
# each first-step gradient, port vs JAX: within GRAD_RTOL of its largest
# |entry| plus GRAD_ATOL, each twice the measured spread (1.0e-6 relative, at
# layer 1's self_attn_layer_norm.weight; 4.8e-9 absolute at k_proj.bias, whose
# gradient is 0 in exact arithmetic: the softmax ignores a shift of every
# key's score)
GRAD_RTOL = 2e-6
GRAD_ATOL = 1e-8
# the 12-step Adam loss curve, port vs JAX: twice the measured spread (0.0099
# at step 10 of 12, where the casts' steps compound)
CURVE_TOL = 0.02


@pytest.fixture(autouse=True)
def _restore_inference_mode():
    prev = DmxModule.inference_mode
    DmxModule.inference_mode = False
    yield
    DmxModule.inference_mode = prev


def batch(cfg):
    return np.random.RandomState(0).randint(0, cfg.vocab_size, (4, 16)).astype(np.int32)


def port_grads_by_jax_name(name: str) -> str:
    """The JAX BASIC model's Param path -> the port's parameter name.  Both
    carry the Dmx modules' ``weight`` [out, in] and ``bias``; nnx lists the
    table shared by the embedding and the head once, as ``lm_head.weight``."""
    name = name.removesuffix(".value")
    return "model.decoder.embed_tokens.weight" if name == "lm_head.weight" else name


@pytest.fixture(scope="module")
def jax_run():
    """tests/test_qat.py's first case on the JAX side: the initial weights,
    the 12 losses and the first step's gradients by the port's names."""
    cfg = JOPTConfig.tiny()
    model = JOPT(cfg, rngs=nnx.Rngs(0))
    params0 = flat_params(model)
    dm = JDmxModel.from_raw(model)
    dm.to_basic_mode()
    ids = jnp.asarray(batch(cfg))
    dm(ids)
    graphdef, params, rest = nnx.split(model, nnx.Param, ...)
    tx = optax.adam(1e-3)
    opt_state = tx.init(params)

    @jax.jit
    def step(params, opt_state):
        def loss_of(params):
            return jloss_fn(nnx.merge(graphdef, params, rest)(ids), ids)

        loss, grads = jax.value_and_grad(loss_of)(params)
        updates, opt_state = tx.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state, loss, grads

    losses, first = [], None
    for _ in range(STEPS):
        params, opt_state, loss, grads = step(params, opt_state)
        losses.append(float(loss))
        if first is None:
            first = {port_grads_by_jax_name(".".join(str(p) for p in path)):
                     np.asarray(v.get_value()) for path, v in nnx.to_flat_state(grads)}
    return params0, losses, first


def port_model(params0):
    m = OPTForCausalLM(OPTConfig.tiny(), device="cpu")
    load_jax_params(m, params0)
    dm = DmxModel.from_raw(m).to_basic_mode()
    return m, dm


def train(m, dm, ids, steps):
    """The port's QAT loop: Adam at optax's defaults; each step's loss and
    the first step's gradients by name."""
    with torch.no_grad():
        dm(ids)  # an eager forward first, as the JAX test does
    opt = torch.optim.Adam(m.parameters(), lr=1e-3, eps=1e-8)
    losses, first = [], None
    for _ in range(steps):
        opt.zero_grad()
        loss = loss_fn(dm(ids), ids)
        loss.backward()
        if first is None:
            first = {n: p.grad.clone() for n, p in m.named_parameters() if p.grad is not None}
        opt.step()
        losses.append(loss.item())
    return losses, first


def test_loss_fn_matches_jax():
    g = np.random.default_rng(5)
    logits = (g.standard_normal((3, 9, 50)) * 4).astype(np.float32)
    labels = g.integers(0, 50, (3, 9)).astype(np.int32)
    want = float(jloss_fn(jnp.asarray(logits), jnp.asarray(labels)))
    got = loss_fn(torch.from_numpy(logits), torch.from_numpy(labels))
    assert got.dtype == torch.float32 and got.ndim == 0
    np.testing.assert_allclose(float(got), want, rtol=1e-6)
    # bf16 logits are scored in f32, as JAX scores them
    want16 = float(jloss_fn(jnp.asarray(logits, jnp.bfloat16), jnp.asarray(labels)))
    got16 = loss_fn(torch.from_numpy(logits).to(torch.bfloat16), torch.from_numpy(labels))
    np.testing.assert_allclose(float(got16), want16, rtol=1e-6)


def test_qat_basic_loss_decreases(jax_run):
    """tests/test_qat.py's first case on the port: 12 Adam steps through the
    modular BASIC forward; the loss falls by more than 0.1 and q_proj gets a
    nonzero gradient; the first step's loss and every gradient, and the
    whole curve, held against JAX's."""
    params0, jlosses, jgrads = jax_run
    m, dm = port_model(params0)
    ids = torch.from_numpy(batch(OPTConfig.tiny())).long()
    losses, grads = train(m, dm, ids, STEPS)
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0] - 0.1, losses
    q = [float(g.abs().max()) for n, g in grads.items() if "q_proj" in n]
    assert q and max(q) > 0.0

    np.testing.assert_allclose(losses[0], jlosses[0], rtol=LOSS_RTOL)
    want = {n: g for n, g in jgrads.items() if g.size}  # the idle sparsifiers' (0,) scores
    assert set(grads) == set(want)
    for n, g in grads.items():
        scale = float(np.abs(want[n]).max())
        err = float(np.abs(g.numpy() - want[n]).max())
        assert err <= GRAD_RTOL * scale + GRAD_ATOL, (n, err, scale)
    np.testing.assert_allclose(losses, jlosses, rtol=0, atol=CURVE_TOL)


def test_qat_sparsity_sticks_through_training():
    """tests/test_qat.py's second case on the port: BTOPK-masked weights
    stay 4:8 sparse through 10 SGD steps (the mask is re-derived from the
    score each forward; the score, a Parameter made by the first forward,
    takes no gradient under the STE backward mode)."""
    torch.manual_seed(0)

    class Net(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.l1 = torch.nn.Linear(32, 64)
            self.l2 = torch.nn.Linear(64, 8)

        def forward(self, x):
            return self.l2(torch.relu(self.l1(x)))

    net = Net()
    dm = DmxModel.from_raw(net)
    dm.configure(None, DmxConfigRule(module_types=(dmxnn.Linear,),
                                     module_config=dict(weight_sparseness="BTOPK{4:8,-1}(U)")))
    x = torch.from_numpy(np.random.RandomState(0).randn(16, 32).astype(np.float32))
    y = torch.from_numpy(np.random.RandomState(1).randn(16, 8).astype(np.float32))
    with torch.no_grad():
        dm(x)  # makes the sparsifiers' scores
    score = dm.get_submodule("l1").weight_sparsifier.score.detach().clone()
    opt = torch.optim.SGD(net.parameters(), lr=1e-2)
    l0 = None
    for _ in range(10):
        opt.zero_grad()
        loss = torch.mean((dm(x) - y) ** 2)
        loss.backward()
        opt.step()
        l0 = l0 if l0 is not None else float(loss)
    assert float(loss) < l0
    assert torch.equal(dm.get_submodule("l1").weight_sparsifier.score, score)
    eff = dm.get_submodule("l1").effective_weight.detach()
    assert ((eff.reshape(64, -1, 8) != 0).sum(-1) <= 4).all(), "must stay 4:8 sparse"


@pytest.mark.parametrize("fmt,axis", [("BFP[8|8]{64}(SN)", 0), ("BFP[8|8]{64}(SN)", 1),
                                      ("FP[1|5|10,15](FN)", -1)])
def test_ste_over_t2_under_autograd(monkeypatch, fmt, axis):
    """A cast through T2's wrapper of a non-contiguous view that requires
    grad: the value is the cast of a contiguous copy, the gradient the
    identity, and the backward calls no T2."""
    g = torch.Generator().manual_seed(1)
    # a leaf [128, 192] of strides (1, 128): not contiguous
    x = torch.randn(192, 128, generator=g).T.clone().requires_grad_(True)
    assert not x.is_contiguous()
    cast = CastTo(fmt, block_dim=axis)
    counts = {}
    spy(monkeypatch, counts)
    y = cast(x)
    assert counts.get("t2") == 1
    w = torch.randn(y.shape, generator=g)
    (y * w).sum().backward()
    assert counts.get("t2") == 1, "the backward called T2"
    assert torch.equal(x.grad, w)
    with torch.no_grad():
        assert torch.equal(y.detach(), cast(x.detach().contiguous()))


def test_qat_t2_calls_are_chip_smoke_s(monkeypatch):
    """One QAT step's T2 wrapper calls at a width on the BFP block (a model
    of 128, heads of 64, 128 positions), the count chip_smoke.py holds the
    card to: 44L+7 in the forward (each Linear's input, weight and output
    casts among them), none in the backward."""
    for L in (1, 2):
        cfg = dataclasses.replace(OPTConfig.tiny(), hidden_size=128, ffn_dim=256,
                                  num_attention_heads=2, num_hidden_layers=L,
                                  max_position_embeddings=256)
        m = OPTForCausalLM(cfg, device="cpu")
        dm = DmxModel.from_raw(m).to_basic_mode()
        ids = torch.randint(0, cfg.vocab_size, (2, 128), generator=torch.Generator().manual_seed(0))
        counts = {}
        with monkeypatch.context() as mp:
            spy(mp, counts)
            loss = loss_fn(dm(ids), ids)
            forward = dict(counts)
            counts.clear()
            loss.backward()
        assert forward == {"t2": chip_smoke.qat_t2_launches(cfg)}, (L, forward)
        assert counts == {}, counts
