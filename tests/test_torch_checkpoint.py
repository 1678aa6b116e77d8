"""utils/checkpoint.py and utils/visualization.py of the port, on the CPU.

JAX's tests/test_checkpoint.py, case for case, over the port's
``torch.save`` checkpoints (orbax's in the JAX package):
``test_sharded_roundtrip_preserves_placement`` is not ported; it waits for
the port's parallelism (ROADMAP Queue A item 10).  Resume is bit for bit: a
QAT run through BASIC with Adam, interrupted, saved, restored into a fresh
model and optimizer, ends equal to the uninterrupted run.  The visualization
helpers give the JAX package's strings (tests/test_utils.py's cases).
"""

import json

import numpy as np
import pytest
import torch
from flax import nnx

from dmx_compressor_tpu.modeling.model import DmxModel as JDmxModel
from dmx_compressor_tpu.models.opt import OPTConfig as JOPTConfig
from dmx_compressor_tpu.models.opt import OPTForCausalLM as JOPT
from dmx_compressor_tpu.utils import visualization as jvis

from dmx_compressor_tpu_torch.modeling.model import DmxModel
from dmx_compressor_tpu_torch.models import loss_fn
from dmx_compressor_tpu_torch.models.opt import OPTConfig, OPTForCausalLM
from dmx_compressor_tpu_torch.nn.core import DmxModule
from dmx_compressor_tpu_torch.utils import visualization as tvis
from dmx_compressor_tpu_torch.utils.checkpoint import (
    CheckpointManager,
    restore_checkpoint,
    restored_config,
    save_checkpoint,
)
from dmx_compressor_tpu_torch.utils.io import dump_config_str

torch.set_num_threads(2)
RNG = np.random.default_rng(0)
CFG = dict(vocab_size=128, hidden_size=32, ffn_dim=64, num_hidden_layers=2,
           num_attention_heads=2, max_position_embeddings=64)


def _tiny_opt(seed=0):
    return OPTForCausalLM(OPTConfig(**CFG), device="cpu", seed=seed)


def _ids(*shape):
    return torch.from_numpy(RNG.integers(0, 128, shape)).long()


def test_roundtrip_params_and_quant_state(tmp_path):
    model = _tiny_opt(0)
    dm = DmxModel.from_raw(model).to_basic_mode()
    lin = next(m for n, m in dm.named_dmx_modules() if "fc1" in n)
    with torch.no_grad():  # calibrated-looking quantizer state the checkpoint must carry
        lin.input_casts["input_cast"].scale.fill_(0.123)
    ids = _ids(2, 9)
    with torch.no_grad():
        want = dm(ids)
    save_checkpoint(tmp_path / "ck", dm, step=7)

    dm2 = DmxModel.from_raw(_tiny_opt(1)).to_basic_mode()  # another init
    with torch.no_grad():
        assert not torch.allclose(dm2(ids), want)
    step, opt = restore_checkpoint(tmp_path / "ck", dm2)
    assert (step, opt) == (7, None)
    with torch.no_grad():
        assert torch.equal(dm2(ids), want)
    lin2 = next(m for n, m in dm2.named_dmx_modules() if "fc1" in n)
    assert torch.equal(lin2.input_casts["input_cast"].scale, torch.tensor([0.123]))


def test_config_tree_recorded(tmp_path):
    dm = DmxModel.from_raw(_tiny_opt(0)).to_basic_mode()
    save_checkpoint(tmp_path / "ck", dm)
    cfg = restored_config(tmp_path / "ck")
    assert cfg is not None and len(cfg) > 0
    fc1 = next(v for k, v in cfg.items() if "fc1" in k)
    assert "BFP" in repr(fc1.get("input_formats", ""))
    # the yaml round-trips byte for byte, and applies onto a fresh model
    frozen = dump_config_str({k: dict(v) for k, v in dm.dmx_config.items()})
    assert dump_config_str({k: dict(v) for k, v in cfg.items()}) == frozen
    with open(tmp_path / "ck" / "meta.json") as f:
        assert json.load(f)["dmx_config_yaml"] == frozen
    dm2 = DmxModel.from_raw(_tiny_opt(0))
    dm2.configure(cfg)
    assert dump_config_str({k: dict(v) for k, v in dm2.dmx_config.items()}) == frozen
    # a model without Dmx modules records none
    save_checkpoint(tmp_path / "plain", torch.nn.Linear(3, 2))
    assert restored_config(tmp_path / "plain") is None


def _qat(dm, opt, ids, n):
    losses = []
    for _ in range(n):
        opt.zero_grad(set_to_none=True)
        loss = loss_fn(dm(ids), ids)
        loss.backward()
        opt.step()
        losses.append(loss.item())
    return losses


@pytest.fixture
def training():
    prev, DmxModule.inference_mode = DmxModule.inference_mode, False
    yield
    DmxModule.inference_mode = prev


def _fresh(seed):
    dm = DmxModel.from_raw(_tiny_opt(seed)).to_basic_mode()
    return dm, torch.optim.Adam(dm.module.parameters(), lr=1e-3, eps=1e-8)


def test_optimizer_resume_bit_exact(tmp_path, training):
    """QAT through BASIC with Adam: 2 steps, save (model, optimizer, step),
    2 more; a fresh model and optimizer of another init restored from the
    checkpoint take the same 2 steps: the same losses and parameters, bit
    for bit."""
    ids = _ids(2, 8)
    dm, opt = _fresh(0)
    _qat(dm, opt, ids, 2)
    save_checkpoint(tmp_path / "ck", dm, optimizer_state=opt, step=2)
    direct = _qat(dm, opt, ids, 2)

    dm2, opt2 = _fresh(1)
    step, restored = restore_checkpoint(tmp_path / "ck", dm2, optimizer_state=opt2)
    assert step == 2 and restored is opt2
    assert _qat(dm2, opt2, ids, 2) == direct
    for a, b in zip(dm.module.parameters(), dm2.module.parameters()):
        assert torch.equal(a, b)
    # the saved optimizer state itself comes back where no optimizer is given
    _, sd = restore_checkpoint(tmp_path / "ck", dm2, optimizer_state={})
    assert int(sd["state"][0]["step"]) == 2


def test_restore_into_never_run_model(tmp_path):
    """The per-forward approximation errors are not checkpointed: a model
    that has run forwards restores into a fresh one that never has."""
    dm = DmxModel.from_raw(_tiny_opt(0)).to_basic_mode()
    ids = _ids(2, 9)
    with torch.no_grad():
        want = dm(ids)
    save_checkpoint(tmp_path / "ck", dm)
    saved = torch.load(tmp_path / "ck" / "model.pt", weights_only=True)
    assert not any(k.endswith("approximation_error") for k in saved)
    assert all(v.numel() for v in saved.values())  # no zero-size placeholder

    dm2 = DmxModel.from_raw(_tiny_opt(1)).to_basic_mode()
    restore_checkpoint(tmp_path / "ck", dm2)
    with torch.no_grad():
        assert torch.equal(dm2(ids), want)


def test_manager_retention_and_latest(tmp_path):
    model = _tiny_opt(0)
    mgr = CheckpointManager(tmp_path / "run", max_to_keep=2)
    for s in (1, 2, 3):
        mgr.save(s, model)
    assert mgr.steps() == [2, 3]
    step, _ = mgr.restore_latest(model)
    assert step == 3
    with pytest.raises(FileNotFoundError):
        CheckpointManager(tmp_path / "empty").restore_latest(model)


def test_restore_refuses_a_checkpoint_of_another_model(tmp_path):
    save_checkpoint(tmp_path / "ck", _tiny_opt(0))
    with pytest.raises(KeyError):
        restore_checkpoint(tmp_path / "ck", DmxModel.from_raw(_tiny_opt(0)).to_basic_mode()
                           .module.model.decoder.layers[0].fc1)
    save_checkpoint(tmp_path / "ck2", _tiny_opt(0), force=True)
    with pytest.raises(FileExistsError):
        save_checkpoint(tmp_path / "ck2", _tiny_opt(0), force=False)


# ---------------------------------------------------------------- visualization


@pytest.mark.parametrize("shape,dims", [((8, 8), (0, 1)), ((3, 10), (0, 1)),
                                        ((4, 6, 5), (0, 2)), ((200, 300), (0, 1)), ((7,), (0,))])
def test_mask2braille_gives_jax_strings(shape, dims):
    """tests/test_utils.py:122: the braille art of a mask, the JAX
    package's string (down-sampled beyond 4096 elements)."""
    mask = (np.random.default_rng(sum(shape)).random(shape) > 0.6).astype(np.float32)
    if shape == (8, 8):
        mask = np.zeros((8, 8))
        mask[::2, ::2] = 1
    got = tvis.mask2braille(torch.from_numpy(mask), dims=dims)
    assert got == jvis.mask2braille(mask, dims=dims)
    if shape == (8, 8):
        assert len(got.splitlines()) == 2
        assert all(0x2800 <= ord(c) <= 0x28FF for line in got.splitlines() for c in line)


def _jax_net():
    class Net(nnx.Module):
        def __init__(self):
            self.l1 = nnx.Linear(8, 4, rngs=nnx.Rngs(0))

        def __call__(self, x):
            return self.l1(x)

    return Net()


def _torch_net():
    class Net(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.l1 = torch.nn.Linear(8, 4)

        def forward(self, x):
            return self.l1(x)

    return Net()


def test_print_model_tree_gives_jax_strings():
    """tests/test_utils.py:136: the tree of a one-Linear net and of a tiny
    OPT, both in BASIC: the JAX package's string line for line."""
    jdm = JDmxModel.from_raw(_jax_net())
    jdm.to_basic_mode()
    tdm = DmxModel.from_raw(_torch_net()).to_basic_mode()
    out = tvis.print_model_tree(tdm, printer=None)
    assert "Linear" in out and "BFP[8|8]{64}(SN)" in out
    assert out == jvis.print_model_tree(jdm.module, printer=None)

    jm = JOPT(JOPTConfig(**CFG), rngs=nnx.Rngs(0))
    JDmxModel.from_raw(jm).to_basic_mode()
    tm = DmxModel.from_raw(_tiny_opt(0)).to_basic_mode()
    printed = []
    assert tvis.print_model_tree(tm, printer=printed.append) == jvis.print_model_tree(
        jm, printer=None)
    assert printed and printed[0].startswith("model: OPTForCausalLM")
