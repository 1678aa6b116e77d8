"""The port's functional interception against the JAX package's, on the CPU.

tests/test_intercept.py's functions written alike in torch: the site lists
are JAX's (scoped ids with the module path's dots where JAX's scopes have
slashes), identity rules exact, BASIC casts bit for bit the port's manual
casts and within ``BASIC_TOL`` of JAX's outputs, the same ValueError for an
unknown site, calibration through the sites' CastTos as the module path's.
On raw tiny OPT both packages enumerate 17 dots, 24 adds, 10 muls and 2 exps
with the same bare ids in the same order.
"""

from collections import Counter

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from dmx_compressor_tpu.modeling.model import DmxModel as JDmxModel
from dmx_compressor_tpu.models.opt import OPTConfig as JOPTConfig
from dmx_compressor_tpu.models.opt import OPTForCausalLM as JOPT
from dmx_compressor_tpu.transform.intercept import InterceptRules as JRules
from dmx_compressor_tpu.transform.intercept import SiteRule as JSite
from dmx_compressor_tpu.transform.intercept import intercept as jintercept

import dmx_compressor_tpu_torch as tdmx
from dmx_compressor_tpu_torch.modeling.model import DmxModel
from dmx_compressor_tpu_torch.models.opt import OPTConfig, OPTForCausalLM, load_jax_params
from dmx_compressor_tpu_torch.numerics.cast import CastTo
from dmx_compressor_tpu_torch.numerics.format import Format
from dmx_compressor_tpu_torch.numerics.observer import MinMaxObserver
from dmx_compressor_tpu_torch.transform import (
    InterceptRules,
    QuantizedFunction,
    SiteRule,
    intercept,
)
from test_torch_opt import flat_params

torch.set_num_threads(2)

BFP16 = "BFP[8|8]{64}(SN)"
FP16 = "FP[1|5|10,15](FN)"
INT8 = "XP[8,0](CSN)"
# BASIC outputs, port vs JAX: a cast one step apart cascades (0.0114 on tiny
# OPT's logits of magnitude up to 4.2; 1.9e-6 on the MLP)
BASIC_TOL = 0.03
# raw tiny OPT's sites with every kind on, the same in both packages
OPT_SITE_COUNTS = {"dot": 17, "add": 24, "mul": 10, "exp": 2}


def rand(shape, seed):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def both(*arrays):
    return tuple(map(jnp.asarray, arrays)), tuple(map(torch.from_numpy, arrays))


def mlp_args():
    return both(rand((4, 64), 0), rand((64, 64), 1), rand((64, 64), 2))


def jmlp(x, w1, w2):
    h = x @ w1
    h = jax.nn.relu(h)
    h = h @ w2
    return h + x


def tmlp(x, w1, w2):
    h = x @ w1
    h = torch.relu(h)
    h = h @ w2
    return h + x


def rules(pkg_rules, pkg_site, *kinds, **formats):
    return pkg_rules(**{k: pkg_site(**formats) for k in kinds})


# --------------------------------------------------------------- the sites


def test_sites_in_trace_order():
    (jx, jw1, jw2), (tx, tw1, tw2) = mlp_args()
    _, jsites = jintercept(jmlp, (jx, jw1, jw2))
    _, tsites = intercept(tmlp, (tx, tw1, tw2))
    assert tsites == jsites == ["dot_0", "dot_1", "add_0"]


def test_disabled_kinds_not_enumerated():
    (jx, jw1, jw2), (tx, tw1, tw2) = mlp_args()
    _, jsites = jintercept(jmlp, (jx, jw1, jw2), rules=JRules(dot=JSite()))
    _, tsites = intercept(tmlp, (tx, tw1, tw2), rules=InterceptRules(dot=SiteRule()))
    assert tsites == jsites == ["dot_0", "dot_1"]


def test_scalar_operand_adds_muls_not_sites():
    def jfn(x, w):
        h = (x @ w) * 0.5
        h = h + 1.0
        return (h * x) + x

    def tfn(x, w):
        h = (x @ w) * 0.5
        h = h + 1.0
        return (h * x) + x

    (jx, jw), (tx, tw) = both(rand((2, 128), 0), rand((128, 128), 1))
    _, jsites = jintercept(jfn, (jx, jw), rules=rules(JRules, JSite, "dot", "add", "mul"))
    _, tsites = intercept(tfn, (tx, tw), rules=rules(InterceptRules, SiteRule, "dot", "add",
                                                     "mul"))
    assert tsites == jsites == ["dot_0", "mul_0", "add_0"]
    # a rank-0 tensor operand is no site either
    _, tsites = intercept(lambda x: x + torch.tensor(1.0), (tx,),
                          rules=InterceptRules(add=SiteRule()))
    assert tsites == []


def test_nested_calls_recursed():
    """JAX recurses into a nested jit; an nn.Module called by the function is
    the port's nesting (the outermost module's own ops are unscoped)."""
    inner = jax.jit(lambda x, w: x @ w)

    class Inner(torch.nn.Module):
        def forward(self, x, w):
            return x @ w

    tinner = Inner()
    (jx, jw), (tx, tw) = both(rand((4, 64), 0), rand((64, 64), 1))
    _, jsites = jintercept(lambda x, w: inner(x, w) + x, (jx, jw))
    _, tsites = intercept(lambda x, w: tinner(x, w) + x, (tx, tw))
    assert tsites == jsites == ["dot_0", "add_0"]


def test_linear_is_a_dot_then_an_add():
    """F.linear with a bias (addmm) is JAX's dot_general then add."""
    lin = torch.nn.Linear(64, 32)
    _, tsites = intercept(lin, (torch.from_numpy(rand((3, 5, 64), 0)),))
    assert tsites == ["dot_0", "add_0"]


# ---------------------------------------------------------------- numerics


def test_identity_rules_exact():
    (jx, jw1, jw2), (tx, tw1, tw2) = mlp_args()
    qfn, _ = intercept(tmlp, (tx, tw1, tw2), rules=rules(InterceptRules, SiteRule, "dot", "add"))
    assert torch.equal(qfn(tx, tw1, tw2), tmlp(tx, tw1, tw2))


def test_basic_dot_matches_manual_casts_and_jax():
    (jx, jw), (tx, tw) = both(rand((8, 128), 3), rand((128, 64), 4))
    qfn, sites = intercept(lambda x, w: x @ w, (tx, tw),
                           rules=InterceptRules(dot=SiteRule(BFP16, BFP16, FP16)))
    assert sites == ["dot_0"]
    bfp, fp16 = Format.from_shorthand(BFP16), Format.from_shorthand(FP16)
    assert torch.equal(qfn(tx, tw), fp16.cast(bfp.cast(tx, -1) @ bfp.cast(tw, -2), -1))
    jq, _ = jintercept(lambda x, w: x @ w, (jx, jw),
                       rules=JRules(dot=JSite(BFP16, BFP16, FP16)))
    np.testing.assert_allclose(qfn(tx, tw).numpy(), np.asarray(jq(jx, jw)), atol=BASIC_TOL)


def test_basic_changes_values_but_stays_close_to_jax():
    (jx, jw1, jw2), (tx, tw1, tw2) = mlp_args()
    qfn, _ = intercept(tmlp, (tx, tw1, tw2))  # default = BASIC rules
    exact = tmlp(tx, tw1, tw2)
    quant = qfn(tx, tw1, tw2)
    diff = float((exact - quant).abs().max())
    assert 0.0 < diff < 0.1 * float(exact.abs().max())
    jq, _ = jintercept(jmlp, (jx, jw1, jw2))
    np.testing.assert_allclose(quant.numpy(), np.asarray(jq(jx, jw1, jw2)), atol=BASIC_TOL)


def test_per_site_override():
    _, (tx, tw1, tw2) = mlp_args()
    r = InterceptRules(dot=SiteRule(BFP16, BFP16, FP16),
                       overrides={"dot_0": SiteRule(), "dot_1": SiteRule()})
    qfn, _ = intercept(tmlp, (tx, tw1, tw2), rules=r)
    assert torch.equal(qfn(tx, tw1, tw2), tmlp(tx, tw1, tw2))


def test_remainder_blocks_cast_like_module_path():
    (jx, jw), (tx, tw) = both(rand((4, 100), 5), rand((100, 64), 6))
    qfn, _ = intercept(lambda x, w: x @ w, (tx, tw),
                       rules=InterceptRules(dot=SiteRule(BFP16, BFP16)))
    bfp = Format.from_shorthand(BFP16)
    got = qfn(tx, tw)
    assert torch.equal(got, bfp.cast(tx, -1) @ bfp.cast(tw, -2))
    assert not torch.equal(got, tx @ tw)
    jq, _ = jintercept(lambda x, w: x @ w, (jx, jw), rules=JRules(dot=JSite(BFP16, BFP16)))
    np.testing.assert_allclose(got.numpy(), np.asarray(jq(jx, jw)), rtol=1e-5, atol=1e-5)


def test_in_place_add_is_a_site_written_back():
    def fn(x, y):
        h = x * 1.0
        h += y
        return h

    (jx, jy), (tx, ty) = both(rand((4, 64), 7), rand((4, 64), 8))
    qfn, sites = intercept(fn, (tx, ty), rules=InterceptRules(add=SiteRule(FP16, FP16, FP16)))
    _, jsites = jintercept(fn, (jx, jy), rules=JRules(add=JSite(FP16, FP16, FP16)))
    assert sites == jsites == ["add_0"]
    fp16 = Format.from_shorthand(FP16)
    assert torch.equal(qfn(tx, ty), fp16.cast(fp16.cast(tx) + fp16.cast(ty)))


def test_another_path_raises():
    def fn(x):
        return x @ x.T if x.shape[0] == 4 else x

    qfn, _ = intercept(fn, (torch.ones(4, 64),), rules=InterceptRules(dot=SiteRule()))
    with pytest.raises(RuntimeError, match="other intercepted ops"):
        qfn(torch.ones(3, 64))


# ------------------------------------------------------------- composition


def test_pytree_args_and_outputs():
    def fn(params, x):
        h = x @ params["w1"]
        return {"out": h @ params["w2"], "skip": x}

    params = {"w1": torch.from_numpy(rand((64, 64), 1)), "w2": torch.from_numpy(rand((64, 64), 2))}
    x = torch.from_numpy(rand((4, 64), 0))
    qfn, sites = intercept(fn, (params, x))
    assert sites == ["dot_0", "dot_1"]
    out = qfn(params, x)
    assert set(out) == {"out", "skip"} and torch.equal(out["skip"], x)


def test_argument_structure_enforced():
    x, w = torch.from_numpy(rand((4, 64), 0)), torch.from_numpy(rand((64, 64), 1))
    qfn, _ = intercept(lambda x, w: x @ w, (x, w))
    with pytest.raises(AssertionError):
        qfn({"bad": x}, w)


def test_exp_interception():
    (jx,), (tx,) = both(rand((4, 64), 7))
    qfn, sites = intercept(torch.exp, (tx,), rules=InterceptRules(exp=SiteRule(FP16, FP16, FP16)))
    _, jsites = jintercept(jnp.exp, (jx,), rules=JRules(exp=JSite(FP16, FP16, FP16)))
    assert sites == jsites == ["exp_0"]
    fp16 = Format.from_shorthand(FP16)
    assert torch.equal(qfn(tx), fp16.cast(torch.exp(fp16.cast(tx, -1)), -1))


def test_softmax_is_its_exp_chain_when_exp_is_on():
    (jx,), (tx,) = both(rand((4, 64), 9))
    _, sites = intercept(lambda x: torch.softmax(x, -1), (tx,), rules=rules(
        InterceptRules, SiteRule, "dot", "add", "mul", "exp"))
    _, jsites = jintercept(lambda x: jax.nn.softmax(x, -1), (jx,), rules=rules(
        JRules, JSite, "dot", "add", "mul", "exp"))
    assert sites == jsites == ["exp_0"]


# ------------------------------------------------------ QuantizedFunction


def test_from_function_and_configure():
    _, (tx, tw1, tw2) = mlp_args()
    qf = DmxModel.from_function(tmlp, (tx, tw1, tw2))
    assert qf.sites == ["dot_0", "dot_1", "add_0"]
    exact = tmlp(tx, tw1, tw2)
    assert float((qf(tx, tw1, tw2) - exact).abs().max()) > 0.0
    qf.configure({s: SiteRule() for s in qf.sites})
    assert torch.equal(qf(tx, tw1, tw2), exact)


def test_configure_rejects_unknown_site():
    x, w = torch.from_numpy(rand((4, 64), 0)), torch.from_numpy(rand((64, 64), 1))
    qf = DmxModel.from_function(lambda x, w: x @ w, (x, w))
    jqf = JDmxModel.from_function(lambda x, w: x @ w, (jnp.asarray(x.numpy()),
                                                       jnp.asarray(w.numpy())))
    with pytest.raises(ValueError, match="unknown sites") as terr:
        qf.configure({"dot_999": SiteRule()})
    with pytest.raises(ValueError, match="unknown sites") as jerr:
        jqf.configure({"dot_999": JSite()})
    assert str(terr.value) == str(jerr.value)


def test_minmax_calibration_matches_module_path_and_jax():
    from dmx_compressor_tpu.numerics.observer import MinMaxObserver as JMinMax
    from dmx_compressor_tpu.transform.intercept import QuantizedFunction as JQF

    x = rand((16, 64), 11) * 0.7 + 1.3  # shifted: the zero point lands off center
    w = rand((64, 32), 12)
    (jx, jw), (tx, tw) = both(x, w)
    qf = QuantizedFunction(lambda x, w: x @ w, (tx, tw),
                           rules=InterceptRules(dot=SiteRule(INT8, "SAME", "SAME")))
    qf.enable_calibration(True, observer_cls=MinMaxObserver)
    qf(tx, tw)
    qf.enable_calibration(False)
    ref = CastTo(INT8)
    ref.enable_calibration(True, observer_cls=MinMaxObserver)
    ref(tx)
    ref.enable_calibration(False)
    got = qf.site_casts["dot_0"]["input"]
    assert torch.equal(got.scale, ref.scale) and torch.equal(got.zero_point, ref.zero_point)
    assert int(got.zero_point[0]) != 0
    assert torch.allclose(qf(tx, tw), ref(tx) @ tw, rtol=1e-6, atol=1e-6)
    jqf = JQF(lambda x, w: x @ w, (jx, jw), rules=JRules(dot=JSite(INT8, "SAME", "SAME")))
    jqf.enable_calibration(True, observer_cls=JMinMax)
    jqf(jx, jw)
    jqf.enable_calibration(False)
    jgot = jqf.site_casts["dot_0"]["input"]
    np.testing.assert_allclose(got.scale.numpy(), np.asarray(jgot.scale.value), rtol=1e-6)
    np.testing.assert_array_equal(got.zero_point.numpy(), np.asarray(jgot.zero_point.value))


def test_named_quantizers_walk():
    _, (tx, tw1, tw2) = mlp_args()
    triples = list(QuantizedFunction(tmlp, (tx, tw1, tw2)).named_quantizers())
    assert {t[0] for t in triples} == {"dot_0", "dot_1", "add_0"}
    assert {t[1] for t in triples} == {"input", "multiplier", "output"}


# ---------------------------------------------------------------- scopes


def jscoped(x, w1, w2):
    with jax.named_scope("encoder"):
        with jax.named_scope("attn"):
            h = x @ w1
        h = jax.nn.relu(h)
    with jax.named_scope("head"):
        return h @ w2 + x


class Attn(torch.nn.Module):
    def __init__(self, w):
        super().__init__()
        self.w = torch.nn.Parameter(w)

    def forward(self, x):
        return x @ self.w


class Encoder(torch.nn.Module):
    def __init__(self, w):
        super().__init__()
        self.attn = Attn(w)

    def forward(self, x):
        return torch.relu(self.attn(x))


class Head(torch.nn.Module):
    def __init__(self, w):
        super().__init__()
        self.w = torch.nn.Parameter(w)

    def forward(self, h, x):
        return h @ self.w + x


class Scoped(torch.nn.Module):
    """jscoped with its scopes as modules."""

    def __init__(self, w1, w2):
        super().__init__()
        self.encoder = Encoder(w1)
        self.head = Head(w2)

    def forward(self, x):
        return self.head(self.encoder(x), x)


@pytest.fixture
def scoped():
    (jx, jw1, jw2), (tx, tw1, tw2) = mlp_args()
    return (jx, jw1, jw2), Scoped(tw1, tw2), tx


def test_sites_carry_scopes(scoped):
    jargs, model, tx = scoped
    _, jsites = jintercept(jscoped, jargs)
    with torch.no_grad():
        _, tsites = intercept(model, (tx,))
    assert tsites == ["encoder.attn/dot_0", "head/dot_1", "head/add_0"]
    assert [s.replace(".", "/") for s in tsites] == jsites


@pytest.mark.parametrize("keys", [("encoder.attn/dot_0", "head/dot_1", "head/add_0"),
                                  ("dot_0", "dot_1", "add_0")], ids=["scoped", "bare"])
def test_overrides_address_scoped_sites(scoped, keys):
    _, model, tx = scoped
    r = InterceptRules.basic()
    r.overrides = {k: SiteRule() for k in keys}
    with torch.no_grad():
        qfn, _ = intercept(model, (tx,), rules=r)
        assert torch.equal(qfn(tx), model(tx))


def test_quantized_function_scoped_quantizers(scoped):
    _, model, tx = scoped
    with torch.no_grad():
        qf = QuantizedFunction(model, (tx,))
        assert {t[0] for t in qf.named_quantizers()} == {
            "encoder.attn/dot_0", "head/dot_1", "head/add_0"}
        qf.configure({"encoder.attn/dot_0": SiteRule()})
        assert qf(tx) is not None


# ----------------------------------------------------------------- tiny OPT


@pytest.fixture(scope="module")
def opt():
    jm = JOPT(JOPTConfig.tiny(), rngs=nnx.Rngs(0))
    tm = OPTForCausalLM(OPTConfig.tiny(), device="cpu")
    load_jax_params(tm, flat_params(jm))
    ids = np.random.default_rng(1).integers(0, JOPTConfig.tiny().vocab_size, (2, 16))
    return jm, tm, ids.astype(np.int32)


def test_opt_raw_site_counts_pinned_in_both(opt):
    jm, tm, ids = opt
    _, jsites = jintercept(lambda i: jm(i), (jnp.asarray(ids),),
                           rules=rules(JRules, JSite, "dot", "add", "mul", "exp"))
    with torch.no_grad():
        _, tsites = intercept(tm, (torch.from_numpy(ids),),
                              rules=rules(InterceptRules, SiteRule, "dot", "add", "mul", "exp"))
    kind = lambda s: s.rsplit("/", 1)[-1].rsplit("_", 1)[0]  # noqa: E731
    assert Counter(map(kind, tsites)) == Counter(map(kind, jsites)) == OPT_SITE_COUNTS
    assert [s.rsplit("/", 1)[-1] for s in tsites] == jsites
    assert tsites[4] == "model.decoder.layers.0.self_attn.q_proj/dot_0"


def test_opt_raw_basic_within_tolerance_of_jax(opt):
    jm, tm, ids = opt
    jq, jsites = jintercept(lambda i: jm(i), (jnp.asarray(ids),))
    want = np.asarray(jq(jnp.asarray(ids)))
    with torch.no_grad():
        qf = tdmx.DmxModel.from_function(tm, (torch.from_numpy(ids),))
        got = qf(torch.from_numpy(ids)).numpy()
        exact = tm(torch.from_numpy(ids)).numpy()
    assert [s.rsplit("/", 1)[-1] for s in qf.sites] == jsites
    np.testing.assert_allclose(got, want, atol=BASIC_TOL)
    assert np.abs(got - exact).max() > 10 * np.abs(got - want).max()


def test_family_tour_runs_on_the_cpu():
    """examples/family_tour.py over the port: the JAX tour's module counts
    per family, T5's generation shape, and part 3 through from_function."""
    from dmx_compressor_tpu_torch.examples.family_tour import tour

    out = tour("cpu")
    assert {k: v["dmx_modules"] for k, v in out["families"].items()} == dict(
        opt=38, gpt2=34, llama=44, mistral=44, gemma=44, qwen3=48)
    assert all(0 < v["delta"] < 0.1 for v in out["families"].values())
    assert out["t5_generate"] == (2, 7)
    assert out["intercept"]["sites"] == ["dot_0", "dot_1", "add_0"]
    assert 0 < out["intercept"]["delta"] < 10
