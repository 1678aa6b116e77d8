"""The rest of the op zoo, port against the JAX package on the CPU: the
convolutions, pools, ReLU6, BatchNorm2d, GroupNorm, Exp and BAddBMM, the
experimental conv lowerings (unfold, scatter, gather), the substitution rows
and rules rows that reach them.

Both sides take the same weights and inputs, made with numpy from a seed.
Each module runs with its casts SAME and in a BASIC-like format set: the
module config that each package's own ``config_rules.BASIC`` gives its type
(BFP16_64 conv inputs and weights along the channel axis, FLOAT16
boundaries, the EXP surrogate), or, for BAddBMM and the experimental convs
that no rule names, that set written out.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

import dmx_compressor_tpu as jdmx
import dmx_compressor_tpu_torch as tdmx
from dmx_compressor_tpu import rawnn as jrawnn
from dmx_compressor_tpu.nn import experimental as jexp
from dmx_compressor_tpu.nn import modules as jnnm
from dmx_compressor_tpu.transform import substitute as jsub

from dmx_compressor_tpu_torch import rawnn
from dmx_compressor_tpu_torch.modeling.model import DmxModel
from dmx_compressor_tpu_torch.nn import experimental as texp
from dmx_compressor_tpu_torch.nn import modules as tnnm
from dmx_compressor_tpu_torch.transform import substitute as tsub

torch.set_num_threads(2)

# an f32 sum in another order (XLA's conv or reduction against torch's)
# moves a value by a few ulps; under BASIC its FLOAT16 output cast may then
# land one fp16 step (2^-10 relative) apart
TOL = {"same": dict(rtol=1e-5, atol=1e-5), "basic": dict(rtol=2e-3, atol=1e-5)}
FP16 = "FP[1|5|10,15](FN)"
BFP16_64 = "BFP[8|8]{64}(SN)"
# the BASIC-like set of the modules no rule names (tests/test_experimental.py's)
BASIC_GEMM = dict(input_formats=[BFP16_64], weight_format=BFP16_64, output_formats=[FP16])


def rng(seed):
    return np.random.default_rng(seed)


def rule_config(package, cls_name):
    """The module config of ``package``'s BASIC rule for ``cls_name``."""
    for rule in package.config_rules.BASIC:
        if any(t.__name__ == cls_name for t in rule.module_types):
            return dict(rule.module_config)
    raise KeyError(cls_name)


def configure(jm, tm, fmt, cls_name=None, config=None):
    if fmt == "basic":
        jm.configure(config or rule_config(jdmx, cls_name))
        tm.configure(config or rule_config(tdmx, cls_name))


def set_params(jm, tm, seed, scale=0.2):
    """Equal weights (and biases), standard normal x ``scale``, both sides."""
    g = rng(seed)
    for name in ("weight", "bias"):
        jp = getattr(jm, name, None)
        if jp is None:
            continue
        v = (g.standard_normal(jp.value.shape) * scale).astype(np.float32)
        jp.value = jnp.asarray(v)
        with torch.no_grad():
            getattr(tm, name).copy_(torch.from_numpy(v))


def both(jm, tm, *xs, **kw):
    """(JAX output, port output) as numpy on the same inputs."""
    want = np.asarray(jm(*[jnp.asarray(x) for x in xs], **kw))
    with torch.no_grad():
        got = tm(*[torch.from_numpy(x) for x in xs], **kw).numpy()
    return got, want


# ---------------------------------------------------------------------------
# convolutions
# ---------------------------------------------------------------------------

# (in, out, kernel, stride, padding, dilation, groups): channel blocks of 64
# (the BFP casts' T2 route), a stride with a dilation and groups, and
# channels off the block (the blockwise route)
CONV_GEOMETRY = [(64, 16, 3, 1, 1, 1, 1), (128, 32, 3, 2, 1, 2, 2), (6, 8, 5, 2, 2, 1, 1)]


@pytest.mark.parametrize("fmt", ["same", "basic"])
@pytest.mark.parametrize("geom", CONV_GEOMETRY)
@pytest.mark.parametrize("nd", [1, 2])
def test_conv_matches_jax(nd, geom, fmt):
    C, O, k, s, p, d, g = geom
    name = f"Conv{nd}d"
    jm = getattr(jnnm, name)(C, O, k, stride=s, padding=p, dilation=d, groups=g,
                             rngs=nnx.Rngs(0))
    tm = getattr(tnnm, name)(C, O, k, stride=s, padding=p, dilation=d, groups=g, device="cpu")
    assert tuple(tm.weight.shape) == tuple(jm.weight.value.shape)
    set_params(jm, tm, 1)
    configure(jm, tm, fmt, name)
    x = rng(2).standard_normal((2, C) + (11,) * nd).astype(np.float32)
    got, want = both(jm, tm, x)
    np.testing.assert_allclose(got, want, **TOL[fmt])
    assert tm._flops_for(x.shape, got.shape) == jm._flops_for(x.shape, want.shape)


def test_conv_unfold_for_hessian_matches_jax():
    jm = jnnm.Conv2d(6, 8, 3, stride=2, padding=1, dilation=1, rngs=nnx.Rngs(0))
    tm = tnnm.Conv2d(6, 8, 3, stride=2, padding=1, dilation=1, device="cpu")
    x = rng(3).standard_normal((2, 6, 9, 9)).astype(np.float32)
    np.testing.assert_array_equal(tm.unfold_input_for_hessian(torch.from_numpy(x)).numpy(),
                                  np.asarray(jm.unfold_input_for_hessian(jnp.asarray(x))))


@pytest.mark.parametrize("fmt", ["same", "basic"])
@pytest.mark.parametrize("geom", [(64, 64, 3, 2, 1, 1, 1, 1), (64, 64, 3, 1, 0, 0, 2, 1),
                                  (128, 64, 3, 2, 1, 0, 1, 2)])
def test_conv_transpose_matches_jax(geom, fmt):
    """At in == out * groups, the only shapes JAX's arithmetic takes
    (stride 2 with output padding, a dilation, groups 2)."""
    C, O, k, s, p, op, d, g = geom
    kw = dict(stride=s, padding=p, output_padding=op, dilation=d, groups=g)
    jm = jnnm.ConvTranspose2d(C, O, k, rngs=nnx.Rngs(0), **kw)
    tm = tnnm.ConvTranspose2d(C, O, k, device="cpu", **kw)
    set_params(jm, tm, 4)
    configure(jm, tm, fmt, "ConvTranspose2d")
    x = rng(5).standard_normal((2, C, 7, 7)).astype(np.float32)
    got, want = both(jm, tm, x)
    np.testing.assert_allclose(got, want, **TOL[fmt])


def test_conv_transpose_is_torch_s_at_in_equal_out():
    tm = tnnm.ConvTranspose2d(8, 8, 3, stride=2, padding=1, output_padding=1, device="cpu")
    x = torch.from_numpy(rng(6).standard_normal((2, 8, 5, 5)).astype(np.float32))
    with torch.no_grad():
        want = torch.nn.functional.conv_transpose2d(x, tm.weight, tm.bias, stride=2, padding=1,
                                                    output_padding=1)
        torch.testing.assert_close(tm(x), want, rtol=1e-5, atol=1e-5)


def test_conv_transpose_refuses_in_other_than_out_as_jax_fails():
    x = rng(7).standard_normal((2, 4, 5, 5)).astype(np.float32)
    jm = jnnm.ConvTranspose2d(4, 6, 3, stride=2, rngs=nnx.Rngs(0))
    with pytest.raises(ValueError):
        jm(jnp.asarray(x))
    with pytest.raises(ValueError, match="in_channels == out_channels"):
        tnnm.ConvTranspose2d(4, 6, 3, stride=2, device="cpu")


@pytest.mark.parametrize("nd", [1, 2])
def test_conv_from_raw_shares_torch_s_parameters(nd):
    raw = (torch.nn.Conv1d(6, 8, 3, stride=2, padding="valid") if nd == 1
           else torch.nn.Conv2d(6, 8, 3, padding="same", dilation=2, bias=False))
    mod = getattr(tnnm, f"Conv{nd}d").from_raw(raw)
    assert mod.weight is raw.weight and mod.bias is raw.bias
    x = torch.randn((2, 6) + (9,) * nd, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        torch.testing.assert_close(mod(x), raw(x), rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# pools, activations, norms, elementwise and batched matmul
# ---------------------------------------------------------------------------

POOLS = [("MaxPool2d", (3, 2, 1), (8, 8)), ("AvgPool2d", (3, 2, 1), (8, 8)),
         ("AvgPool2d", (2,), (8, 8)), ("AdaptiveAvgPool2d", ((2, 2),), (8, 8)),
         ("AdaptiveAvgPool2d", ((3, 5),), (8, 7))]  # the last: the general windows


@pytest.mark.parametrize("fmt", ["same", "basic"])
@pytest.mark.parametrize("name,args,hw", POOLS)
def test_pool_matches_jax(name, args, hw, fmt):
    jm, tm = getattr(jnnm, name)(*args), getattr(tnnm, name)(*args)
    configure(jm, tm, fmt, name)
    x = rng(8).standard_normal((2, 64) + hw).astype(np.float32)
    got, want = both(jm, tm, x)
    np.testing.assert_allclose(got, want, **TOL[fmt])


@pytest.mark.parametrize("fmt", ["same", "basic"])
@pytest.mark.parametrize("name", ["ReLU6", "Exp"])
def test_unary_matches_jax(name, fmt):
    """ReLU6 (BASIC: RELU6, no surrogate) and Exp (BASIC: the EXP
    surrogate)."""
    jm, tm = getattr(jnnm, name)(), getattr(tnnm, name)()
    configure(jm, tm, fmt, name)
    x = (rng(9).standard_normal((4, 8, 64)) * 4).astype(np.float32)
    got, want = both(jm, tm, x)
    np.testing.assert_allclose(got, want, **TOL[fmt])


@pytest.mark.parametrize("fmt", ["same", "basic"])
def test_baddbmm_matches_jax(fmt):
    """batch1 blocked along -1, batch2 along -2 (64 each: one block)."""
    jm, tm = jnnm.BAddBMM(), tnnm.BAddBMM()
    configure(jm, tm, fmt, config=dict(input_formats=[FP16, BFP16_64, BFP16_64],
                                       output_formats=[FP16]))
    g = rng(10)
    xs = [g.standard_normal(s).astype(np.float32) for s in ((4, 8, 16), (4, 8, 64), (4, 64, 16))]
    got, want = both(jm, tm, *xs, beta=0.5, alpha=2.0)
    np.testing.assert_allclose(got, want, **TOL[fmt])


@pytest.mark.parametrize("fmt", ["same", "basic"])
@pytest.mark.parametrize("branch", ["running", "batch", "untracked"])
def test_batchnorm_matches_jax(branch, fmt):
    """The running statistics (the default), the batch statistics with the
    running update (the module's own training flag), and no running
    statistics; the updated running mean and variance too."""
    track = branch != "untracked"
    jm = jnnm.BatchNorm2d(64, momentum=0.2, track_running_stats=track)
    tm = tnnm.BatchNorm2d(64, momentum=0.2, track_running_stats=track, device="cpu")
    assert not tm.bn_training and tm.training  # torch's flag is not the module's
    set_params(jm, tm, 11, scale=1.0)
    if track:
        g = rng(12)
        mean = g.standard_normal(64).astype(np.float32)
        var = (g.random(64) + 0.5).astype(np.float32)
        jm.running_mean.value, jm.running_var.value = jnp.asarray(mean), jnp.asarray(var)
        with torch.no_grad():
            tm.running_mean.copy_(torch.from_numpy(mean))
            tm.running_var.copy_(torch.from_numpy(var))
    if branch == "batch":
        jm.training, tm.bn_training = True, True
    configure(jm, tm, fmt, "BatchNorm2d")
    x = (rng(13).standard_normal((4, 64, 5, 5)) * 2 + 1).astype(np.float32)
    got, want = both(jm, tm, x)
    np.testing.assert_allclose(got, want, **TOL[fmt])
    if track:
        for name in ("running_mean", "running_var"):
            np.testing.assert_allclose(getattr(tm, name).numpy(),
                                       np.asarray(getattr(jm, name).value), rtol=1e-5, atol=1e-6)
        assert int(tm.num_batches_tracked) == int(jm.num_batches_tracked.value)


@pytest.mark.parametrize("fmt", ["same", "basic"])
def test_groupnorm_matches_jax(fmt):
    jm, tm = jnnm.GroupNorm(8, 64), tnnm.GroupNorm(8, 64, device="cpu")
    set_params(jm, tm, 14, scale=1.0)
    configure(jm, tm, fmt, "GroupNorm")
    x = (rng(15).standard_normal((2, 64, 4, 5)) * 3).astype(np.float32)
    got, want = both(jm, tm, x)
    np.testing.assert_allclose(got, want, **TOL[fmt])


def test_norms_from_raw_share_torch_s_state():
    bn, gn = torch.nn.BatchNorm2d(6, momentum=0.3), torch.nn.GroupNorm(2, 6)
    with torch.no_grad():
        for m in (bn, gn):
            m.weight.uniform_(0.5, 1.5)
            m.bias.uniform_(-0.5, 0.5)
        bn.running_mean.uniform_(-1, 1)
        bn.running_var.uniform_(0.5, 2)
    tbn, tgn = tnnm.BatchNorm2d.from_raw(bn), tnnm.GroupNorm.from_raw(gn)
    assert tbn.running_mean is bn.running_mean and tbn.weight is bn.weight
    assert tbn.momentum == 0.3 and not tbn.bn_training
    x = torch.randn(3, 6, 4, 4, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        torch.testing.assert_close(tbn(x), bn.eval()(x), rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(tgn(x), gn(x), rtol=1e-5, atol=1e-5)
        tbn.bn_training, bn.training = True, True
        torch.testing.assert_close(tbn(x), bn(x), rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# the experimental conv lowerings
# ---------------------------------------------------------------------------

def conv_pair(nd, seed, C=16, O=24, k=4, stride=2, padding=1, dilation=1):
    jc = getattr(jnnm, f"Conv{nd}d")(C, O, k, stride=stride, padding=padding,
                                     dilation=dilation, rngs=nnx.Rngs(0))
    tc = getattr(tnnm, f"Conv{nd}d")(C, O, k, stride=stride, padding=padding,
                                     dilation=dilation, device="cpu")
    set_params(jc, tc, seed)
    return jc, tc


@pytest.mark.parametrize("fmt", ["same", "basic"])
@pytest.mark.parametrize("cls,nd", [("Conv1dUnfold", 1), ("Conv1dScatter", 1),
                                    ("Conv2dUnfold", 2), ("Conv2dGather", 2)])
def test_experimental_conv_matches_jax(cls, nd, fmt):
    """``from_conv`` of equal convs (C x prod(k) = 64 or 256: whole blocks),
    each side's form against the other's."""
    jc, tc = conv_pair(nd, 16)
    jm, tm = getattr(jexp, cls).from_conv(jc), getattr(texp, cls).from_conv(tc)
    np.testing.assert_array_equal(tm.weight.detach().numpy(), np.asarray(jm.weight.value))
    configure(jm, tm, fmt, config=BASIC_GEMM)
    x = rng(17).standard_normal((2, 16) + (13,) * nd).astype(np.float32)
    got, want = both(jm, tm, x)
    np.testing.assert_allclose(got, want, **TOL[fmt])
    if fmt == "same":
        with torch.no_grad():
            np.testing.assert_allclose(got, tc(torch.from_numpy(x)).numpy(), **TOL[fmt])


@pytest.mark.parametrize("fmt", ["same", "basic"])
@pytest.mark.parametrize("stride,padding,dilation", [(1, 1, 1), (2, 0, 1), (2, 1, 2)])
def test_gather_is_bit_equal_to_unfold(stride, padding, dilation, fmt):
    _, tc = conv_pair(2, 18, stride=stride, padding=padding, dilation=dilation)
    unfold, gather = texp.Conv2dUnfold.from_conv(tc), texp.Conv2dGather.from_conv(tc)
    if fmt == "basic":
        unfold.configure(dict(BASIC_GEMM))
        gather.configure(dict(BASIC_GEMM))
    x = torch.from_numpy(rng(19).standard_normal((2, 16, 12, 11)).astype(np.float32))
    with torch.no_grad():
        torch.testing.assert_close(gather(x), unfold(x), rtol=0, atol=0)


@pytest.mark.parametrize("fmt", ["same", "basic"])
@pytest.mark.parametrize("stride,dilation", [(1, 1), (2, 1), (1, 2)])
def test_scatter_sums_the_unfold_products(stride, dilation, fmt):
    """Per-tap f32 partials in tap order: the unfold form's products summed
    in another order."""
    _, tc = conv_pair(1, 20, stride=stride, dilation=dilation)
    unfold, scatter = texp.Conv1dUnfold.from_conv(tc), texp.Conv1dScatter.from_conv(tc)
    if fmt == "basic":
        unfold.configure(dict(BASIC_GEMM))
        scatter.configure(dict(BASIC_GEMM))
    x = torch.from_numpy(rng(21).standard_normal((2, 16, 23)).astype(np.float32))
    with torch.no_grad():
        torch.testing.assert_close(scatter(x), unfold(x), **TOL[fmt])


@pytest.mark.parametrize("cls,nd", [("Conv1dUnfold", 1), ("Conv1dScatter", 1),
                                    ("Conv2dUnfold", 2), ("Conv2dGather", 2)])
def test_experimental_from_raw_is_torch_s_conv(cls, nd):
    raw = getattr(torch.nn, f"Conv{nd}d")(6, 10, 3, stride=2, padding=1)
    mod = getattr(texp, cls).from_raw(raw)
    assert tuple(mod.weight.shape) == (10, 6 * 3 ** nd)
    x = torch.randn((2, 6) + (10,) * nd, generator=torch.Generator().manual_seed(2))
    with torch.no_grad():
        torch.testing.assert_close(mod(x), raw(x), rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# substitution rows and rules rows
# ---------------------------------------------------------------------------

def test_raw_op_rows_are_jax_s():
    """Every rawnn wrapper JAX maps has a twin mapping to the Dmx module of
    the same name."""
    def names(mapping):
        return {k.__name__: v.__self__.__name__ for k, v in mapping.items()}

    assert names(tsub.RAW_OP_MAPPING) == names(jsub.RAW_OP_MAPPING)
    assert {k.__name__ for k in tsub.RAW_OP_MAPPING} == {
        n for n in dir(rawnn) if isinstance(getattr(rawnn, n), type)
        and issubclass(getattr(rawnn, n), torch.nn.Module)}
    assert {n for n in dir(jrawnn) if isinstance(getattr(jrawnn, n), type)
            and issubclass(getattr(jrawnn, n), nnx.Module)} == set(names(jsub.RAW_OP_MAPPING))


# raw module, input shape -> the Dmx module it becomes
TORCH_ROWS = [
    (lambda: torch.nn.Conv1d(8, 4, 3, padding=1), (2, 8, 9), tnnm.Conv1d),
    (lambda: torch.nn.Conv2d(8, 4, 3, stride=2), (2, 8, 9, 9), tnnm.Conv2d),
    (lambda: torch.nn.RMSNorm(8, eps=1e-6), (2, 5, 8), tnnm.RMSNorm),
    (lambda: torch.nn.BatchNorm2d(8).eval(), (2, 8, 3, 3), tnnm.BatchNorm2d),
    (lambda: torch.nn.GroupNorm(2, 8), (2, 8, 3, 3), tnnm.GroupNorm),
    (lambda: torch.nn.Dropout(0.1).eval(), (2, 8), tnnm.Dropout),
    (lambda: rawnn.MatMul(), ((2, 3, 8), (2, 8, 4)), tnnm.ActActMatMul),
    (lambda: rawnn.BAddBMM(), ((2, 3, 4), (2, 3, 8), (2, 8, 4)), tnnm.BAddBMM),
    (lambda: rawnn.Exp(), (2, 8), tnnm.Exp),
    (lambda: rawnn.Softmax(dim=1), (2, 8, 3), tnnm.Softmax),
    (lambda: rawnn.ReLU6(), (2, 8), tnnm.ReLU6),
    (lambda: rawnn.Dropout(0.1), (2, 8), tnnm.Dropout),
]


@pytest.mark.parametrize("make,shape,dmx", TORCH_ROWS,
                         ids=[r[2].__name__ + str(i) for i, r in enumerate(TORCH_ROWS)])
def test_substitution_row_maps_and_keeps_the_function(make, shape, dmx):
    class Holder(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.op = make()

    raw = Holder()
    shapes = shape if isinstance(shape[0], tuple) else (shape,)
    g = torch.Generator().manual_seed(3)
    xs = [torch.randn(s, generator=g) for s in shapes]
    with torch.no_grad():
        want = raw.op(*xs)
        dm = DmxModel.from_raw(raw)
        assert type(dm.module.op) is dmx
        dm.to_baseline_mode()
        torch.testing.assert_close(dm.module.op(*xs), want, rtol=1e-5, atol=1e-6)


def test_basic_rules_configure_the_zoo_as_jax_s():
    """After ``to_basic_mode`` each new module type carries the formats and
    the approximation JAX's does (by shorthand)."""
    def state(m):
        return (
            [repr(f) for f in m.input_formats.values()],
            [repr(f) for f in m.output_formats.values()],
            repr(m.weight_format) if m.weight_cast is not None else None,
            repr(m.bias_format) if getattr(m, "bias_cast", None) is not None else None,
            repr(m.approximation_function),
        )

    built = {}
    for name, args in [("Conv1d", (64, 8, 3)), ("Conv2d", (64, 8, 3)),
                       ("ConvTranspose2d", (8, 8, 3)), ("MaxPool2d", (2,)), ("AvgPool2d", (2,)),
                       ("AdaptiveAvgPool2d", (2,)), ("ReLU6", ()), ("BatchNorm2d", (8,)),
                       ("GroupNorm", (2, 8)), ("Exp", ())]:
        jm = getattr(jnnm, name)(*args, **({"rngs": nnx.Rngs(0)} if "Conv" in name else {}))
        tm = getattr(tnnm, name)(*args, **({"device": "cpu"} if "Conv" in name else {}))
        for rule in jdmx.config_rules.BASIC:
            if isinstance(jm, rule.module_types):
                jm.configure(rule.module_config)
        for rule in tdmx.config_rules.BASIC:
            if isinstance(tm, rule.module_types):
                tm.configure(rule.module_config)
        built[name] = state(tm)
        assert built[name] == state(jm), name
    assert built["Exp"][4] == repr(tdmx.default_approx.EXP)
