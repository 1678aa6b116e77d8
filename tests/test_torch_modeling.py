"""The port's model-level API against the JAX package's, on the CPU.

The public names of each subpackage against JAX's (what the port still
lacks, each name with the ROADMAP item that ports it or the reason it is
JAX's alone); ``DmxConfig`` / ``DmxConfigRule`` / ``DmxModel``'s
configuration queue, freeze and thaw (a yaml frozen by one package thaws in
the other: module configs equal by shorthand, outputs equal at the BASIC
legs' tolerance); ``compiled``; the pipelines.
"""

import importlib
import pkgutil
import types
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

import dmx_compressor_tpu as jdmx
from dmx_compressor_tpu import nn as jnn
from dmx_compressor_tpu import rawnn as jrawnn
from dmx_compressor_tpu.models.lenet import LeNet5 as JLeNet5
from dmx_compressor_tpu.modeling.model import DmxConfig as JDmxConfig
from dmx_compressor_tpu.modeling.model import DmxConfigRule as JDmxConfigRule
from dmx_compressor_tpu.modeling.model import DmxModel as JDmxModel

import dmx_compressor_tpu_torch as tdmx
from dmx_compressor_tpu_torch import kernels
from dmx_compressor_tpu_torch import nn as tnn
from dmx_compressor_tpu_torch import rawnn
from dmx_compressor_tpu_torch.modeling.model import (
    DmxConfig,
    DmxConfigRule,
    DmxModel,
    DmxSimplePipeline,
    Model,
)
from dmx_compressor_tpu_torch.models import lenet as tl
from test_torch_opt import flat_params

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parent.parent
LENET_YAML = str(ROOT / "configs" / "dmx_example_config_lenet5.yaml")
# BASIC outputs, port vs JAX: a BFP or FLOAT16 cast may land one step apart
# (tests/test_torch_lenet.py's MODE_TOL)
MODE_TOL = 4e-3

SUBPACKAGES = ["", "nn", "models", "modeling", "numerics", "functional", "sparse", "serving",
               "transform", "utils", "parallel"]
# each name the JAX package exports that the port still lacks -> the
# ROADMAP Queue A item that ports it, or why it is the JAX package's alone
STILL_MISSING = {
    "numerics": {"QuantState": "JAX only: an nnx.Variable (the port's quantizer state is "
                               "buffers)"},
}
# each module of the JAX package's subpackages that the port lacks
STILL_MISSING_MODULES = {}
# DmxModel's public members the port lacks
STILL_MISSING_MEMBERS = {
    "from_nnx": "JAX only: the alias of from_raw for nnx models",
}


def public(mod) -> set:
    """``__all__`` and the names a module binds: its package's own classes
    and functions, and its values (namespaces, flags); not submodules, not
    what it imports from elsewhere."""
    root = mod.__name__.split(".")[0]
    out = set(getattr(mod, "__all__", ()))
    for n, v in vars(mod).items():
        if n.startswith("_") or isinstance(v, types.ModuleType):
            continue
        if callable(v):
            if getattr(v, "__module__", "").split(".")[0] != root:
                continue
        elif type(v).__module__ in ("__future__", "typing"):
            continue
        out.add(n)
    return out


def _pair(sub):
    suffix = "." + sub if sub else ""
    return (importlib.import_module("dmx_compressor_tpu" + suffix),
            importlib.import_module("dmx_compressor_tpu_torch" + suffix))


@pytest.mark.parametrize("sub", SUBPACKAGES)
def test_namespace_lacks_only_what_roadmap_lists(sub):
    j, t = _pair(sub)
    assert public(j) - public(t) == set(STILL_MISSING.get(sub, {})), sub
    if hasattr(j, "__path__"):
        jm = {m.name for m in pkgutil.iter_modules(j.__path__)}
        tm = {m.name for m in pkgutil.iter_modules(t.__path__)}
        assert jm - tm == set(STILL_MISSING_MODULES.get(sub, {})), sub


def test_star_import_binds_jax_s_names():
    ns = {}
    exec("from dmx_compressor_tpu_torch import *", ns)
    for name in ("Sparseness", "sparseness", "DmxConfig", "DmxTransformation",
                 "DmxSimplePipeline", "Model"):
        assert name in ns, name
    assert set(tdmx.__all__) == set(jdmx.__all__)
    assert tdmx.VSIMD_OP_REF_AVAILABLE is jdmx.VSIMD_OP_REF_AVAILABLE
    assert tdmx.NUMERICS_UTILS_AVAILABLE is jdmx.NUMERICS_UTILS_AVAILABLE
    assert tdmx.functional.Identity is tdmx.functional.NoApproximation


def test_dmx_model_members_lack_only_what_roadmap_lists():
    def members(cls):
        return {n for n in dir(cls) if not n.startswith("_")}

    assert members(JDmxModel) - members(DmxModel) == set(STILL_MISSING_MEMBERS)
    assert members(DmxModel) <= members(JDmxModel)
    for cls in ("DmxConfig", "DmxConfigRule", "DmxSimplePipeline", "DmxPipelineMixin"):
        j, t = (getattr(m.modeling, cls) for m in (jdmx, tdmx))
        assert members(j) - {"count", "copy", "fromkeys", "clear"} <= members(t), cls


# ------------------------------------------------------------------ models


class JLeNetNCHW(nnx.Module):
    """tests/test_transform.py's LeNetNCHW."""

    def __init__(self, rngs):
        self.l1 = nnx.Linear(16, 32, rngs=rngs)
        self.act = jrawnn.ReLU()
        self.l2 = nnx.Linear(32, 4, rngs=rngs)
        self.sm = jrawnn.Softmax(dim=-1)

    def __call__(self, x):
        return self.sm(self.l2(self.act(self.l1(x))))


class LeNetNCHW(torch.nn.Module):
    """The same network in the port, its weights the JAX model's."""

    def __init__(self, params):
        super().__init__()
        self.l1 = torch.nn.Linear(16, 32)
        self.act = rawnn.ReLU()
        self.l2 = torch.nn.Linear(32, 4)
        self.sm = rawnn.Softmax(dim=-1)
        with torch.no_grad():
            for n in ("l1", "l2"):
                getattr(self, n).weight.copy_(torch.from_numpy(params[f"{n}.kernel"].T))
                getattr(self, n).bias.copy_(torch.from_numpy(params[f"{n}.bias"]))

    def forward(self, x):
        return self.sm(self.l2(self.act(self.l1(x))))


def nchw_pair():
    jm = JLeNetNCHW(nnx.Rngs(0))
    tm = LeNetNCHW(flat_params(jm))
    return JDmxModel.from_raw(jm), DmxModel.from_raw(tm)


def lenet_pair():
    jm = JLeNet5(rngs=nnx.Rngs(7))
    tm = tl.LeNet5(device="cpu")
    tl.load_jax_params(tm, flat_params(jm))
    return JDmxModel.from_raw(jm), DmxModel.from_raw(tm)


X16 = np.random.default_rng(0).standard_normal((2, 16)).astype(np.float32)
IMAGES = np.random.default_rng(3).standard_normal((2, 1, 28, 28)).astype(np.float32)


def shorthands(config) -> dict:
    """A DmxConfig by shorthand: each format, sparseness and approximation
    by repr, each module type by name."""
    def one(v):
        if isinstance(v, type):
            return v.__name__
        if isinstance(v, dict):
            return {k: one(x) for k, x in v.items()}
        if isinstance(v, (list, tuple)):
            return [one(x) for x in v]
        return repr(v)

    return {n: one(dict(c)) for n, c in config.items()}


def outputs(jdm, tdm, x):
    with torch.no_grad():
        got = tdm(torch.from_numpy(x)).numpy()
    return got, np.asarray(jdm(jnp.asarray(x)))


@pytest.mark.parametrize("frozen_by", ["jax", "port"])
def test_frozen_yaml_thaws_in_the_other_package(tmp_path, frozen_by):
    """LeNetNCHW in BASIC frozen by one package and thawed by the other on a
    fresh model: the module configs equal by shorthand, the outputs at the
    BASIC legs' tolerance."""
    jdm, tdm = nchw_pair()
    src, dst = (jdm, tdm) if frozen_by == "jax" else (tdm, jdm)
    src.to_basic_mode()
    f = str(tmp_path / "frozen.yaml")
    src.freeze(f)
    dst.thaw(f)
    assert shorthands(JDmxConfig.from_model(jdm.module, freeze=True)) == shorthands(
        DmxConfig.from_model(tdm, freeze=True))
    assert shorthands(jdm.dmx_config) == shorthands(tdm.dmx_config)
    got, want = outputs(jdm, tdm, X16)
    np.testing.assert_allclose(got, want, rtol=0, atol=MODE_TOL)


def test_example_yaml_thaws_as_in_jax():
    """configs/dmx_example_config_lenet5.yaml (the legacy singular keys)
    onto LeNet-5 in both packages (JAX tests/test_models.py:349)."""
    jdm, tdm = lenet_pair()
    jdm.configure(JDmxConfig.from_yaml(LENET_YAML))
    tdm.thaw(LENET_YAML)
    assert repr(tdm.get_submodule("fc1").weight_format) == "BFP[8|8]{64}(SN)"
    assert shorthands(jdm.dmx_config) == shorthands(tdm.dmx_config)
    got, want = outputs(jdm, tdm, IMAGES)
    np.testing.assert_allclose(got, want, rtol=0, atol=MODE_TOL)
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))


def test_rules_name_and_configure_a_config_as_jax_s():
    """DmxConfigRule.names_in and apply_to over a DmxConfig."""
    jdm, tdm = lenet_pair()
    jrule = JDmxConfigRule(module_types=(jnn.Linear, jnn.Conv2d), name_re=r"(fc[12]|conv2)",
                           module_config=dict(weight_format=jdmx.format.BFP16_64))
    trule = DmxConfigRule(module_types=(tnn.Linear, tnn.Conv2d), name_re=r"(fc[12]|conv2)",
                          module_config=dict(weight_format=tdmx.format.BFP16_64))
    assert trule.names_in(tdm) == jrule.names_in(jdm.module) == ["conv2", "fc1", "fc2"]
    jc, tc = JDmxConfig.from_model(jdm.module), DmxConfig.from_model(tdm)
    jrule.apply_to(jc)
    trule.apply_to(tc)
    assert shorthands(tc) == shorthands(jc)
    assert trule.names_in(tc) == jrule.names_in(jc)
    tdm.configure(tc)
    assert repr(tdm.get_submodule("fc2").weight_format) == "BFP[8|8]{64}(SN)"
    assert repr(tdm.get_submodule("fc3").weight_format) == "SAME"
    assert tdmx.DmxTransformation is DmxConfigRule


def test_configuration_queue_replays(tmp_path):
    """configure (a file, a DmxConfig, rules; ``transform`` its alias)
    queues; replay_configuration re-applies in order; get_submodule, op_set
    as JAX's."""
    jdm, tdm = lenet_pair()
    assert tdm.op_set == jdm.op_set
    tdm.transform(LENET_YAML)
    tdm.configure(None, *tdmx.config_rules.BASELINE)
    assert len(tdm._dmx_configuration_queue) == 2
    assert repr(tdm.get_submodule("fc1").weight_format) == "SAME"
    tdm.get_submodule("fc1").configure(dict(weight_format="BFP[4|8]{16}(SN)"))
    tdm.replay_configuration()
    assert repr(tdm.get_submodule("fc1").weight_format) == "SAME"
    assert repr(tdm.get_submodule("conv1").output_formats["output_cast"]) == "SAME"
    f = str(tmp_path / "lenet.yaml")
    tdm.configure({"fc1": dict(weight_format="BFP[8|8]{64}(SN)")})
    tdm.freeze(f)
    assert repr(DmxConfig.from_yaml(f)["fc1"]["weight_format"]) == "BFP[8|8]{64}(SN)"
    assert set(DmxConfig.from_yaml(f).module_names) == set(tdm.dmx_module_dict)


def test_compiled_equals_eager_and_writes_no_diagnostic_state():
    """``compiled()`` over LeNet-5 in BASIC: the output equals eager's; the
    compiled forward writes no diagnostic state (each cast's physical dtype,
    an approximation's error stay the eager forward's); one callable per
    target until the next configure.  On the CPU through Dynamo's eager
    backend: its capture, run eagerly (Inductor's CPU code for the off-block
    BFP casts is another matter: ROADMAP "Not faults")."""
    _, tdm = lenet_pair()
    tdm.to_basic_mode()
    x = torch.from_numpy(IMAGES)
    with torch.no_grad():
        want = tdm(x)
    cast = tdm.get_submodule("fc1").input_casts["input_cast"]
    relu = tdm.get_submodule("relu1")
    assert cast.physical_dtype == torch.float32
    cast.physical_dtype, relu.approximation_error = torch.float16, "eager"
    fn = tdm.compiled(backend="eager")
    assert tdm.compiled(backend="eager") is fn
    with torch.no_grad():
        got = fn(x)
    assert torch.equal(got, want)
    assert cast.physical_dtype == torch.float16 and relu.approximation_error == "eager"
    tdm.configure(None, *tdmx.config_rules.BASELINE)
    assert tdm.compiled(backend="eager") is not fn
    assert kernels.LAUNCHES == {k: 0 for k in kernels.LAUNCHES}  # the CPU launches nothing


def test_pipeline_preprocesses_runs_and_postprocesses(tmp_path):
    _, tdm = nchw_pair()
    pipe = DmxSimplePipeline(torch.from_numpy, tdm, lambda y: y.argmax(-1))
    assert Model is DmxSimplePipeline
    assert pipe.configure(None, *tdmx.config_rules.BASIC) is pipe
    with torch.no_grad():
        assert torch.equal(pipe(X16), tdm(torch.from_numpy(X16)).argmax(-1))
    f = str(tmp_path / "p.yaml")
    pipe.freeze(f)
    _, other = nchw_pair()
    assert DmxSimplePipeline(model=other).thaw(f).model is other
    assert shorthands(other.dmx_config) == shorthands(tdm.dmx_config)


def test_a_t2_launch_is_one_operator_of_a_compiled_graph(monkeypatch):
    """Under torch.compile a T2 launch is the operator
    ``dmx_compressor_tpu_torch::bfp_cast`` inside the graph, not a graph
    break: the card's casts traced as if the CPU tensors were on the card
    (the launch itself stubbed), one graph, no break, a launch a cast."""
    from dmx_compressor_tpu_torch.numerics.cast import CastTo

    launched = []
    monkeypatch.setattr(kernels, "plain_or_kernel", lambda t: True)
    monkeypatch.setattr(kernels, "check_cuda", lambda *a, **k: None)
    monkeypatch.setattr(kernels, "launch", lambda name, *a, **k: launched.append(name))
    casts = torch.nn.Sequential(CastTo("BFP[8|8]{64}(SN)"), CastTo("FP[1|5|10,15](FN)"))
    with torch.no_grad():
        ex = torch._dynamo.explain(casts)(torch.randn(4, 128))
    assert (ex.graph_count, ex.graph_break_count) == (1, 0)
    ops = [n.target for g in ex.graphs for n in g.graph.nodes if n.op == "call_function"]
    assert ops.count(torch.ops.dmx_compressor_tpu_torch.bfp_cast.default) == 2
    assert launched == ["bfp_cast", "bfp_cast"]
