"""The port's export path against the JAX package's, on the CPU.

``Format.bfp_id`` (numerics/onnx_ids.py), the Q/DQ compiler graphs
(transform/qdq.py: print_tabular text, evaluation, the compound SDPA's
graph), the legacy flat-graph transformers (transform/legacy.py), the dot
text (transform/visualize.py), the ONNX bytes (transform/onnx_export.py)
and the program export's buckets, each against the JAX package on the same
numpy-seeded inputs and carried-over weights.  Mirrors tests/test_qdq.py,
tests/test_onnx_golden.py and tests/test_format.py::test_bfp_ids.

Bars: bytes, text, ids and bucket keys identical to JAX's; a graph's
evaluation against JAX's at 1e-5 (f32 summation order), against its own
module at JAX's 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

import dmx_compressor_tpu as jdmx
from dmx_compressor_tpu import nn as jnn
from dmx_compressor_tpu.modeling.model import DmxModel as JDmxModel
from dmx_compressor_tpu.models.opt import OPTConfig as JOPTConfig
from dmx_compressor_tpu.models.opt import OPTForCausalLM as JOPT
from dmx_compressor_tpu.transform import legacy as jlegacy
from dmx_compressor_tpu.transform import onnx_export as jonnx
from dmx_compressor_tpu.transform import qdq as jqdq
from dmx_compressor_tpu.transform import visualize as jvis

import dmx_compressor_tpu_torch as tdmx
from dmx_compressor_tpu_torch import kernels
from dmx_compressor_tpu_torch import nn as tnn
from dmx_compressor_tpu_torch.modeling.model import DmxModel
from dmx_compressor_tpu_torch.models.opt import OPTConfig, OPTForCausalLM, load_jax_params
from dmx_compressor_tpu_torch.numerics.format import BlockFloatingPoint, Format
from dmx_compressor_tpu_torch.ops import bfp_cast as T2
from dmx_compressor_tpu_torch.transform import legacy, onnx_export, qdq, visualize
from test_onnx_golden import GOLDEN
from test_torch_opt import flat_params

torch.set_num_threads(2)

EVAL_TOL = dict(rtol=1e-5, atol=1e-5)  # port vs JAX: f32 summation order
MODULE_TOL = dict(rtol=1e-6, atol=1e-6)  # graph vs its own module (tests/test_qdq.py)
BASIC_LINEAR = dict(input_formats=["BFP[8|8]{64}(SN)"], weight_format="BFP[8|8]{64}(SN)",
                    bias_format="BFP[24|8]{1}(SN)", output_formats=["FP[1|5|10,15](FN)"])


def randn(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def carry(jmods, tmods):
    """The JAX modules' weights and biases into the port's, by name."""
    for name, jm in jmods.items():
        for attr in ("weight", "bias"):
            jp = getattr(jm, attr, None)
            if jp is not None:
                with torch.no_grad():
                    getattr(tmods[name], attr).copy_(torch.from_numpy(np.asarray(jp.value)))


def linear_pair(configure):
    jm, tm = jnn.Linear(64, 16), tnn.Linear(64, 16, device="cpu")
    carry({"m": jm}, {"m": tm})
    if configure:
        jm.configure(BASIC_LINEAR)
        tm.configure(BASIC_LINEAR)
    return jm, tm


def sdpa_pair():
    out = []
    for pkg in (jnn, tnn):
        sdpa = pkg.ScaledDotProductAttention()
        sdpa.actmatmul.configure(dict(input_formats=["BFP[8|8]{64}(SN)"] * 2,
                                      output_formats=["FP[1|5|10,15](FN)"]))
        sdpa.resadd.configure(dict(input_formats=["FP[1|5|10,15](FN)"] * 2,
                                   output_formats=["FP[1|5|10,15](FN)"]))
        sdpa.softmax.configure(dict(input_formats=["FP[1|5|10,15](FN)"],
                                    output_formats=["FP[1|5|10,15](FN)"]))
        out.append(sdpa)
    return out


def sdpa_inputs():
    B, H, T, S, D = 1, 2, 8, 8, 64
    mask = np.zeros((T, S), np.float32)
    mask[:, -2:] = -1e4
    return [randn(1, B, H, T, D), randn(2, B, H, S, D), randn(3, B, H, S, D), mask]


def graph_text(g):
    """A graph's nodes as plain text (targets by name), for package-to-package
    comparison."""
    rows = []
    for n in g.nodes:
        rows.append((n.op, n.name, getattr(n.target, "__name__", str(n.target)),
                     tuple(a.name if hasattr(a, "op") else a for a in n.args),
                     n.cast_name, n.cast_format))
    return rows


# ------------------------------------------------------------------ bfp_id


PRESETS = sorted(n for n in vars(jdmx.format) if not n.startswith("_"))


@pytest.mark.parametrize("name", PRESETS)
def test_bfp_id_of_every_preset_is_jax_s(name):
    jf, tf = getattr(jdmx.format, name), getattr(tdmx.format, name)
    assert repr(tf) == repr(jf)
    try:
        want = jf.bfp_id
    except KeyError:
        with pytest.raises(KeyError):
            tf.bfp_id
        return
    assert tf.bfp_id == want


def test_bfp_ids():
    assert Format.from_shorthand("BFP[8|8]{64}(SN)").bfp_id == 10006
    assert Format.from_shorthand("BFP[24|8]{1}(SN)").bfp_id == 10001
    assert Format.from_shorthand("SBFP<XP[4,0](CSN)><FP[0|4|4,7](FN)>{16}").bfp_id == 10044
    assert Format.from_shorthand("FP[1|5|10,15](FN)").bfp_id is None
    with pytest.raises(KeyError):
        Format.from_shorthand("BFP[8|8]{48}(SN)").bfp_id


# ------------------------------------------------------------------ graphs


@pytest.mark.parametrize("configure", [False, True])
def test_linear_graph_matches_jax_and_module(configure):
    jm, tm = linear_pair(configure)
    jg, tg = jm.to_compiler_graph(), tm.to_compiler_graph()
    assert tg.print_tabular() == jg.print_tabular()
    x = randn(4, 2, 64)
    want = np.asarray(jqdq.evaluate_graph(jg, jm, jnp.asarray(x)))
    with torch.no_grad():
        got = qdq.evaluate_graph(tg, tm, torch.from_numpy(x))
        np.testing.assert_allclose(got.numpy(), want, **EVAL_TOL)
        np.testing.assert_allclose(got.numpy(), tm(torch.from_numpy(x)).numpy(), **MODULE_TOL)


@pytest.mark.parametrize("kind", ["resadd", "softmax"])
def test_elementwise_graphs_match_jax_and_module(kind):
    if kind == "resadd":
        jm, tm = jnn.ResAdd(), tnn.ResAdd()
        cfg = dict(input_formats=["FP[1|5|10,15](FN)"] * 2)
        xs = [randn(5, 4, 8), randn(6, 4, 8)]
    else:
        jm, tm = jnn.Softmax(dim=-1), tnn.Softmax(dim=-1)
        cfg = dict(input_formats=["FP[1|5|10,15](FN)"], output_formats=["FP[1|5|10,15](FN)"])
        xs = [randn(7, 4, 16)]
    jm.configure(cfg)
    tm.configure(cfg)
    jg, tg = jm.to_compiler_graph(), tm.to_compiler_graph()
    assert tg.print_tabular() == jg.print_tabular()
    want = np.asarray(jqdq.evaluate_graph(jg, jm, *map(jnp.asarray, xs)))
    with torch.no_grad():
        got = qdq.evaluate_graph(tg, tm, *map(torch.from_numpy, xs))
        np.testing.assert_allclose(got.numpy(), want, **EVAL_TOL)
        np.testing.assert_allclose(got.numpy(), tm(*map(torch.from_numpy, xs)).numpy(),
                                   **MODULE_TOL)


def test_sdpa_graph_matches_jax_and_module():
    jm, tm = sdpa_pair()
    jg, tg = jqdq.module_compiler_graph(jm), qdq.module_compiler_graph(tm)
    assert tg.print_tabular() == jg.print_tabular()
    assert visualize.graph_to_dot(tg) == jvis.graph_to_dot(jg)
    q, k, v, mask = sdpa_inputs()
    want = np.asarray(jqdq.evaluate_graph(jg, jm, *map(jnp.asarray, (q, k, v, mask)), 0.125))
    with torch.no_grad():
        tq, tk, tv, tmask = map(torch.from_numpy, (q, k, v, mask))
        got = qdq.evaluate_graph(tg, tm, tq, tk, tv, tmask, 0.125).numpy()
        eager = tm(tq, tk, tv, attn_mask=tmask, scale=0.125).numpy()
    np.testing.assert_allclose(got, want, **EVAL_TOL)
    np.testing.assert_allclose(got, eager, **MODULE_TOL)
    qnodes = [n for n in tg.nodes if n.target == "dmx.quantize"]
    assert {"input_casts.query_states_cast", "actmatmul.input_casts.multiplier_cast",
            "resadd.input_casts.residual_cast",
            "softmax.output_casts.output_cast"} <= {n.cast_name for n in qnodes}


def test_graph_has_qdq_annotations():
    mod = tnn.Linear(64, 16, device="cpu")
    mod.configure(dict(weight_format=tdmx.format.BFP16_64))
    g = mod.to_compiler_graph()
    assert any(n.cast_format == "BFP[8|8]{64}(SN)" for n in g.nodes
               if n.target == "dmx.quantize")
    text = g.print_tabular()
    assert "quantize" in text and "dequantize" in text


def opt_pair(basic=True):
    jm = JOPT(JOPTConfig.tiny(), rngs=nnx.Rngs(0))
    tm = OPTForCausalLM(OPTConfig.tiny(), device="cpu")
    load_jax_params(tm, flat_params(jm))
    jdm, tdm = JDmxModel.from_raw(jm), DmxModel.from_raw(tm)
    if basic:
        jdm.to_basic_mode()
        tdm.to_basic_mode()
    return jdm, tdm


@pytest.fixture(scope="module")
def opt():
    return opt_pair()


def test_opt_graphs_text_and_dot_are_jax_s(opt, tmp_path):
    jdm, tdm = opt
    jg, tg = jdm.make_compiler_graphs(), tdm.make_compiler_graphs()
    assert tg.skipped == {} == jg.skipped
    assert list(tg) == list(jg)
    assert any(n.endswith("sdpa") for n in tg)
    for name in tg:
        assert graph_text(tg[name]) == graph_text(jg[name]), name
        assert tg[name].print_tabular() == jg[name].print_tabular(), name
    dots = tdm.visualize_graph(str(tmp_path / "t.dot"))
    assert dots == jdm.visualize_graph(str(tmp_path / "j.dot"))
    assert (tmp_path / "t.dot").read_text() == (tmp_path / "j.dot").read_text()


def test_opt_graphs_evaluate_as_the_modules(opt):
    """Each module's graph on the inputs its module saw in a BASIC forward,
    against the module's output: bit for bit where the graph computes with
    the module's ops (the surrogates of Softmax and LayerNorm are not the
    graph's exact ops: held at the surrogate's gap)."""
    _, tdm = opt
    ids = torch.from_numpy(np.random.default_rng(1).integers(0, 256, (2, 16)))
    graphs = tdm.make_compiler_graphs()
    mods = dict(tdm.named_dmx_modules())
    calls = {n: [] for n in graphs}
    hooks = [mods[n].register_forward_hook(
        lambda m, a, kw, out, n=n: calls[n].append((a, kw, out)), with_kwargs=True)
        for n in graphs]
    tnn.DmxModule.monitors += 1  # the modular path
    try:
        with torch.no_grad():
            tdm(ids)
    finally:
        tnn.DmxModule.monitors -= 1
        for h in hooks:
            h.remove()
    exact = 0
    with torch.no_grad():
        for name, g in graphs.items():
            for args, kw, out in calls[name]:
                if name.endswith("sdpa"):
                    args = (*args, kw["attn_mask"], kw["scale"])
                got = qdq.evaluate_graph(g, mods[name], *args)
                if isinstance(mods[name], (tnn.LayerNorm, tnn.Softmax)) or name.endswith("sdpa"):
                    np.testing.assert_allclose(got.numpy(), out.numpy(), atol=2e-2)
                else:
                    assert torch.equal(got, out), name
                    exact += 1
    assert exact > 20


def test_strict_raises_and_skip_recorded():
    class Odd(tnn.DmxModule):
        def _forward(self, _input):
            return _input

    class Holder(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.odd = Odd()

    graphs = qdq.make_compiler_graph(Holder())
    assert isinstance(graphs, qdq.CompilerGraphs) and "odd" in graphs.skipped
    with pytest.raises(NotImplementedError):
        qdq.make_compiler_graph(Holder(), strict=True)


# ------------------------------------------------------------------ legacy


def flat_graphs():
    def build(mod, matmul):
        g = mod.DmxGraph()
        x = g.placeholder("x")
        w = g.get_attr("weight")
        g.output(g.call_function(matmul, (x, w), name="matmul"))
        return g

    return build(jqdq, jnp.matmul), build(qdq, torch.matmul)


def test_cast_input_output_transform_and_node_dict_are_jax_s():
    jg, tg = flat_graphs()
    kw = dict(input_format="BFP[8|8]{64}(SN)", output_format="FP[1|5|10,15](FN)",
              weight_format="BFP[8|8]{64}(SN)")
    jlegacy.cast_input_output_transform(jg, **kw)
    legacy.cast_input_output_transform(tg, **kw)
    assert graph_text(tg) == graph_text(jg)
    nd = legacy.node_dict(tg)
    assert list(nd) == list(jlegacy.node_dict(jg))
    assert all(getattr(a, "target", None) == "dmx.dequantize" for a in nd["matmul"].args)
    out = next(n for n in tg.nodes if n.op == "output")
    assert out.args[0].cast_format == "FP[1|5|10,15](FN)"


def test_configure_graph_is_jax_s():
    jg, tg = flat_graphs()
    jlegacy.cast_input_output_transform(jg, input_format="BFP[8|8]{64}(SN)")
    legacy.cast_input_output_transform(tg, input_format="BFP[8|8]{64}(SN)")
    cfg = {r"io\.input_casts\.x": "BFP[4|8]{64}(SN)"}
    assert legacy.configure_graph(tg, cfg) == jlegacy.configure_graph(jg, cfg) == 2
    assert graph_text(tg) == graph_text(jg)


def test_stitch_and_fold_are_jax_s():
    """l1 (a BASIC Linear with a FLOAT16 output) then a Softmax with a
    FLOAT16 input: one redundant pair; the folded graph evaluates the same,
    and the node lists are JAX's before and after."""
    fp16 = "FP[1|5|10,15](FN)"
    pairs = []
    for pkg, lin in ((jnn, lambda: jnn.Linear(16, 16, rngs=nnx.Rngs(0))),
                     (tnn, lambda: tnn.Linear(16, 16, device="cpu"))):
        l1, sm = lin(), pkg.Softmax()
        l1.configure(dict(input_formats=["BFP[8|8]{16}(SN)"], weight_format="BFP[8|8]{16}(SN)",
                          output_formats=[fp16]))
        sm.configure(dict(input_formats=[fp16], output_formats=[fp16]))
        pairs.append((l1, sm))
    (jl1, jsm), (tl1, tsm) = pairs
    carry({"l1": jl1}, {"l1": tl1})
    jg = jlegacy.stitch_graphs(jqdq.module_compiler_graph(jl1), jqdq.module_compiler_graph(jsm),
                               prefixes=("l1", "sm"))
    tg = legacy.stitch_graphs(qdq.module_compiler_graph(tl1), qdq.module_compiler_graph(tsm),
                              prefixes=("l1", "sm"))
    assert graph_text(tg) == graph_text(jg)
    both = torch.nn.Module()
    both.l1, both.sm = tl1, tsm
    x = torch.from_numpy(randn(8, 4, 16))
    with torch.no_grad():
        before = qdq.evaluate_graph(tg, both, x)
        assert torch.allclose(before, tsm(tl1(x)), **MODULE_TOL)
        assert legacy.fold_redundant_qdq(tg) == jlegacy.fold_redundant_qdq(jg) == 1
        assert graph_text(tg) == graph_text(jg)
        assert torch.equal(qdq.evaluate_graph(tg, both, x), before)


def test_fixed_point_pairs_not_folded():
    g = qdq.DmxGraph()
    a = g.qdq(g.placeholder("x"), "c1", "XP[8,0](CSN)")
    g.output(g.qdq(a, "c2", "XP[8,0](CSN)"))
    assert legacy.fold_redundant_qdq(g) == 0


# -------------------------------------------------------------------- ONNX


def test_onnx_codec_reproduces_and_parses_the_golden_bytes():
    node = onnx_export._node("Identity", ["x"], ["y"], "n0",
                             attrs=(onnx_export._attribute("bfp_type", i=52),))
    graph = onnx_export._graph(nodes=[node], name="g", inputs=[onnx_export._value_info("x")],
                               outputs=[onnx_export._value_info("y")],
                               initializers=[onnx_export._tensor(
                                   "w", np.asarray([1.0, 2.0], np.float32))])
    assert onnx_export._model(graph) == GOLDEN
    m = onnx_export.parse_onnx(GOLDEN)
    assert m["opsets"] == [("", 17), ("com.microsoft", 1), ("dmx", 1)]
    assert m["inputs"] == ["x"] and m["outputs"] == ["y"] and m["initializers"] == ["w"]
    (node,) = m["nodes"]
    assert (node["op_type"], node["name"], node["attrs"]) == ("Identity", "n0", {"bfp_type": 52})


def test_basic_linear_onnx_bytes_are_jax_s(tmp_path):
    jm, tm = linear_pair(True)
    want = jonnx.dmx_graph_to_onnx(jm.to_compiler_graph(), jm, "linear")
    data = onnx_export.dmx_graph_to_onnx(tm.to_compiler_graph(), tm, "linear")
    assert data == want
    m = onnx_export.parse_onnx(data)
    q = [n for n in m["nodes"] if n["op_type"] == "QuantizeBFP"]
    assert sorted(n["attrs"]["bfp_type"] for n in q) == sorted(
        [tdmx.format.BFP16_64.bfp_id] * 2 + [tdmx.format.BFP32_1.bfp_id])
    assert ("com.microsoft", 1) in m["opsets"]


def test_net_onnx_bytes_are_jax_s(tmp_path):
    """fc1 -> LayerNorm -> gelu -> head in BASIC (tests/test_onnx_golden.py's
    model), exported per module by both packages."""

    class JNet(nnx.Module):
        def __init__(self):
            rngs = nnx.Rngs(0)
            self.fc1 = nnx.Linear(32, 16, rngs=rngs)
            self.ln = nnx.LayerNorm(16, rngs=rngs)
            self.head = nnx.Linear(16, 8, rngs=rngs)

        def __call__(self, x):
            return self.head(jax.nn.gelu(self.ln(self.fc1(x))))

    class TNet(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.fc1 = torch.nn.Linear(32, 16)
            self.ln = torch.nn.LayerNorm(16)
            self.head = torch.nn.Linear(16, 8)

        def forward(self, x):
            return self.head(torch.nn.functional.gelu(self.ln(self.fc1(x))))

    jdm, tdm = JDmxModel.from_raw(JNet()), DmxModel.from_raw(TNet())
    jdm.to_basic_mode()
    tdm.to_basic_mode()
    carry(dict(jdm.named_dmx_modules()), dict(tdm.named_dmx_modules()))
    want = jonnx.export_onnx(jdm.module)
    got = onnx_export.export_onnx(tdm.module, path=str(tmp_path))
    assert list(got) == list(want) == ["fc1", "ln", "head"]
    for name in got:
        assert got[name] == want[name], name
        assert (tmp_path / f"{name}.onnx").read_bytes() == got[name]
        assert onnx_export.parse_onnx(got[name])["nodes"]


def test_opt_onnx_bytes_are_jax_s(opt):
    jdm, tdm = opt
    want = jonnx.export_onnx(jdm.module)
    got = onnx_export.export_onnx(tdm.module)
    assert list(got) == list(want)
    for name in got:
        assert got[name] == want[name], name
    graphs = tdm.make_compiler_graphs()
    n_bfp = sum(n.target == "dmx.dequantize" and isinstance(
        Format.from_shorthand(n.cast_format), BlockFloatingPoint)
        for g in graphs.values() for n in g.nodes)
    n_q = sum(n["op_type"] == "QuantizeBFP" for d in got.values()
              for n in onnx_export.parse_onnx(d)["nodes"])
    assert n_q == n_bfp > 0


# --------------------------------------------------------- program export


def test_export_program_holds_the_matmul():
    mod = tnn.Linear(64, 16, device="cpu")
    mod.configure(dict(input_formats=[tdmx.format.BFP16_64], weight_format=tdmx.format.BFP16_64))
    text = qdq.export_program(mod, torch.ones(2, 64))
    assert "aten.matmul" in text
    assert 'f32[2, 64]' in text


def test_export_program_holds_t2_as_an_operator(monkeypatch):
    """What a trace on the card sees: the casts' launches go through the
    operator dmx_compressor_tpu_torch::bfp_cast, never ctypes on a fake
    tensor (here the CPU is told to take the kernel path; the trace never
    runs the operator)."""
    monkeypatch.setattr(kernels, "plain_or_kernel", lambda t: True)
    launched = []
    monkeypatch.setattr(T2, "_launch_now", lambda *a: launched.append(a))
    mod = tnn.Linear(64, 16, device="cpu")
    mod.configure(dict(input_formats=[tdmx.format.BFP16_64], weight_format=tdmx.format.BFP16_64,
                       output_formats=[tdmx.format.FLOAT16]))
    text = qdq.export_program(mod, torch.ones(2, 64))
    assert text.count("torch.ops.dmx_compressor_tpu_torch.bfp_cast") == 3
    assert launched == []


def test_export_program_bucketed_keys_and_dispatch_are_jax_s():
    jm, tm = linear_pair(True)
    graphdef, state = nnx.split(jm)
    jprog, jdispatch = jqdq.export_stablehlo_bucketed(
        lambda s, x: nnx.merge(graphdef, s)(x), (state, jnp.ones((2, 64))),
        axis_buckets={1: (0, [2, 4, 8])})
    tprog, tdispatch = qdq.export_program_bucketed(
        lambda w, x: torch.nn.functional.linear(x, w), (tm.weight.detach(), torch.ones(2, 64)),
        axis_buckets={1: (0, [2, 4, 8])})
    assert list(tprog) == list(jprog) == ["a1x0=2", "a1x0=4", "a1x0=8"]
    assert "f32[8, 64]" in tprog["a1x0=8"] and "f32[8, 64]" not in tprog["a1x0=2"]
    for n in (1, 3, 8):
        args = (tm.weight, torch.ones(n, 64))
        assert tdispatch(args) == jdispatch((state, jnp.ones((n, 64))))
    with pytest.raises(ValueError, match="exceeds the largest bucket"):
        tdispatch((tm.weight, torch.ones(9, 64)))
    # a bucket below the example size cuts the argument
    tprog, _ = qdq.export_program_bucketed(torch.sin, (torch.ones(6, 3),),
                                           axis_buckets={0: (-2, [4])})
    assert list(tprog) == ["a0x-2=4"] and "f32[4, 3]" in tprog["a0x-2=4"]
