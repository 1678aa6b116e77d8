"""The port's utils (io, tracing, monitor, benchmark) against the JAX
package's, on the CPU.

Configs dump to the same bytes in both packages and load into each one's
types; ``Monitoring`` and ``RuntimeMeasurement`` record the JAX package's
module names with its call counts; the benchmark harness prints tables with
the JAX package's rows and columns, its error entries at a stated
tolerance.  The models are small: tests/test_benchmark_harness.py's Net and
tests/test_transform.py's LeNetNCHW (weights carried from JAX), LeNet-5.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from dmx_compressor_tpu import rawnn as jrawnn
from dmx_compressor_tpu.utils import benchmark as jbench
from dmx_compressor_tpu.utils import io as jio
from dmx_compressor_tpu.utils.monitor import Monitoring as JMonitoring
from dmx_compressor_tpu.utils.monitor import RuntimeMeasurement as JRuntimeMeasurement

from dmx_compressor_tpu_torch import nn as tnn
from dmx_compressor_tpu_torch import rawnn
from dmx_compressor_tpu_torch.modeling.model import DmxConfig, DmxModel
from dmx_compressor_tpu_torch.nn.core import DmxModule
from dmx_compressor_tpu_torch.numerics.format import Format
from dmx_compressor_tpu_torch.utils import benchmark as tbench
from dmx_compressor_tpu_torch.utils import io as tio
from dmx_compressor_tpu_torch.utils.monitor import Monitoring, RuntimeMeasurement
from test_torch_modeling import lenet_pair, nchw_pair
from test_torch_opt import flat_params

torch.set_num_threads(2)

# outputs and per-layer errors in BASIC, port vs JAX: a BFP or FLOAT16 cast
# may land one step apart (tests/test_torch_lenet.py's MODE_TOL); the f32
# modes differ in summation order only
MODE_TOL = 4e-3
F32_TOL = 1e-5
X = np.random.default_rng(0).standard_normal((4, 16)).astype(np.float32)
IMAGES = np.random.default_rng(3).standard_normal((2, 1, 28, 28)).astype(np.float32)
MODES = list(tbench.EVALUATION_MODE)


class JNet(nnx.Module):
    """tests/test_benchmark_harness.py's Net."""

    def __init__(self):
        rngs = nnx.Rngs(0)
        self.l1 = nnx.Linear(16, 32, rngs=rngs)
        self.softmax = jrawnn.Softmax()
        self.l2 = nnx.Linear(32, 8, rngs=rngs)

    def __call__(self, x):
        return self.l2(self.softmax(self.l1(x)))


class Net(torch.nn.Module):
    """The same in the port, the JAX Net's weights."""

    def __init__(self):
        super().__init__()
        params = flat_params(JNet())
        self.l1 = torch.nn.Linear(16, 32)
        self.softmax = rawnn.Softmax()
        self.l2 = torch.nn.Linear(32, 8)
        with torch.no_grad():
            for n in ("l1", "l2"):
                getattr(self, n).weight.copy_(torch.from_numpy(params[f"{n}.kernel"].T))
                getattr(self, n).bias.copy_(torch.from_numpy(params[f"{n}.bias"]))

    def forward(self, x):
        return self.l2(self.softmax(self.l1(x)))


def j_maker():
    def runner(m):
        return m(jnp.asarray(X))

    def evaluator(m, desc):
        return {"mean_abs": float(jnp.mean(jnp.abs(runner(m))))}

    return JNet(), runner, evaluator


def t_maker():
    def runner(m):
        with torch.no_grad():
            return m(torch.from_numpy(X))

    def evaluator(m, desc):
        return {"mean_abs": float(torch.mean(torch.abs(runner(m))))}

    return Net(), runner, evaluator


# ----------------------------------------------------------------------- io


def test_kwargs_strings_as_jax_s():
    s = "a=1, b=2.5, c=hello, d=True"
    assert tio.string_to_kwargs(s) == jio.string_to_kwargs(s) == {
        "a": 1, "b": 2.5, "c": "hello", "d": True}
    assert tio.kwargs_to_string(a=1, b="x") == jio.kwargs_to_string(a=1, b="x")


@pytest.mark.parametrize("model", ["lenet_nchw", "lenet5"])
def test_dump_is_jax_s_byte_for_byte(tmp_path, model):
    """The same BASIC configuration, frozen by each package: the same bytes;
    each package's loader reads the other's file into its own types."""
    jdm, tdm = nchw_pair() if model == "lenet_nchw" else lenet_pair()
    jdm.to_basic_mode()
    tdm.to_basic_mode()
    jf, tf = tmp_path / "j.yaml", tmp_path / "t.yaml"
    jdm.freeze(str(jf))
    tdm.freeze(str(tf))
    assert tf.read_bytes() == jf.read_bytes()
    assert "!DmxModule" in tf.read_text() and "!Format" in tf.read_text()
    cfg = DmxConfig.from_model(tdm, freeze=True)
    assert tio.dump_config_str({k: dict(v) for k, v in cfg.items()}) == tf.read_text()
    loaded = tio.load_config_file(str(jf))
    some = next(iter(loaded.values()))
    assert some["instance_of"] is getattr(tnn, some["instance_of"].__name__)
    assert isinstance(some["input_formats"]["input_cast"], Format)
    assert DmxConfig(loaded).module_names == DmxConfig.from_model(tdm).module_names


# ------------------------------------------------------------------ monitor


def _records(mon):
    return {k: (len(v.inputs), len(v.outputs), len(v.runtimes)) for k, v in mon.records.items()}


@pytest.mark.parametrize("mode", ["baseline", "basic"])
def test_monitoring_records_as_jax_s(mode):
    """LeNet-5: one forward under Monitoring records JAX's module names,
    each with JAX's number of calls, and each output at the mode's
    tolerance; a subset by name records that subset."""
    jdm, tdm = lenet_pair()
    for dm in (jdm, tdm):
        getattr(dm, f"to_{mode}_mode")()
    with JMonitoring(jdm) as jmon:
        jdm(jnp.asarray(IMAGES))
    with tdm.monitoring() as tmon, torch.no_grad():
        tdm(torch.from_numpy(IMAGES))
    assert isinstance(tmon, Monitoring) and DmxModule.monitors == 0
    assert _records(tmon) == _records(jmon)
    tol = F32_TOL if mode == "baseline" else MODE_TOL
    for name, rec in tmon.records.items():
        want = np.asarray(jmon.records[name].outputs[0])
        if want.shape != tuple(rec.outputs[0].shape):  # the JAX LeNet-5's convs: NHWC
            want = want.transpose(0, 3, 1, 2)
        np.testing.assert_allclose(rec.outputs[0].numpy(), want, rtol=0, atol=tol, err_msg=name)
        assert len(rec.inputs[0]) == len(jmon.records[name].inputs[0])
    with tdm.monitoring(["fc1", "mp2"]) as sub, torch.no_grad():
        tdm(torch.from_numpy(IMAGES))
        tdm(torch.from_numpy(IMAGES))
    assert _records(sub) == {"fc1": (2, 2, 0), "mp2": (2, 2, 0)}


def test_runtime_measurement_records_as_jax_s():
    jdm, tdm = lenet_pair()
    jdm.to_basic_mode()
    tdm.to_basic_mode()
    with JRuntimeMeasurement(jdm) as jrt:
        jdm(jnp.asarray(IMAGES))
    with tdm.measure_runtimes() as trt, torch.no_grad():
        tdm(torch.from_numpy(IMAGES))
    assert isinstance(trt, RuntimeMeasurement)
    got, want = trt.get_records(), jrt.get_records()
    assert {k: len(v) for k, v in got.items()} == {k: len(v) for k, v in want.items()}
    assert all(isinstance(t, float) and t > 0 for v in got.values() for t in v)


def test_monitoring_sends_the_fused_plans_to_the_modular_path():
    """Inside a monitoring context the fused BASIC plans step aside, so every
    monitored module is called, as a wrapped module fails the JAX package's
    plan checks."""
    from dmx_compressor_tpu_torch.models.opt import OPTConfig, OPTForCausalLM
    from dmx_compressor_tpu_torch.ops.basic_layer import basic_head_plan, basic_layer_plan
    from dmx_compressor_tpu_torch.ops.compress import build_basic_mode

    m = OPTForCausalLM(OPTConfig.tiny(), device="cpu")
    build_basic_mode(m)
    layer = m.model.decoder.layers[0]
    assert basic_layer_plan(layer) is not None
    assert basic_head_plan(m.model.decoder.final_layer_norm, m.lm_head) is not None
    dm = DmxModel(m)
    with dm.monitoring():
        assert basic_layer_plan(layer) is None
        assert basic_head_plan(m.model.decoder.final_layer_norm, m.lm_head) is None
    assert basic_layer_plan(layer) is not None


# ---------------------------------------------------------------- benchmark


def test_sync_memory_and_gather_on_the_cpu():
    nested = {"a": torch.ones(2), "b": [torch.zeros(3), (torch.full((1,), 2.0), "x")]}
    assert [t.numel() for t in tbench.gather_tensors(nested)] == [2, 3, 1]
    assert tbench.device_sync(nested) == 2.0
    assert tbench.peak_memory_bytes() is None and tbench.live_memory_bytes() is None
    assert tbench.measure_runtime(lambda: torch.ones(3), reps=2, warmup=1) > 0
    e = tbench.compute_error([torch.ones(2)], [torch.zeros(2)])
    assert e == jbench.compute_error([jnp.ones(2)], [jnp.zeros(2)])


def _table(text: str):
    """A printed markdown table's header and first column."""
    rows = [ln for ln in text.splitlines() if ln.startswith("| ") and not ln.startswith("|---")]
    return rows[0], [r.split(" | ")[0] for r in rows[1:]]


def test_runtime_and_accuracy_tables_as_jax_s(capsys):
    jres = jbench.measure_model_runtime(j_maker, MODES, n_measure_runs=1)
    jtext = capsys.readouterr().out
    tres = tbench.measure_model_runtime(t_maker, MODES, n_measure_runs=1)
    ttext = capsys.readouterr().out
    assert ttext.count("|") == jtext.count("|")
    for jt, tt in zip(jtext.split("###"), ttext.split("###")):
        assert [_table(t) for t in tt.split("\n\n") if "| " in t] == [
            _table(t) for t in jt.split("\n\n") if "| " in t]
    assert {k: set(v) for k, v in tres.items()} == {k: set(v) for k, v in jres.items()}
    for mode in jres:
        assert set(tres[mode]["per_layer_times"]) == set(jres[mode]["per_layer_times"])
        assert tres[mode]["vsimd_modules_by_type"] == jres[mode]["vsimd_modules_by_type"]
    assert tres["Vanilla"]["max_memory"] == 0  # no card: the allocator reports nothing

    jacc = jbench.measure_model_accuracy(j_maker, MODES)
    jtext = capsys.readouterr().out
    tacc = tbench.measure_model_accuracy(t_maker, MODES)
    ttext = capsys.readouterr().out
    assert _table(ttext) == _table(jtext)
    for mode in jacc:
        np.testing.assert_allclose(tacc[mode]["mean_abs"], jacc[mode]["mean_abs"],
                                   rtol=0, atol=MODE_TOL)


def test_error_tables_as_jax_s(capsys):
    modes = [tbench.EVALUATION_MODE.FP8, tbench.EVALUATION_MODE.BASIC]
    jerr = jbench.measure_model_error(j_maker, [jbench.EVALUATION_MODE(m.value) for m in modes])
    jtext = capsys.readouterr().out
    terr = tbench.measure_model_error(t_maker, modes)
    ttext = capsys.readouterr().out
    assert [_table(t) for t in ttext.split("###")[1:]] == [
        _table(t) for t in jtext.split("###")[1:]]
    for mode, rec in jerr.items():
        assert set(terr[mode]["per_layer"]) == set(rec["per_layer"])
        for name, err in [*rec["per_layer"].items(), ("final", rec["final_output"])]:
            got = terr[mode]["per_layer"].get(name, terr[mode]["final_output"])
            np.testing.assert_allclose(got["maxdelta"], err["maxdelta"], rtol=0, atol=MODE_TOL)
            np.testing.assert_allclose(got["mse"], err["mse"], rtol=0, atol=MODE_TOL ** 2)


def test_mode_error_and_markdown_as_benchmark_opt_s():
    """benchmark_opt's flow on LeNetNCHW: each mode configured in turn on
    one DmxModel, outputs against Vanilla's, the tables' rows and columns
    JAX's and the error entries at the mode's tolerance."""
    jdm, tdm = nchw_pair()
    jout = {"Vanilla": np.asarray(jdm(jnp.asarray(X)))}
    with torch.no_grad():
        tout = {"Vanilla": tdm(torch.from_numpy(X))}
    for mode in MODES[1:]:
        jbench.configure_mode(jdm, jbench.EVALUATION_MODE(mode.value))
        tbench.configure_mode(tdm, mode)
        jout[mode.value] = np.asarray(jdm(jnp.asarray(X)))
        with torch.no_grad():
            tout[mode.value] = tdm(torch.from_numpy(X))
    jerr, terr = jbench.mode_output_error(jout), tbench.mode_output_error(tout)
    assert _table(tbench.markdown_table(terr, "e")) == _table(jbench.markdown_table(jerr, "e"))
    for mode in jerr:
        for k, v in jerr[mode].items():
            np.testing.assert_allclose(terr[mode][k], v, rtol=0, atol=MODE_TOL, err_msg=mode)


# ----------------------------------------------------------------- examples


def _write_example_checkpoint(example, path):
    """A local HF checkpoint at the example's tiny config: a port model of
    seed 5, each parameter under its HF name (Whisper's are HF's but for
    its convs' [out, in, 3] layout; CLIP's lose the ``embeddings.`` and
    ``encoder.`` levels, which this puts back), written as safetensors.
    Returns the tensors the example's model must hold (the family's
    ``hf_tensor_converter`` of the written ones)."""
    import json
    import os

    from safetensors.numpy import save_file

    from dmx_compressor_tpu_torch.models.clip import CLIPConfig, CLIPModel
    from dmx_compressor_tpu_torch.models.whisper import (WhisperConfig,
                                                         WhisperForConditionalGeneration)

    if example == "clip":
        model = CLIPModel(CLIPConfig.tiny(), device="cpu", seed=5)
    else:
        model = WhisperForConditionalGeneration(WhisperConfig.tiny(), device="cpu", seed=5)
    tensors = {}
    for name, p in model.named_parameters():
        a = p.detach().numpy().copy()
        if example == "whisper" and name.endswith(("conv1.weight", "conv2.weight")):
            a = a.reshape(a.shape[0], -1, 3)
        if example == "clip":
            if "patch_embedding" in name:
                a = a.reshape(a.shape[0], 3, 8, 8)
            for emb in ("token_embedding", "position_embedding", "class_embedding",
                        "patch_embedding"):
                name = name.replace(f"_model.{emb}", f"_model.embeddings.{emb}")
            name = name.replace("_model.layers.", "_model.encoder.layers.")
        tensors[name] = a
    os.makedirs(path)
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump({"model_type": example}, f)
    save_file(tensors, os.path.join(path, "model.safetensors"))
    return type(model).hf_tensor_converter(tensors)


@pytest.mark.parametrize("example", ["opt", "clip", "whisper"])
def test_benchmarking_example_runs_tiny_on_the_cpu(example, capsys, tmp_path):
    """Each port of examples/benchmarking at its tiny config on the CPU:
    the JAX example's tables, finite.  CLIP's and Whisper's run over a
    local HF checkpoint (``--ckpt DIR``), whose tensors their models hold
    bit for bit; OPT's, as JAX's, takes no ``--ckpt``."""
    import importlib

    mod = importlib.import_module(
        f"dmx_compressor_tpu_torch.examples.benchmarking.benchmark_{example}")
    ckpt = str(tmp_path / "ckpt")
    want = None if example == "opt" else _write_example_checkpoint(example, ckpt)
    out = mod.main(["--device", "cpu"] + ([] if example == "opt" else ["--ckpt", ckpt]))
    text = capsys.readouterr().out
    modes = [m.value for m in (MODES if example == "opt" else mod.MODES)]
    if example == "opt":
        assert "### Per-mode runtime\n| mode | total_runtime_s |" in text
        assert "### Output error vs Vanilla\n| mode | max_abs_err | mean_abs_err | rel_err |" in text
        assert list(out["errors"]) == modes
        assert all(np.isfinite(v) for row in out["errors"].values() for v in row.values())
    else:
        assert "| mode | live memory (GB) | total time (s) |" in text
        assert "| metric | " + " | ".join(modes) + " |" in text
        assert "### VSIMD operations" in text and "### Basic vs Baseline" in text
        assert list(out["runtime"]) == list(out["accuracy"]) == modes
        assert np.isfinite(out["error"]["Basic"]["final_output"]["mse"])
    if example == "opt":
        with pytest.raises(SystemExit):  # argparse: no such flag
            mod.main(["--device", "cpu", "--ckpt", "some/dir"])
        return
    maker = (mod.make_model_maker(False, torch.device("cpu"), ckpt) if example == "clip"
             else mod.make_model_maker(mod.config(False), torch.device("cpu"), ckpt))
    model, _, _ = maker()
    own = dict(model.named_parameters())
    assert set(want) == set(own)
    for k, v in want.items():
        want_k = torch.from_numpy(np.asarray(v)).reshape(own[k].shape)
        assert torch.equal(own[k].detach(), want_k), k
