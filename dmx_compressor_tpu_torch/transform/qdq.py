"""Q/DQ-annotated compiler graphs: the export contract for the hardware stack.

Port of ``dmx_compressor_tpu/transform/qdq.py``.  Each DmxModule's cast
topology becomes a small explicit graph (:class:`DmxGraph`) in which every
tensor edge is wrapped in a ``dmx.quantize`` / ``dmx.dequantize`` pair
carrying the cast's path on the owning module and its format shorthand; the
downstream compiler consumes that flat graph (``transform/onnx_export.py``
serializes it).  :func:`evaluate_graph` interprets a graph against its
module, each Q/DQ pair as the module's own fake-quant cast, so a graph is
held against the module's eager output.

The graphs are the JAX package's node for node: the same node names, the
same targets' ``__name__``s (``linear``, ``res_add``, ``matmul``,
``softmax``, ...; they become ONNX op types), the same ``print_tabular``
text.  The functional targets are torch functions; on CUDA tensors the
casts of an evaluation launch kernel T2 as the module's casts do.

Program export: torch has no StableHLO emitter (that takes ``torch_xla``),
so :func:`export_program` gives the text of the ATen graph of
``torch.export.export`` in place of the JAX package's ``export_stablehlo``,
and :func:`export_program_bucketed` its multi-signature form with the JAX
package's bucket keys, padding rule and dispatch.  On the card a BASIC
cast's T2 launch is the operator ``dmx_compressor_tpu_torch::bfp_cast`` of
that graph.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
from torch import nn


@dataclass
class Node:
    op: str  # placeholder | get_attr | call_function | output
    name: str
    target: Any = None
    args: Tuple = ()
    kwargs: Dict = field(default_factory=dict)
    # Q/DQ annotation: cast path on the owning module + format shorthand
    cast_name: Optional[str] = None
    cast_format: Optional[str] = None


class DmxGraph:
    """Flat op graph where every tensor edge carries Q/DQ annotations."""

    def __init__(self):
        self.nodes: List[Node] = []
        self._counter = 0

    def _name(self, base: str) -> str:
        self._counter += 1
        return f"{base}_{self._counter}"

    def placeholder(self, name: str, cast_name: str = None, cast_format: str = None) -> Node:
        n = Node("placeholder", name, cast_name=cast_name, cast_format=cast_format)
        self.nodes.append(n)
        return self.qdq(n, cast_name, cast_format)

    def get_attr(self, target: str, cast_name: str = None,
                 cast_format: str = None) -> Optional[Node]:
        n = Node("get_attr", self._name(target.replace(".", "_")), target=target)
        self.nodes.append(n)
        if cast_name is not None:
            return self.qdq(n, cast_name, cast_format)
        return n

    def qdq(self, src: Node, cast_name: Optional[str], cast_format: Optional[str]) -> Node:
        """Wrap an edge in quantize -> dequantize."""
        if cast_name is None:
            return src
        q = Node(
            "call_function",
            self._name("quantize"),
            target="dmx.quantize",
            args=(src, f"{cast_name}.scale", f"{cast_name}.zero_point", cast_format),
            cast_name=cast_name,
            cast_format=cast_format,
        )
        dq = Node(
            "call_function",
            self._name("dequantize"),
            target="dmx.dequantize",
            args=(q, f"{cast_name}.scale", f"{cast_name}.zero_point"),
            cast_name=cast_name,
            cast_format=cast_format,
        )
        self.nodes.extend([q, dq])
        return dq

    def call_function(self, target, args, name: str = None,
                      cast_name: str = None, cast_format: str = None, **kwargs) -> Node:
        n = Node(
            "call_function",
            name or self._name(getattr(target, "__name__", str(target))),
            target=target,
            args=tuple(args),
            kwargs=kwargs,
        )
        self.nodes.append(n)
        return self.qdq(n, cast_name, cast_format)

    def output(self, node) -> None:
        self.nodes.append(Node("output", "output", args=(node,)))

    def print_tabular(self) -> str:
        rows = ["opcode         name                 target               args"]
        for n in self.nodes:
            args = tuple(a.name if isinstance(a, Node) else a for a in n.args)
            tgt = getattr(n.target, "__name__", str(n.target))
            rows.append(f"{n.op:<14} {n.name:<20} {tgt:<20} {args}")
        return "\n".join(rows)


def _resolve_attr(module, path: str):
    obj = module
    for part in path.split("."):
        obj = obj[int(part)] if part.isdigit() else getattr(obj, part)
    return obj


def _resolve_cast(module, cast_path: str):
    obj = module
    for part in cast_path.split("."):
        obj = getattr(obj, part)
    return obj


def evaluate_graph(graph: DmxGraph, module, *inputs):
    """Execute a DmxGraph against its owning module: each quantize /
    dequantize pair evaluates as the module's fake-quant cast."""
    env: Dict[str, Any] = {}
    it = iter(inputs)
    out = None
    for n in graph.nodes:
        if n.op == "placeholder":
            env[n.name] = next(it)
        elif n.op == "get_attr":
            env[n.name] = _resolve_attr(module, n.target)
        elif n.op == "call_function":
            args = [env[a.name] if isinstance(a, Node) else a for a in n.args]
            if n.target == "dmx.quantize":
                cast = _resolve_cast(module, n.cast_name)
                env[n.name] = cast(args[0])  # fake-quant: Q and DQ fused
            elif n.target == "dmx.dequantize":
                env[n.name] = args[0]
            else:
                env[n.name] = n.target(*args, **n.kwargs)
        elif n.op == "output":
            out = env[n.args[0].name] if isinstance(n.args[0], Node) else n.args[0]
    return out


def module_compiler_graph(mod) -> DmxGraph:
    """The per-module Q/DQ graph, from its cast topology."""
    if mod.is_compound:
        from ..nn import modules as dmxnn

        if isinstance(mod, dmxnn.ScaledDotProductAttention):
            return _sdpa_compiler_graph(mod)
        raise NotImplementedError(
            f"{type(mod).__name__} is a compound module and does not support "
            "to_compiler_graph"
        )
    g = DmxGraph()
    in_nodes = []
    for name in mod.input_cast_names:
        cast = mod.input_casts[name]
        in_nodes.append(
            g.placeholder(f"_{name[:-5]}", f"input_casts.{name}", repr(cast.format))
        )
    extra = []
    if getattr(mod, "weight", None) is not None:
        w = g.get_attr(
            "weight",
            "weight_storage_cast",
            repr(mod.weight_storage_cast.format),
        )
        w = g.qdq(w, "weight_cast", repr(mod.weight_cast.format))
        extra.append(w)
    if getattr(mod, "bias", None) is not None and mod.bias_cast is not None:
        extra.append(g.get_attr("bias", "bias_cast", repr(mod.bias_cast.format)))

    fn = _functional_target(mod)
    out = g.call_function(
        fn,
        tuple(in_nodes) + tuple(extra),
        name="_output",
        cast_name=f"output_casts.{mod.output_cast_names[0]}",
        cast_format=repr(mod.output_casts[mod.output_cast_names[0]].format),
    )
    g.output(out)
    return g


def _sdpa_compiler_graph(sdpa) -> DmxGraph:
    """The compound SDPA's decomposed sub-module pipeline inlined into one
    flat Q/DQ graph: the float-mask inference path of
    ``ScaledDotProductAttention`` (q/k/v/mask casts -> actmatmul(q, k^T) ->
    resadd(zeros, mask) -> resadd(scores, bias) -> mul(scale) -> softmax ->
    dropout (identity) -> actmatmul(weights, v)), every edge in its owning
    cast's Q/DQ."""
    g = DmxGraph()

    def fmt(cast_path: str) -> str:
        return repr(_resolve_cast(sdpa, cast_path).format)

    def wrap(node: Node, cast_path: str) -> Node:
        return g.qdq(node, cast_path, fmt(cast_path))

    q = g.placeholder("query", "input_casts.query_states_cast",
                      fmt("input_casts.query_states_cast"))
    k = g.placeholder("key", "input_casts.key_states_cast",
                      fmt("input_casts.key_states_cast"))
    v = g.placeholder("value", "input_casts.value_states_cast",
                      fmt("input_casts.value_states_cast"))
    m = g.placeholder("attn_mask", "input_casts.attn_mask_cast",
                      fmt("input_casts.attn_mask_cast"))
    scale = g.placeholder("scale")

    def _swap_kt(key_states):
        return key_states.transpose(-2, -1)

    def _zeros_bias(query, mask):
        return torch.zeros((query.shape[-2], mask.shape[-1]), dtype=query.dtype,
                           device=query.device)

    def _add(a, b):
        return a + b

    def _mul(a, b):
        return a * b

    def _identity(x):
        return x

    kt = g.call_function(_swap_kt, (k,), name="key_transpose")
    s = g.call_function(
        torch.matmul,
        (
            wrap(q, "actmatmul.input_casts.input_cast"),
            wrap(kt, "actmatmul.input_casts.multiplier_cast"),
        ),
        name="qk_matmul",
        cast_name="actmatmul.output_casts.output_cast",
        cast_format=fmt("actmatmul.output_casts.output_cast"),
    )
    zb = g.call_function(_zeros_bias, (q, m), name="attn_bias_zeros")
    bias = g.call_function(
        _add,
        (
            wrap(zb, "resadd.input_casts.input_cast"),
            wrap(m, "resadd.input_casts.residual_cast"),
        ),
        name="mask_resadd",
        cast_name="resadd.output_casts.output_cast",
        cast_format=fmt("resadd.output_casts.output_cast"),
    )
    s = g.call_function(
        _add,
        (
            wrap(s, "resadd.input_casts.input_cast"),
            wrap(bias, "resadd.input_casts.residual_cast"),
        ),
        name="bias_resadd",
        cast_name="resadd.output_casts.output_cast",
        cast_format=fmt("resadd.output_casts.output_cast"),
    )
    s = g.call_function(
        _mul,
        (
            wrap(s, "mul.input_casts.input_cast"),
            wrap(scale, "mul.input_casts.multiplier_cast"),
        ),
        name="scale_mul",
        cast_name="mul.output_casts.output_cast",
        cast_format=fmt("mul.output_casts.output_cast"),
    )
    s = g.call_function(
        _functional_target(sdpa.softmax),
        (wrap(s, "softmax.input_casts.input_cast"),),
        name="softmax",
        cast_name="softmax.output_casts.output_cast",
        cast_format=fmt("softmax.output_casts.output_cast"),
    )
    s = g.call_function(
        _identity,
        (wrap(s, "dropout.input_casts.input_cast"),),
        name="dropout",
        cast_name="dropout.output_casts.output_cast",
        cast_format=fmt("dropout.output_casts.output_cast"),
    )
    out = g.call_function(
        torch.matmul,
        (
            wrap(s, "actmatmul.input_casts.input_cast"),
            wrap(v, "actmatmul.input_casts.multiplier_cast"),
        ),
        name="wv_matmul",
        cast_name="actmatmul.output_casts.output_cast",
        cast_format=fmt("actmatmul.output_casts.output_cast"),
    )
    g.output(out)
    return g


def _functional_target(mod) -> Callable:
    """The functional op a module's graph node computes (named as the JAX
    package names it: the name is the node's and the ONNX op type's)."""
    from ..nn import modules as dmxnn

    if isinstance(mod, dmxnn.Linear):
        def linear(x, w, b=None):
            y = x @ w.T
            return y if b is None else y + b

        return linear
    if isinstance(mod, dmxnn.ResAdd):
        def res_add(a, b):
            return a + b

        return res_add
    if isinstance(mod, dmxnn.Mul):
        def elem_mul(a, b):
            return a * b

        return elem_mul
    if isinstance(mod, dmxnn.ActActMatMul):
        return torch.matmul
    if isinstance(mod, (dmxnn.Conv1d, dmxnn.Conv2d, dmxnn.ConvTranspose2d)):
        def conv(x, w, b=None):
            y = mod._conv(x, w)
            if b is not None:
                y = y + b.reshape((1, -1) + (1,) * mod._nd)
            return y

        return conv
    if isinstance(mod, dmxnn.Softmax):
        def softmax(x):
            return torch.softmax(x, dim=mod.dim)

        return softmax
    if isinstance(mod, dmxnn.LayerNorm):
        def layer_norm(x, w=None, b=None):
            return mod.functional_forward(x, mod.normalized_shape, w, b, mod.eps)

        return layer_norm
    if isinstance(mod, dmxnn.RMSNorm):
        def rms_norm(x, w=None):
            return mod.functional_forward(x, mod.normalized_shape, w, mod.eps)

        return rms_norm
    if isinstance(mod, dmxnn.Embedding):
        def embed_lookup(ids, w):
            return w[ids]

        return embed_lookup
    if isinstance(mod, dmxnn.Dropout):
        def dropout_identity(x):
            return x

        return dropout_identity

    # fallback: the module's raw op
    if getattr(mod, "_raw_forward", None) is not None:
        return mod._raw_forward
    raise NotImplementedError(f"no functional target for {type(mod).__name__}")


class CompilerGraphs(dict):
    """``{module_name: DmxGraph}`` plus the modules that could NOT be
    exported (``.skipped: {name: reason}``): export coverage is never
    silently partial."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.skipped: Dict[str, str] = {}


def make_compiler_graph(model, strict: bool = False) -> CompilerGraphs:
    """Q/DQ graphs for every DmxModule, the compound SDPA included.
    Modules without a graph emitter are recorded in ``result.skipped`` and
    logged (``strict=True`` raises instead)."""
    import logging

    from .substitute import named_dmx_modules

    log = logging.getLogger(__name__)
    graphs = CompilerGraphs()
    for name, mod in named_dmx_modules(model):
        try:
            graphs[name] = module_compiler_graph(mod)
        except NotImplementedError as e:
            if strict:
                raise
            graphs.skipped[name] = str(e)
            log.warning("compiler graph skipped for %s: %s", name, e)
    return graphs


class _FunctionModule(nn.Module):
    """A callable as the module ``torch.export`` takes."""

    def __init__(self, fn: Callable):
        super().__init__()
        self.fn = fn

    def forward(self, *args):
        return self.fn(*args)


def exported_program(fn, *example_args):
    """``fn`` exported by ``torch.export`` (not strict) at the example
    arguments' shapes: the ``ExportedProgram`` whose text
    :func:`export_program` gives and whose ``.module()`` runs it (its ATen
    ops as the function calls them; ``.run_decompositions()`` lowers them to
    core ATen).  ``fn`` is a module or a callable of tensors."""
    module = fn if isinstance(fn, nn.Module) else _FunctionModule(fn)
    return torch.export.export(module, tuple(example_args), strict=False)


def export_program(fn, *example_args) -> str:
    """The text of ``fn``'s ATen graph (:func:`exported_program`): the
    artifact a downstream compiler that ingests ATen graphs takes.  A T2
    launch is the operator ``dmx_compressor_tpu_torch::bfp_cast`` of the
    graph."""
    return str(exported_program(fn, *example_args))


def export_program_bucketed(fn, example_args, *, axis_buckets):
    """Multi-signature export: one program PER SHAPE BUCKET plus a dispatch
    table, the JAX package's answer to dynamic shapes, kept as its contract.

    ``example_args``: the base example inputs.  ``axis_buckets``: dict
    ``{arg_index: (axis, [sizes...])}``; every combination of the listed
    sizes is exported (an argument zero-padded at the end of the axis, or
    cut, to the size; other arguments keep their example shape).  Returns
    ``(programs, dispatch)``: ``programs`` maps a shape-key string
    (``a1x0=4``) to program text, ``dispatch(args) -> key`` picks the
    smallest bucket that fits (pad-to-bucket is the runtime contract) and
    raises ValueError past the largest."""
    import itertools

    items = sorted(axis_buckets.items())
    combos = itertools.product(*[sorted(sizes) for _, (_, sizes) in items])
    programs = {}
    for combo in combos:
        args = list(example_args)
        parts = []
        for (idx, (axis, _)), size in zip(items, combo):
            a = args[idx]
            ax = axis % a.ndim
            base = a.shape[ax]
            if size >= base:
                pad = list(a.shape)
                pad[ax] = size - base
                args[idx] = torch.cat([a, a.new_zeros(pad)], dim=ax)
            else:
                args[idx] = a.narrow(ax, 0, size)
            parts.append(f"a{idx}x{axis}={size}")
        programs["_".join(parts)] = export_program(fn, *args)

    def dispatch(args) -> str:
        parts = []
        for idx, (axis, sizes) in items:
            actual = args[idx].shape[axis % args[idx].ndim]
            fitting = [s for s in sorted(sizes) if s >= actual]
            if not fitting:
                raise ValueError(
                    f"arg {idx} axis {axis} size {actual} exceeds the "
                    f"largest bucket {max(sizes)}"
                )
            parts.append(f"a{idx}x{axis}={fitting[0]}")
        return "_".join(parts)

    return programs, dispatch
