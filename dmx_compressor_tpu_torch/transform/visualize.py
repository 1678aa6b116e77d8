"""Graph visualization: Graphviz dot rendering of Q/DQ compiler graphs.

Port of ``dmx_compressor_tpu/transform/visualize.py``: nodes carry
op / format metadata, edges follow dataflow, Q/DQ pairs render as annotated
boundary nodes.  For the same graph the dot text is the JAX package's
string.
"""

from __future__ import annotations

from typing import Dict, Optional

from .qdq import DmxGraph, Node

_COLORS = {
    "placeholder": "lightblue",
    "get_attr": "lightyellow",
    "quantize": "salmon",
    "dequantize": "palegreen",
    "call_function": "white",
    "output": "lightgray",
}


def _node_kind(n: Node) -> str:
    if n.target == "dmx.quantize":
        return "quantize"
    if n.target == "dmx.dequantize":
        return "dequantize"
    return n.op


def graph_to_dot(g: DmxGraph, name: str = "dmx_graph") -> str:
    """Render a DmxGraph as Graphviz dot text."""
    lines = [f'digraph "{name}" {{', "  rankdir=TB;", "  node [shape=box, style=filled];"]
    for n in g.nodes:
        kind = _node_kind(n)
        label = n.name
        if kind in ("quantize", "dequantize") and n.cast_format:
            label += f"\\n{n.cast_format}"
        elif n.op == "call_function" and not isinstance(n.target, str):
            label += f"\\n{getattr(n.target, '__name__', '')}"
        lines.append(
            f'  "{n.name}" [label="{label}", fillcolor={_COLORS.get(kind, "white")}];'
        )
    for n in g.nodes:
        for a in n.args:
            if isinstance(a, Node):
                lines.append(f'  "{a.name}" -> "{n.name}";')
    lines.append("}")
    return "\n".join(lines)


def visualize_graph(
    model_or_graph, file_name: Optional[str] = None
) -> Dict[str, str] | str:
    """Dot text for one graph or for every module graph of a model
    (``DmxModel.visualize_graph``); with ``file_name`` also written there."""
    if isinstance(model_or_graph, DmxGraph):
        dot = graph_to_dot(model_or_graph)
        if file_name:
            with open(file_name, "w") as f:
                f.write(dot)
        return dot
    from .qdq import make_compiler_graph

    graphs = make_compiler_graph(
        model_or_graph.module if hasattr(model_or_graph, "module") else model_or_graph
    )
    dots = {k: graph_to_dot(v, k) for k, v in graphs.items()}
    if file_name:
        with open(file_name, "w") as f:
            for k, d in dots.items():
                f.write(f"// {k}\n{d}\n\n")
    return dots
