"""Legacy flat-graph transformers over the DmxGraph IR.

Port of ``dmx_compressor_tpu/transform/legacy.py``, the fx-era
transformers re-targeted at :class:`~.qdq.DmxGraph`:

- :func:`cast_input_output_transform`: wrap every placeholder, ``get_attr``
  weight edge, and the output edge of a flat graph in Q/DQ pairs;
- :func:`configure_graph`: re-set the format annotation of existing Q/DQ
  pairs from a ``{node-name-regex: format-shorthand}`` config;
- :func:`node_dict`: name -> Node map for visualization;
- :func:`stitch_graphs` and :func:`fold_redundant_qdq`: compose two module
  graphs and drop the Q/DQ pairs that re-cast a value already on the same
  format's grid.

These operate on the IR alone (no module state); the node lists they leave
are the JAX package's for the same graphs.
"""

from __future__ import annotations

import re
from typing import Dict, Optional

from .qdq import DmxGraph, Node


def node_dict(graph: DmxGraph) -> Dict[str, Node]:
    """name -> Node map."""
    return {n.name: n for n in graph.nodes}


def _rewire(graph: DmxGraph, old: Node, new: Node) -> None:
    """Point every consumer of ``old`` (other than ``new``'s own chain) at
    ``new``."""
    for n in graph.nodes:
        if n is new or n.op in ("placeholder", "get_attr"):
            continue
        if any(a is old for a in n.args):
            # skip the quantize node that feeds the new chain
            if n.target == "dmx.quantize" and n.cast_name == new.cast_name:
                continue
            n.args = tuple(new if a is old else a for a in n.args)


def cast_input_output_transform(
    graph: DmxGraph,
    input_format: str = "SAME",
    output_format: str = "SAME",
    weight_format: Optional[str] = None,
    cast_prefix: str = "io",
) -> DmxGraph:
    """Add Q/DQ pairs around every placeholder, optional weight ``get_attr``,
    and the output edge: every placeholder / output / weight ``get_attr`` is
    followed by its cast node.

    Formats are shorthand strings recorded as edge annotations; the graph
    stays purely declarative (the IR's Q/DQ pairs evaluate as fake-quant
    casts only where a module provides the cast state).
    """
    out_node = next(n for n in graph.nodes if n.op == "output")
    graph.nodes.remove(out_node)

    for n in list(graph.nodes):
        if n.op == "placeholder":
            dq = graph.qdq(n, f"{cast_prefix}.input_casts.{n.name}", input_format)
            _rewire(graph, n, dq)
        elif n.op == "get_attr" and weight_format is not None:
            leaf = str(n.target).rsplit(".", 1)[-1]
            if leaf in ("weight", "kernel"):
                dq = graph.qdq(
                    n, f"{cast_prefix}.weight_casts.{n.name}", weight_format
                )
                _rewire(graph, n, dq)

    result = out_node.args[0]
    if isinstance(result, Node):
        result = graph.qdq(
            result, f"{cast_prefix}.output_casts.output", output_format
        )
    graph.output(result)
    return graph


def configure_graph(graph: DmxGraph, config: Dict[str, str]) -> int:
    """Re-set the ``cast_format`` annotation of existing Q/DQ pairs whose
    *node name* (or cast name) matches a config key regex: the formats of
    existing casts re-set from a config keyed by scope.  Returns the number
    of nodes updated."""
    updated = 0
    for pattern, fmt in config.items():
        rx = re.compile(pattern)
        for n in graph.nodes:
            if (
                n.op == "call_function"
                and n.target in ("dmx.quantize", "dmx.dequantize")
                and n.cast_name is not None
                and (rx.fullmatch(n.name) or rx.fullmatch(n.cast_name))
            ):
                n.cast_format = fmt
                if n.target == "dmx.quantize":
                    n.args = n.args[:3] + (fmt,)
                updated += 1
    return updated


def stitch_graphs(
    first: DmxGraph,
    second: DmxGraph,
    prefixes: Optional[tuple] = None,
) -> DmxGraph:
    """Compose two single-input/single-output module graphs sequentially:
    ``second(first(x))`` as one flat graph (how adjacent modules' Q/DQ
    boundaries become visible to :func:`fold_redundant_qdq`).

    ``prefixes`` — optional ``("m1", "m2")`` module paths prepended to each
    graph's cast names, ``get_attr`` targets, and scale/zero_point arg refs,
    so the stitched graph evaluates against a container holding both
    modules under those attribute names.
    """
    g = DmxGraph()
    g._counter = max(first._counter, second._counter) + 1

    def reprefix(value, prefix):
        if prefix is None or not isinstance(value, str):
            return value
        return f"{prefix}.{value}"

    def copy_nodes(src, env, prefix, suffix="", input_value=None):
        out_val = None
        for n in src.nodes:
            if n.op == "placeholder":
                if input_value is None:
                    g.nodes.append(n)
                    env[n.name] = n
                else:
                    env[n.name] = input_value
            elif n.op == "output":
                a = n.args[0]
                out_val = env[a.name] if isinstance(a, Node) else a
            else:
                args = tuple(
                    env[a.name] if isinstance(a, Node) else a for a in n.args
                )
                if prefix is not None and n.target in (
                    "dmx.quantize",
                    "dmx.dequantize",
                ):
                    # scale/zero_point refs live after the tensor arg
                    args = (args[0],) + tuple(
                        reprefix(a, prefix) for a in args[1:]
                    )
                target = n.target
                if n.op == "get_attr":
                    target = reprefix(target, prefix)
                new = Node(
                    n.op,
                    n.name + suffix,
                    target=target,
                    args=args,
                    kwargs=dict(n.kwargs),
                    cast_name=reprefix(n.cast_name, prefix),
                    cast_format=n.cast_format,
                )
                g.nodes.append(new)
                env[n.name] = new
        return out_val

    p1, p2 = prefixes if prefixes is not None else (None, None)
    env: Dict[str, Node] = {}
    mid = copy_nodes(first, env, p1)
    out = copy_nodes(second, {}, p2, suffix="_b", input_value=mid)
    g.output(out)
    return g


def _is_idempotent_format(shorthand: Optional[str]) -> bool:
    """Casting twice to the same FN float format is a no-op (the value is
    already on the format's grid); fixed-point casts with independent scales
    are NOT idempotent and must be kept."""
    if shorthand is None:
        return False
    from ..numerics.format import FloatingPoint, Format, Same

    try:
        fmt = Format.from_shorthand(shorthand)
    except Exception:
        return False
    return isinstance(fmt, Same) or (
        isinstance(fmt, FloatingPoint) and getattr(fmt, "rounding", "N") != "S"
    )


def fold_redundant_qdq(graph: DmxGraph) -> int:
    """Drop quantize/dequantize pairs that re-cast a value already on the
    same format's grid — the adjacent-module output->FLOAT16 then
    input->FLOAT16 pattern (a downstream compiler performs the same fold).
    Returns the number of pairs removed."""
    removed = 0
    changed = True
    while changed:
        changed = False
        by_producer = {}
        for n in graph.nodes:
            if n.op != "call_function" or n.target != "dmx.quantize":
                continue
            src = n.args[0]
            if (
                isinstance(src, Node)
                and src.target == "dmx.dequantize"
                and src.cast_format == n.cast_format
                and _is_idempotent_format(n.cast_format)
            ):
                by_producer[n.name] = (n, src)
        for q2, dq1 in by_producer.values():
            # q2 -> dq2; rewire dq2's consumers to dq1 and drop the pair
            dq2 = next(
                (
                    n
                    for n in graph.nodes
                    if n.target == "dmx.dequantize"
                    and n.args
                    and n.args[0] is q2
                ),
                None,
            )
            if dq2 is None:
                continue
            for n in graph.nodes:
                if n.op in ("call_function", "output") and any(
                    a is dq2 for a in n.args
                ):
                    n.args = tuple(dq1 if a is dq2 else a for a in n.args)
            graph.nodes.remove(q2)
            graph.nodes.remove(dq2)
            removed += 1
            changed = True
            break
    return removed
