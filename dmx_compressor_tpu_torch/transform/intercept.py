"""ATen-level fake-quant interception of arbitrary (un-authored) torch code.

Port of ``dmx_compressor_tpu/transform/intercept.py``.  The module-tree
substitution (``transform/substitute.py``) covers models authored with the
``nn`` / ``rawnn`` modules; this module removes that requirement for plain
torch code: it enumerates the function's intercepted ops once, on the
example arguments, then runs the function with fake-quant casts around
each of them.

    qfn, sites = intercept(fn, example_args, rules=InterceptRules(...))
    y = qfn(*args)          # same function, BASIC numerics at every matmul

``sites`` lists every intercepted op (``<kind>_<i>`` in call order, i
counted per kind), so configs can address individual sites; per-site
overrides replace the default rule.  Ops run inside a module get the module
call path as their scope, relative to the outermost module called
(``layers.0.self_attn/dot_0``): the counterpart of the JAX package's
``jax.named_scope`` ids; bare ``<kind>_<i>`` ids still address scoped
sites.

Design.  The JAX package traces to a jaxpr and re-evaluates it.  Here a
``TorchDispatchMode`` sees the same ATen ops a ``make_fx`` trace records
(below autograd, after the composite ops' decompositions), in call order,
and applies the casts as they run:

- ``mm`` / ``bmm`` -> the dot site: input cast blocked along -1, multiplier
  along -2, output cast; ``addmm`` (``F.linear`` with a bias) is its dot
  site then an add site, as the JAX package sees ``dot_general`` then
  ``add``;
- ``add`` / ``mul`` (and their in-place forms) -> a site when both operands
  are tensors of rank >= 1 (a Python or rank-0 scalar is not a site);
- ``exp`` -> its io casts;
- ``_softmax`` is decomposed (its exp chain, as ``jax.nn.softmax``) when
  the exp rule is set, and ``native_layer_norm`` (its normalize, scale and
  bias ops, as flax's LayerNorm) when the add or mul rule is set.

No fake tensor reaches the function, so a function that launches the
port's kernels through ctypes intercepts the same as its plain version
would around those launches.  Rank-0 and non-float operands are not cast.
Gradients flow as through the uncast ops (the casts run below autograd: a
straight-through estimator).  A call whose op sequence differs from the
example arguments' raises instead of misaddressing sites.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from ..numerics.format import Format, Same

aten = torch.ops.aten


@dataclasses.dataclass(frozen=True)
class SiteRule:
    """Cast formats for one interception site (shorthand strings)."""

    input_format: str = "SAME"
    multiplier_format: str = "SAME"  # 2nd operand (dot/mul/add residual)
    output_format: str = "SAME"
    input_block_dim: int = -1
    multiplier_block_dim: int = -2


@dataclasses.dataclass
class InterceptRules:
    """Which ops to intercept and with what formats.  ``overrides`` maps
    site ids (as returned in ``sites``) to per-site rules."""

    dot: Optional[SiteRule] = None
    add: Optional[SiteRule] = None
    mul: Optional[SiteRule] = None
    exp: Optional[SiteRule] = None
    overrides: Dict[str, SiteRule] = dataclasses.field(default_factory=dict)

    @classmethod
    def basic(cls) -> "InterceptRules":
        """The BASIC functional-op contract (``config_rules.BASIC`` on
        ActActMatMul / ResAdd)."""
        return cls(
            dot=SiteRule("BFP[8|8]{64}(SN)", "BFP[8|8]{64}(SN)",
                         "FP[1|5|10,15](FN)"),
            add=SiteRule("FP[1|5|10,15](FN)", "FP[1|5|10,15](FN)",
                         "FP[1|5|10,15](FN)"),
        )


def _castable(x) -> bool:
    return isinstance(x, torch.Tensor) and x.ndim > 0 and x.is_floating_point()


def _apply_cast_module(c, x):
    """Route an operand through a stateful CastTo; rank-0 operands stay
    uncast (blocked casts have no dim to block over), as in :func:`_cast`."""
    return c(x) if _castable(x) else x


@functools.lru_cache(maxsize=None)
def _format(shorthand: str) -> Format:
    return Format.from_shorthand(shorthand)


def _cast(x, shorthand: str, block_dim: int):
    fmt = _format(shorthand)
    if isinstance(fmt, Same) or not _castable(x):
        return x
    # Format.cast handles a dim off the block with a remainder block, as the
    # module path does: no tail stays uncast
    return fmt.cast(x, block_dim)


# op -> (kind, out-of-place form)
_INTERCEPTED = {
    aten.mm.default: ("dot", aten.mm.default),
    aten.bmm.default: ("dot", aten.bmm.default),
    aten.add.Tensor: ("add", aten.add.Tensor),
    aten.add_.Tensor: ("add", aten.add.Tensor),
    aten.mul.Tensor: ("mul", aten.mul.Tensor),
    aten.mul_.Tensor: ("mul", aten.mul.Tensor),
    aten.exp.default: ("exp", aten.exp.default),
    aten.exp_.default: ("exp", aten.exp.default),
}


def _rule_casts(rule: SiteRule, kind: str):
    """Stateful CastTo quantizers for one site: the objects the module path
    hangs off every DmxModule, so observers, calibration and freeze / thaw
    behave the same."""
    from ..numerics.cast import CastTo

    mult_bd = rule.multiplier_block_dim if kind == "dot" else rule.input_block_dim
    return {
        "input": CastTo(rule.input_format, block_dim=rule.input_block_dim),
        "multiplier": CastTo(rule.multiplier_format, block_dim=mult_bd),
        "output": CastTo(rule.output_format, block_dim=-1),
    }


def _site_id(kind: str, i: int, scope: str) -> str:
    return f"{scope}/{kind}_{i}" if scope else f"{kind}_{i}"


def _sid_kind(sid: str) -> str:
    """Op kind from a (possibly scope-qualified) site id."""
    return sid.rsplit("_", 1)[0].rsplit("/", 1)[-1]


def _site_lookup(mapping, sid: str, kind: str, i: int):
    """Per-site table lookup: scope-qualified id first, bare id fallback."""
    if sid in mapping:
        return mapping[sid]
    return mapping.get(f"{kind}_{i}")


def _is_site(kind: str, args) -> bool:
    """add / mul count as sites only when both operands are tensors of rank
    >= 1 (tensor-scalar ops are not substitution sites)."""
    if kind not in ("add", "mul"):
        return True
    return all(isinstance(a, torch.Tensor) and a.ndim >= 1 for a in args[:2])


def _structure(obj):
    """The nesting of tuples, lists and dicts around the leaves."""
    if isinstance(obj, (tuple, list)):
        return (type(obj).__name__, tuple(_structure(o) for o in obj))
    if isinstance(obj, dict):
        return ("dict", tuple((k, _structure(v)) for k, v in sorted(obj.items())))
    return None


class _Scopes:
    """The module call path, kept by global forward hooks while a call runs:
    each op's scope is its innermost module's path under the outermost."""

    def __init__(self):
        self.stack: List[str] = []
        self.names: Dict[int, str] = {}
        self.paused = False

    def current(self) -> str:
        return self.stack[-1] if self.stack else ""

    def _enter(self, module, args):
        if self.paused:
            return
        if not self.stack:
            self.names = {}
            for n, m in module.named_modules(remove_duplicate=False):
                self.names.setdefault(id(m), n)
        self.stack.append(self.names.get(id(module), self.current()))

    def _exit(self, module, args, output):
        if not self.paused and self.stack:
            self.stack.pop()

    def __enter__(self):
        from torch.nn.modules.module import (
            register_module_forward_hook,
            register_module_forward_pre_hook,
        )

        self.stack = []
        self._handles = [register_module_forward_pre_hook(self._enter),
                         register_module_forward_hook(self._exit)]
        return self

    def __exit__(self, *exc):
        for h in self._handles:
            h.remove()
        self.stack = []
        return False


class _InterceptMode(TorchDispatchMode):
    """Enumerates the sites of a run (``apply`` False) or casts around them."""

    def __init__(self, rules: InterceptRules, site_casts, apply: bool, scopes: _Scopes):
        super().__init__()
        self.rules = rules
        self.site_casts = site_casts
        self.apply = apply
        self.scopes = scopes
        self.counts: Dict[str, int] = {}
        self.seen: List[str] = []
        from torch._decomp import get_decompositions

        ops = []
        if rules.exp is not None:
            ops.append(aten._softmax.default)
        if rules.add is not None or rules.mul is not None:
            ops.append(aten.native_layer_norm.default)
        self.decompose = get_decompositions(ops)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func in self.decompose:
            with self:  # the decomposition's ops pass through the mode
                return self.decompose[func](*args, **kwargs)
        if func is aten.addmm.default and (self.rules.dot is not None
                                           or self.rules.add is not None):
            bias, m1, m2 = args[:3]
            beta, alpha = kwargs.get("beta", 1), kwargs.get("alpha", 1)
            y = self._maybe_site(aten.mm.default, "dot", (m1, m2), {})
            if alpha != 1:
                y = y * alpha
            return self._maybe_site(aten.add.Tensor, "add", (y, bias if beta == 1 else bias * beta),
                                    {})
        entry = _INTERCEPTED.get(func)
        if entry is None:
            return func(*args, **kwargs)
        kind, plain = entry
        if func is plain:
            return self._maybe_site(func, kind, args, kwargs)
        # an in-place form: the site out of place, written back
        out = self._maybe_site(plain, kind, args, kwargs)
        if out is args[0]:
            return out
        return args[0].copy_(out)

    def _maybe_site(self, func, kind, args, kwargs):
        rule = getattr(self.rules, kind)
        if rule is None or not _is_site(kind, args):
            return func(*args, **kwargs)
        i = self.counts.get(kind, 0)
        self.counts[kind] = i + 1
        sid = _site_id(kind, i, self.scopes.current())
        self.seen.append(sid)
        if not self.apply:
            return func(*args, **kwargs)
        rule = _site_lookup(self.rules.overrides, sid, kind, i) or rule
        casts = _site_lookup(self.site_casts, sid, kind, i)
        a = args[0]
        b = args[1] if len(args) > 1 else None
        self.scopes.paused = True  # a CastTo is a module of its own
        try:
            if casts is not None:
                a = _apply_cast_module(casts["input"], a)
                if b is not None:
                    b = _apply_cast_module(casts["multiplier"], b)
            else:
                a = _cast(a, rule.input_format, rule.input_block_dim)
                if b is not None:
                    bdim = rule.multiplier_block_dim if kind == "dot" else rule.input_block_dim
                    b = _cast(b, rule.multiplier_format, bdim)
            out = func(a, *((b,) if b is not None else ()), *args[2:], **kwargs)
            if casts is not None:
                return _apply_cast_module(casts["output"], out)
            return _cast(out, rule.output_format, -1)
        finally:
            self.scopes.paused = False


def _run(fn, args, rules, site_casts, apply: bool):
    scopes = _Scopes()
    mode = _InterceptMode(rules, site_casts, apply, scopes)
    with scopes, mode:
        out = fn(*args)
    return out, mode.seen


def _enumerate(fn, example_args, rules) -> List[str]:
    """The sites of ``fn`` on ``example_args``, in call order (one run, no
    casts, no gradient)."""
    with torch.no_grad():
        _, sites = _run(fn, tuple(example_args), rules, {}, apply=False)
    return sites


def _quantized(fn, example_args, sites, rules, site_casts):
    in_structure = _structure(tuple(example_args))

    def quantized_fn(*args):
        assert _structure(tuple(args)) == in_structure, \
            "argument structure must match example_args"
        out, seen = _run(fn, args, rules, site_casts, apply=True)
        if seen != sites:
            raise RuntimeError(
                "the function ran other intercepted ops than on example_args "
                f"({len(seen)} sites against {len(sites)}); intercept it on these arguments")
        return out

    return quantized_fn


class QuantizedFunction:
    """A re-configurable fake-quantized view of an arbitrary torch function
    (the functional counterpart of ``DmxModel.from_raw``: ``sites`` play
    the role of module names, ``configure`` the role of config rules).

    Every site carries real :class:`~..numerics.cast.CastTo` quantizers
    (``site_casts[site_id]["input"/"multiplier"/"output"]``): observers,
    affine qparams, calibration and freeze / thaw work as on the module
    path: :meth:`enable_calibration`, stream data through the function, then
    :meth:`enable_calibration` ``(False)`` to freeze.
    """

    def __init__(self, fn: Callable, example_args: Sequence[Any],
                 rules: Optional[InterceptRules] = None):
        self._fn = fn
        self._example_args = tuple(example_args)
        self.rules = rules or InterceptRules.basic()
        self.site_casts: Dict[str, Dict[str, Any]] = {}
        self._rebuild()

    def _rebuild(self):
        self.sites = _enumerate(self._fn, self._example_args, self.rules)
        for sid in self.sites:
            if sid in self.site_casts:
                continue
            kind = _sid_kind(sid)
            rule = self.rules.overrides.get(sid, getattr(self.rules, kind))
            if rule is not None:
                self.site_casts[sid] = _rule_casts(rule, kind)
        self._qfn = _quantized(self._fn, self._example_args, self.sites, self.rules,
                               self.site_casts)

    def _canonical_sid(self, key: str) -> Optional[str]:
        """Resolve an override key to a member of ``self.sites``: exact
        match first, then the bare ``<kind>_<i>`` fallback onto the unique
        scoped site sharing that kind / index."""
        if key in self.sites:
            return key
        matches = [s for s in self.sites if s.rsplit("/", 1)[-1] == key]
        return matches[0] if len(matches) == 1 else None

    def configure(self, overrides: Dict[str, SiteRule]) -> "QuantizedFunction":
        """Apply per-site rule overrides (keys from ``self.sites``; bare
        ids resolve to their scope-qualified site).  Overridden sites get
        fresh quantizers (their observer state resets, like reconfiguring a
        module's format).  An unknown site raises ValueError."""
        resolved = {}
        unknown = []
        for key, rule in overrides.items():
            sid = self._canonical_sid(key)
            if sid is None:
                unknown.append(key)
            else:
                resolved[sid] = rule
        if unknown:
            raise ValueError(f"unknown sites: {sorted(unknown)}")
        self.rules.overrides.update(resolved)
        for sid, rule in resolved.items():
            self.site_casts[sid] = _rule_casts(rule, _sid_kind(sid))
        self._rebuild()
        return self

    def enable_calibration(self, state: bool = True, **kwargs) -> "QuantizedFunction":
        """Begin / end observer calibration on every site quantizer whose
        format is not SAME (``CastTo.enable_calibration`` per site:
        ``observer_cls``, ``qscheme_to_overload``, ``group_size``,
        ``ch_axis`` pass through)."""
        for casts in self.site_casts.values():
            for c in casts.values():
                if not isinstance(c.format, Same):
                    c.enable_calibration(state, **kwargs)
        return self

    def named_quantizers(self):
        """(site_id, slot, CastTo) triples: the functional counterpart of
        the module tree's named quantizer walk."""
        for sid in self.sites:
            for slot, c in self.site_casts.get(sid, {}).items():
                yield sid, slot, c

    def __call__(self, *args):
        return self._qfn(*args)


def intercept(
    fn: Callable,
    example_args: Sequence[Any],
    rules: Optional[InterceptRules] = None,
    site_casts: Optional[Dict[str, Dict[str, Any]]] = None,
) -> Tuple[Callable, List[str]]:
    """Return ``(quantized_fn, site_ids)`` for an arbitrary torch function.

    ``quantized_fn`` runs ``fn`` with the rules' casts around every
    intercepted op; ``site_ids`` names the sites (``"<kind>_<i>"`` in call
    order, prefixed with the module call path where the op ran inside a
    submodule) for per-site overrides.  ``site_casts`` (site id ->
    {"input", "multiplier", "output"} CastTo modules) routes matching sites
    through stateful quantizers instead of the rule's format strings: the
    calibration surface (:class:`QuantizedFunction` builds and owns them).
    """
    rules = rules or InterceptRules.basic()
    sites = _enumerate(fn, example_args, rules)
    return _quantized(fn, example_args, sites, rules, site_casts or {}), sites
