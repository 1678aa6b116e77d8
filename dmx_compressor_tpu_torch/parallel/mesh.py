"""Device meshes, sharding rules, and rank-local tensor parallelism.

Port of ``dmx_compressor_tpu/parallel/mesh.py``.  The JAX package shards by
placement: ``shard_state`` attaches a ``NamedSharding`` to every leaf and
XLA's GSPMD derives the collectives.  The port cannot: its kernels take raw
pointers through ctypes (``kernels.py``), so no distributed tensor may
reach a launch, and a ``DTensor``'s implicit redistribution would not match
the kernels' route anyway.  Here :func:`shard_state` makes the model
rank-local in place instead: each rank keeps plain tensors on its device,
sliced to its shard, and the modules insert their collectives explicitly in
Megatron's manual form (the form ``pipeline_forward``'s docstring in the
JAX package describes):

- a column-parallel linear (``q_proj`` ... ``fc1``, ``c_attn``, ``c_fc``)
  keeps its rows of the weight (its output features) and returns its local
  outputs; the merged q/k/v projections (``qkv_merged``, GPT-2's
  ``c_attn``) are sharded by heads in each of their three parts, so each
  rank holds its own heads of q, k and v;
- a row-parallel linear (``out_proj``, ``fc2``, ``c_proj``) keeps its
  columns, all-reduces its partial products, and only then adds its bias
  and applies its accumulator and output casts (once, on the sum);
- the vocabulary-sharded embedding looks up its own rows (the others
  masked to zero) and all-reduces; the tied LM head and CLIP's two output
  projections all-gather their outputs;
- each attention module's head count becomes the local one, so the caches
  that ``init_cache`` makes are ``[B, H / tp, S, D]``.

``torch.distributed.device_mesh.DeviceMesh`` is the counterpart of
``jax.sharding.Mesh``: :func:`make_mesh` builds one over the default
process group, and each axis's process group carries the collectives.

The rules are JAX's, written over the port's ``state_dict`` keys (no
``.value`` suffix; packed payloads ``weight_mantissa`` /
``weight_exponent``, ``weight_nibbles`` / ``weight_block_scale``).  A BFP
block must stay whole on a shard: a row-parallel linear needs ``in / tp``
to be a multiple of each block along its input features (JAX's docstring
states the same condition); a cast on a rank-local activation must be
elementwise or whole-blocked there, and an observer on one sees the
activation gathered over the group (a whole-tensor statistic).  What the
port cannot shard raises ``ValueError``: a head count that does not divide
tp (the port cannot split a head), a family it does not cover yet (only
OPT, GPT-2 and CLIP are), a block that would be cut.  A dimension that
does not divide its axis elsewhere (the vocabulary, an MLP width, a
projection) leaves its whole unit replicated and is logged, as JAX logs
its fallback.

Call :func:`shard_state` on the model as it will run (after its mode is
built and compressed); a model once sharded refuses ``DmxModel.from_raw``
and ``compress_for_inference``.
"""

from __future__ import annotations

import dataclasses
import logging
import re
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from . import comm

log = logging.getLogger(__name__)

__all__ = ["P", "make_mesh", "axis_size", "spec_for_path", "rules_for_model", "shard_state",
           "data_sharding", "NamedSharding", "TPShard", "TRANSFORMER_RULES"]


class P(tuple):
    """A partition spec: one mesh axis name (or None) per tensor dim, as
    ``jax.sharding.PartitionSpec``."""

    def __new__(cls, *axes):
        return super().__new__(cls, axes)

    def __getnewargs__(self):
        return tuple(self)

    def __repr__(self):
        return f"P{tuple.__repr__(self)}" if len(self) != 1 else f"P({self[0]!r})"


def make_mesh(shape: Sequence[int], axis_names: Sequence[str] = ("dp", "tp"),
              device_type: Optional[str] = None):
    """A ``DeviceMesh`` over the first prod(shape) ranks of the default
    process group, row-major (the last axis varies fastest, as JAX's
    ``make_mesh`` lays out its devices).  ``device_type`` defaults to the
    card where the default group is NCCL, else the CPU.  A rank outside
    the mesh gets one whose ``get_coordinate()`` is None."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    n = 1
    for s in shape:
        n *= int(s)
    world = dist.get_world_size()
    if n > world:
        raise ValueError(f"need {n} ranks, have {world}")
    if device_type is None:
        device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return DeviceMesh(device_type, torch.arange(n).reshape(tuple(int(s) for s in shape)),
                      mesh_dim_names=tuple(axis_names))


def axis_size(mesh, axis: Optional[str]) -> int:
    """The size of ``mesh``'s axis ``axis`` (1 for None or an axis it lacks)."""
    if axis is None or axis not in (mesh.mesh_dim_names or ()):
        return 1
    return mesh.shape[mesh.mesh_dim_names.index(axis)]


# Module-name vocabularies for tensor parallelism, JAX's: weight layout
# [out, in], "column parallel" shards dim 0 (out), "row parallel" dim 1 (in).
_COL = r"q_proj|k_proj|v_proj|fc1|gate_proj|up_proj|c_attn|c_fc|visual_projection|text_projection"
_ROW = r"out_proj|o_proj|fc2|down_proj|c_proj"
_W = r"weight|weight_mantissa|weight_exponent|weight_nibbles|weight_block_scale"

# (key regex, spec) over the port's state-dict keys; first match wins.  JAX's
# table with the port's names; the port adds the merged q/k/v projection
# (``qkv_merged``: column parallel by heads, as ``c_attn``), which JAX
# leaves replicated because GSPMD re-lays the merged output out itself.
TRANSFORMER_RULES: Tuple[Tuple[str, P], ...] = (
    # column parallel (shard out over tp)
    (rf".*({_COL}|qkv_merged)\.({_W})$", P("tp", None)),
    (rf".*({_COL}|qkv_merged)\.bias$", P("tp")),
    # per-out-channel quantizer state on column-parallel weight casts shards
    # with the out dim; input-cast state follows the (unsharded) in dim
    (rf".*({_COL}|qkv_merged)\.(weight_cast|weight_storage_cast)\.(scale|zero_point)$",
     P("tp")),
    (rf".*({_COL}|qkv_merged).*(scale|zero_point)$", P()),
    # row parallel (shard in over tp); per-block exponents and scales shard
    # the same way when in % (tp * block) == 0
    (rf".*({_ROW})\.({_W})$", P(None, "tp")),
    (rf".*({_ROW})\.bias$", P()),
    # conv stems (Whisper conv1 / conv2, CLIP's patch embedding) stay
    # replicated, as in JAX.  Embeddings: the vocabulary over tp (their
    # quantizer state replicated)
    (r".*embed_tokens.*(scale|zero_point)$", P()),
    (r".*embed_tokens.*", P("tp", None)),
    # the tied LM head
    (r".*lm_head.*(scale|zero_point)$", P()),
    (rf".*lm_head.*(embedding|{_W})$", P("tp", None)),
    (r".*(wte|token_embedding)\..*", P("tp", None)),
    (r".*(embed_positions|wpe|position_embedding)\..*", P(None)),
    # KV-cache buffers [B, H(kv), S, D]: batch over dp, heads over tp (the
    # port's caches are made rank-local by ``init_cache``)
    (r".*\.(base_k|base_v|tail_k|tail_v|k_q|v_q|k|v)$", P("dp", "tp")),
    (r".*\.(k_scale|v_scale)$", P("dp", "tp")),
    # norms and everything else: replicated
    (r".*", P()),
)


def spec_for_path(path: str, rules=TRANSFORMER_RULES) -> P:
    for pat, spec in rules:
        if re.fullmatch(pat, path):
            return P(*spec)
    return P()


def rules_for_model(model) -> Tuple[Tuple[str, P], ...]:
    """Exact-path TP rules from the model's Dmx Linears (module-type
    driven), ahead of :data:`TRANSFORMER_RULES`.  Linears whose name
    matches neither the column nor the row vocabulary are left replicated
    and logged once."""
    from ..transform.substitute import named_dmx_modules

    module = getattr(model, "module", model)
    col_re, row_re = re.compile(rf"({_COL}|qkv_merged)$"), re.compile(rf"({_ROW})$")
    rules, unmatched = [], []
    for name, mod in named_dmx_modules(module):
        if not hasattr(mod, "in_features"):
            continue
        leaf, esc = name.rsplit(".", 1)[-1], re.escape(name)
        if col_re.fullmatch(leaf):
            rules += [(rf"{esc}\.({_W})$", P("tp", None)), (rf"{esc}\.bias$", P("tp")),
                      (rf"{esc}\.(weight_cast|weight_storage_cast)\.(scale|zero_point)$",
                       P("tp"))]
        elif row_re.fullmatch(leaf):
            rules += [(rf"{esc}\.({_W})$", P(None, "tp"))]
        else:
            unmatched.append(name)
    if unmatched:
        log.warning("TP rule generator: %d Linear(s) left replicated (no column/row role "
                    "matched): %s", len(unmatched), ", ".join(unmatched[:8]))
    return tuple(rules) + TRANSFORMER_RULES


@dataclasses.dataclass(eq=False)
class NamedSharding:
    """A spec on a mesh (``jax.sharding.NamedSharding``): :meth:`local`
    gives this rank's block of a replicated tensor."""

    mesh: Any
    spec: P

    def local(self, x: torch.Tensor) -> torch.Tensor:
        coord = self.mesh.get_coordinate()
        names = self.mesh.mesh_dim_names
        for dim, ax in enumerate(self.spec):
            if ax is None:
                continue
            n, i = self.mesh.shape[names.index(ax)], coord[names.index(ax)]
            if x.shape[dim] % n:
                raise ValueError(f"dim {dim} of size {x.shape[dim]} does not divide over "
                                 f"{ax!r} ({n})")
            w = x.shape[dim] // n
            x = x.narrow(dim, i * w, w)
        return x


def data_sharding(mesh, data_axis: str = "dp") -> NamedSharding:
    """Batch-dim sharding for inputs."""
    return NamedSharding(mesh, P(data_axis))


# --------------------------------------------------------------------------
# rank-local modules
# --------------------------------------------------------------------------


@dataclasses.dataclass(eq=False)
class TPShard:
    """A module's tensor-parallel role on this rank (``module.tp_shard``).

    ``role``: "col" (local outputs), "gather" (outputs all-gathered),
    "row" (partial products all-reduced; ``input_sharded`` False: the input
    arrives whole and is sliced after its casts) or "vocab" (an embedding's
    rows ``[start, start + n)``)."""

    role: str
    group: Any
    rank: int
    size: int
    input_sharded: bool = True
    start: int = 0

    def enter(self, x: torch.Tensor) -> torch.Tensor:
        """A linear's input: a replicated one into a column-parallel
        product (its gradient summed over the group); a whole one into a
        row-parallel product sliced to this rank's columns (its gradient
        summed likewise: each rank's holds only its own columns')."""
        if self.role == "row":
            if self.input_sharded:
                return x
            w = x.shape[-1] // self.size
            return comm.copy_to_group(x, self.group).narrow(-1, self.rank * w, w)
        return comm.copy_to_group(x, self.group)

    def partial_sum(self, out: torch.Tensor) -> torch.Tensor:
        return comm.all_reduce(out, self.group) if self.role == "row" else out

    def finish(self, out: torch.Tensor) -> torch.Tensor:
        return comm.all_gather(out, self.group, dim=-1) if self.role == "gather" else out

    def lookup(self, weight: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
        """Rows ``idx`` of a vocabulary-sharded table: this rank's rows,
        zeros for the others', summed over the group."""
        n = weight.shape[0]
        local = idx - self.start
        mine = (local >= 0) & (local < n)
        rows = weight[local.clamp(0, n - 1)]
        rows = torch.where(mine[..., None], rows, torch.zeros((), dtype=rows.dtype,
                                                               device=rows.device))
        return comm.all_reduce(rows, self.group)

    def gatherer(self, dim: int):
        """What an observer of a rank-local activation sees: the activation
        gathered over the group along ``dim`` (a whole-tensor statistic)."""
        return lambda x: comm.all_gather(x, self.group, dim=dim)


class _RowLinear(nn.Linear):
    """A raw row-parallel Linear: partial product, all-reduce, then bias."""

    def forward(self, x):
        tp = self.tp_shard
        out = tp.partial_sum(F.linear(tp.enter(x), self.weight))
        return out if self.bias is None else out + self.bias


class _ColLinear(nn.Linear):
    """A raw column-parallel Linear (local or gathered outputs)."""

    def forward(self, x):
        tp = self.tp_shard
        return tp.finish(F.linear(tp.enter(x), self.weight, self.bias))


class _VocabEmbedding(nn.Embedding):
    """A raw vocabulary-parallel embedding."""

    def forward(self, idx):
        return self.tp_shard.lookup(self.weight, idx)


def _tied_class():
    from ..rawnn import TiedLinear

    class _GatherTiedLinear(TiedLinear):
        """A raw tied head over a vocabulary-sharded table: local logits,
        all-gathered."""

        def forward(self, x):
            tp = self.tp_shard
            return tp.finish(tp.enter(x) @ self.embed_ref.weight.T.to(x.dtype))

    return _GatherTiedLinear


_COVERED = {"opt", "gpt2", "clip", "shared", "positions"}


def _family_check(module: nn.Module) -> None:
    """ValueError for a model of a family ``shard_state`` does not cover."""
    for name, m in module.named_modules():
        parts = type(m).__module__.split(".")
        if len(parts) >= 3 and parts[0] == "dmx_compressor_tpu_torch" and parts[1] == "models":
            if parts[2] not in _COVERED:
                raise ValueError(
                    f"shard_state: the {parts[2]} family ({type(m).__name__} at "
                    f"{name or 'the root'}) is not covered by the port's tensor parallelism "
                    "yet (OPT, GPT-2 and CLIP are)")


def _cast_local_ok(cast, width: int) -> Optional[str]:
    """Why ``cast`` is not exact on a rank-local activation of ``width``
    features along its last dim (None: it is)."""
    from ..numerics.format import FixedPoint, FloatingPoint, Same

    if cast is None:
        return None
    fmt = cast.format
    if cast.pre_transform:
        return "a pre-transform"
    if any(b.numel() > 1 for b in (cast.scale, cast.zero_point)):
        return "per-channel quantizer state"
    if isinstance(fmt, (Same, FixedPoint, FloatingPoint)) or not cast.fake_quant_enabled:
        return None  # elementwise
    block = getattr(fmt, "block_size", None)
    if block == 1:
        return None  # a block of one element: elementwise
    if block is None:
        return f"format {fmt!r}"
    if cast.block_dim != -1:
        return f"blocks along dim {cast.block_dim}"
    if width % block:
        return f"blocks of {block} over {width} local features"
    return None


def _observe_whole(casts, tp: TPShard, dim: int = -1) -> None:
    """The casts of rank-local tensors observe them gathered over the group
    along ``dim``."""
    from ..numerics.cast import CastTo

    for c in casts:
        for m in (c.modules() if c is not None else ()):
            if isinstance(m, CastTo):
                m.tp_gather = tp.gatherer(dim)


class _Sharder:
    """Slices the model's tensors to this rank and sets the modules' roles."""

    def __init__(self, module, mesh, rules, warn):
        self.module, self.mesh, self.rules, self.warn = module, mesh, rules, warn
        names = mesh.mesh_dim_names or ()
        if mesh.get_coordinate() is None:
            raise ValueError("shard_state: this rank is not in the mesh")
        self.tp = axis_size(mesh, "tp")
        self.group = mesh.get_group("tp") if "tp" in names else None
        self.rank = mesh.get_coordinate()[names.index("tp")] if "tp" in names else 0
        self.keys: Dict[int, List[str]] = {}
        for k, v in module.state_dict(keep_vars=True).items():
            self.keys.setdefault(id(v), []).append(k)
        self.prefix = {id(m): n for n, m in module.named_modules(remove_duplicate=False)}
        self.placement: Dict[str, P] = {}
        self.done = set()

    # ---- tensors
    def spec(self, key: str, ndim: int) -> P:
        s = list(spec_for_path(key, self.rules))[:ndim]
        return P(*(s + [None] * (ndim - len(s))))

    def key_of(self, mod, attr) -> str:
        p = self.prefix[id(mod)]
        return f"{p}.{attr}" if p else attr

    def wants(self, mod, attr, dim) -> bool:
        """The rules shard ``mod.attr`` along ``dim`` over the tp axis."""
        t = getattr(mod, attr, None)
        if t is None:
            return False
        return self.spec(self.key_of(mod, attr), t.ndim)[dim] == "tp"

    def slice(self, mod, attr, dim, thirds: bool = False) -> None:
        t = getattr(mod, attr, None)
        if t is None or t.ndim == 0 or id(t) in self.done:
            return
        n = t.shape[dim]
        if thirds:
            if n % (3 * self.tp):
                raise ValueError(f"{self.key_of(mod, attr)}: {n} does not split into 3 x "
                                 f"{self.tp}")
            w = n // (3 * self.tp)
            idx = torch.cat([torch.arange(j * n // 3 + self.rank * w,
                                          j * n // 3 + (self.rank + 1) * w) for j in range(3)])
            local = t.detach().index_select(dim, idx.to(t.device))
        else:
            if n % self.tp:
                raise ValueError(f"{self.key_of(mod, attr)}: {n} does not divide over "
                                 f"'tp' ({self.tp})")
            w = n // self.tp
            local = t.detach().narrow(dim, self.rank * w, w)
        self._assign(t, local.contiguous())
        spec = [None] * t.ndim
        spec[dim] = "tp"
        for k in self.keys.get(id(t), [self.key_of(mod, attr)]):
            self.placement[k] = P(*spec)

    def _assign(self, t, local) -> None:
        t.data = local  # in place: a tied Parameter stays shared
        self.done.add(id(t))

    def fallback(self, what: str, dim: int, size: int) -> None:
        if self.warn and size != 1:
            log.warning("sharding fallback: %s dim %d (size %d) does not divide mesh axis %r "
                        "(%d) — replicating that dim", what, dim, size, "tp", self.tp)

    # ---- roles
    def set_role(self, mod, role, **kw) -> TPShard:
        tp = TPShard(role, self.group, self.rank, self.tp, **kw)
        mod.tp_shard = tp
        if type(mod) is nn.Linear:
            mod.__class__ = _RowLinear if role == "row" else _ColLinear
        elif type(mod) is nn.Embedding:
            mod.__class__ = _VocabEmbedding
        elif type(mod).__name__ == "TiedLinear" and not hasattr(mod, "weight"):
            mod.__class__ = _tied_class()
        return tp

    def col(self, mod, role="col", thirds=False) -> None:
        from ..nn.core import DmxModule

        for attr in ("weight", "weight_mantissa", "weight_exponent", "weight_nibbles",
                     "weight_block_scale"):
            self.slice(mod, attr, 0, thirds)
        self.slice(mod, "bias", 0, thirds)
        if isinstance(mod, DmxModule):
            for cast in (mod.weight_cast, mod.weight_storage_cast):
                if cast is None:
                    continue
                for attr in ("scale", "zero_point"):
                    t = getattr(cast, attr)
                    if t.numel() > 1:
                        self.slice(cast, attr, 0, thirds)
            tp = TPShard(role, self.group, self.rank, self.tp)
            if role == "col":  # a gathering linear casts its whole output
                width = mod.out_features // self.tp
                oc = mod.output_casts[mod.output_cast_names[0]]
                why = _cast_local_ok(oc, width) or _cast_local_ok(mod.bias_cast, width)
                if why:
                    raise ValueError(f"shard_state: {self.key_of(mod, 'output_casts')} has {why}")
                _observe_whole([c for _, c in mod.output_casts.items()], tp)
            _observe_whole([mod.bias_cast, mod.weight_cast, mod.weight_storage_cast], tp, 0)
        if hasattr(mod, "out_features"):
            mod.out_features //= self.tp
        self.set_role(mod, role)

    def row(self, mod, input_sharded=True) -> None:
        from ..nn.core import DmxModule

        in_f = getattr(mod, "in_features", None) or mod.weight.shape[1]
        width = in_f // self.tp
        if isinstance(mod, DmxModule):
            # the packed payload's blocks and the weight casts' run along K
            blocks = [getattr(mod, "block_size", None)] + [
                getattr(c.format, "block_size", None)
                for c in (mod.weight_cast, mod.weight_storage_cast) if c is not None]
            for b in blocks:
                if b and b > 1 and width % b:
                    raise ValueError(f"shard_state: {self.key_of(mod, 'weight')}: {in_f} input "
                                     f"features over tp {self.tp} cut blocks of {b}")
            why = input_sharded and _cast_local_ok(mod.input_casts[mod.input_cast_names[0]],
                                                   width)
            if why:
                raise ValueError(f"shard_state: {self.key_of(mod, 'input_casts')} has {why}")
            sq = mod.smoothquant
            if sq is not None and any(getattr(sq, b).numel() for b in ("scale", "a_maxabs",
                                                                        "b_maxabs")):
                raise ValueError(f"shard_state: {self.key_of(mod, 'smoothquant')} holds "
                                 "per-input-channel state")
        for attr in ("weight", "weight_mantissa", "weight_nibbles"):
            self.slice(mod, attr, 1)
        for attr in ("weight_exponent", "weight_block_scale"):
            self.slice(mod, attr, 1)
        if isinstance(mod, DmxModule):
            tp = TPShard("row", self.group, self.rank, self.tp)
            if input_sharded:
                _observe_whole([c for _, c in mod.input_casts.items()], tp)
            _observe_whole([mod.weight_cast, mod.weight_storage_cast], tp)
        if hasattr(mod, "in_features"):
            mod.in_features = width
        self.set_role(mod, "row", input_sharded=input_sharded)

    def replicate(self, *mods) -> None:
        for m in mods:
            if m is not None:
                self.done.update(id(t) for t in m.state_dict(keep_vars=True).values())


def _weight_attr(m) -> Optional[str]:
    """The name of a linear's weight tensor (plain, or a packed payload)."""
    return next((a for a in ("weight", "weight_mantissa", "weight_nibbles")
                 if isinstance(getattr(m, a, None), torch.Tensor)), None)


def _linear_out(m) -> int:
    return getattr(m, "out_features", None) or m.weight.shape[0]


def _attention_unit(s: _Sharder, attn, name: str) -> None:
    gpt2 = hasattr(attn, "c_attn")
    if gpt2:
        cols, row = [attn.c_attn], attn.c_proj
    else:
        cols = [attn.q_proj, attn.k_proj, attn.v_proj]
        if getattr(attn, "qkv_merged", None) is not None:
            cols.append(attn.qkv_merged)
        row = attn.out_proj
    if not any(s.wants(m, _weight_attr(m), 0) for m in cols if _weight_attr(m)):
        s.replicate(attn)
        return
    if attn.num_heads % s.tp:
        raise ValueError(f"shard_state: {name} has {attn.num_heads} heads, which do not "
                         f"divide tp {s.tp} (the port cannot split a head)")
    for m in cols:
        s.col(m, thirds=gpt2 or m is getattr(attn, "qkv_merged", None))
    s.row(row)
    attn.num_heads //= s.tp
    sdpa = getattr(attn, "sdpa", None)
    if sdpa is not None:
        from ..numerics.cast import CastTo

        for cname, cast in sdpa.named_modules():
            if isinstance(cast, CastTo) and any(b.numel() > 1 for b in (cast.scale,
                                                                         cast.zero_point)):
                raise ValueError(f"shard_state: {name}.sdpa.{cname} has per-channel "
                                 "quantizer state")
        _observe_whole([sdpa], TPShard("col", s.group, s.rank, s.tp), 1)


def _mlp_unit(s: _Sharder, col, row, act, name: str) -> None:
    attr = _weight_attr(col)
    if attr is None or not s.wants(col, attr, 0):
        s.replicate(col, row, act)
        return
    width = _linear_out(col)
    if width % s.tp:
        s.fallback(f"{name} (MLP width)", 0, width)
        s.replicate(col, row, act)
        return
    if act is not None:
        from ..nn.core import DmxModule

        if isinstance(act, DmxModule):
            for cast in [c for casts in (act.input_casts, act.output_casts)
                         for _, c in casts.items()]:
                why = _cast_local_ok(cast, width // s.tp)
                if why:
                    raise ValueError(f"shard_state: {name}'s activation has {why}")
            _observe_whole([act], TPShard("col", s.group, s.rank, s.tp))
    s.col(col)
    s.row(row)


def _vocab_unit(s: _Sharder, embed, heads, name: str) -> None:
    V = embed.weight.shape[0]
    if not s.wants(embed, "weight", 0):
        s.replicate(embed, *heads)
        return
    if V % s.tp or any(_linear_out(h) % s.tp for h in heads if _weight_attr(h)):
        s.fallback(f"{name}.weight (vocabulary)", 0, V)
        s.replicate(embed, *heads)
        return
    s.slice(embed, "weight", 0)
    s.set_role(embed, "vocab", start=s.rank * (V // s.tp))
    for h in heads:
        if getattr(h, "embed_ref", None) is embed or getattr(h, "weight", None) is embed.weight:
            # tied: the table is sliced already
            if hasattr(h, "out_features"):
                h.out_features //= s.tp
            s.set_role(h, "gather")
            for k in s.keys.get(id(embed.weight), []):
                s.placement[k] = P("tp", None)
        else:
            s.col(h, role="gather")


def shard_state(model, mesh, rules=TRANSFORMER_RULES, data_axis: str = "dp",
                warn_on_fallback: bool = True) -> Dict[str, P]:
    """Make ``model`` rank-local in place over ``mesh``'s "tp" axis (see
    the module docstring) and return the placement of every state-dict key
    (its spec, P() where replicated).  The model's parameters are
    replicated over ``data_axis``: feed each rank its share of a batch
    (``distributed.host_local_batch``)."""
    from ..models import clip as clip_m
    from ..models import gpt2 as gpt2_m
    from ..models import opt as opt_m

    module = getattr(model, "module", model)
    if not isinstance(module, nn.Module):
        raise TypeError("shard_state takes a torch module or a DmxModel")
    if getattr(module, "tp_placement", None) is not None:
        raise ValueError("shard_state: the model is sharded already")
    _family_check(module)
    s = _Sharder(module, mesh, rules, warn_on_fallback)
    if s.group is not None:  # tp 1 too: the same modules and collectives, over one rank
        embeds = {}
        for name, m in module.named_modules():
            if isinstance(m, (opt_m.OPTAttention, gpt2_m.GPT2Attention, clip_m.CLIPAttention)):
                _attention_unit(s, m, name)
            elif isinstance(m, opt_m.OPTDecoderLayer):
                _mlp_unit(s, m.fc1, m.fc2, m.activation_fn, name)
            elif isinstance(m, (clip_m.CLIPMLP, gpt2_m.GPT2MLP)):
                col = m.fc1 if hasattr(m, "fc1") else m.c_fc
                row = m.fc2 if hasattr(m, "fc2") else m.c_proj
                act = m.activation_fn if hasattr(m, "activation_fn") else m.act
                _mlp_unit(s, col, row, act, name)
            elif isinstance(m, nn.Embedding) or type(m).__name__ == "Embedding":
                embeds[name] = m
        heads = [m for n, m in module.named_modules() if n.rsplit(".", 1)[-1] == "lm_head"]
        for name, embed in embeds.items():
            if id(embed.weight) in s.done:
                continue
            tied = [h for h in heads if getattr(h, "embed_ref", None) is embed
                    or getattr(h, "weight", None) is embed.weight
                    or _weight_attr(h) in ("weight_mantissa", "weight_nibbles")]
            _vocab_unit(s, embed, tied if name.endswith(("embed_tokens", "wte")) else [], name)
        # the remaining sharded Linears (CLIP's projections, a bare Linear):
        # standalone, so column outputs are gathered and row inputs sliced
        for name, m in module.named_modules():
            attr = _weight_attr(m)
            if attr is None or not hasattr(m, "in_features"):
                continue
            w = getattr(m, attr)
            if id(w) in s.done or getattr(m, "tp_shard", None) is not None:
                continue
            spec = s.spec(s.key_of(m, attr), w.ndim)
            dim = next((i for i, ax in enumerate(spec) if ax == "tp"), None)
            if dim is None:
                continue
            if w.shape[dim] % s.tp:
                s.fallback(s.key_of(m, attr), dim, w.shape[dim])
                s.replicate(m)
            elif dim == 0:
                s.col(m, role="gather")
            else:
                s.row(m, input_sharded=False)
    placement = {k: s.placement.get(k, P()) for k in module.state_dict().keys()}
    module.tp_placement = placement
    module.tp_mesh = mesh
    return placement
