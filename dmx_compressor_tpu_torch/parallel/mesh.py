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

- a column-parallel linear (``q_proj`` ... ``fc1``, ``gate_proj``,
  ``c_attn``, ``c_fc``) keeps its rows of the weight (its output features)
  and returns its local outputs; a merged projection is cut part by part:
  ``qkv_merged`` and GPT-2's ``c_attn`` by heads in each of q, k and v,
  ``gateup_merged`` in each half;
- a row-parallel linear (``out_proj``, ``o_proj``, ``fc2``, ``down_proj``,
  ``c_proj``) keeps its columns, all-reduces its partial products, and only
  then adds its bias and applies its accumulator and output casts (once,
  on the sum);
- the vocabulary-sharded embedding looks up its own rows (the others
  masked to zero) and all-reduces; a tied LM head and CLIP's two output
  projections all-gather their outputs;
- each attention module's head counts become the local ones, so the
  caches that ``init_cache`` makes are ``[B, Hkv / tp, S, D]``.  A rank
  keeps query heads ``[r H / tp, (r + 1) H / tp)``; its KV heads are sliced
  where they divide over tp, and else (``tp % Hkv == 0``, MQA) it keeps the
  KV heads its query heads read, replicated over the ranks that share them
  (Megatron's rule; JAX cuts ``k_proj``'s out dim through the head and
  GSPMD re-lays it, to the same values).

The units are the attention (q/k/v, the SDPA, the output projection; Llama
and its Qwen3, Gemma and Mistral subclasses, Whisper's self- and
cross-attention, OPT, GPT-2, CLIP) and the MLP (its column linears, the
activations between them, its row linear; LeNet-5's fc1, relu3, fc2).
``torch.distributed.device_mesh.DeviceMesh`` is the counterpart of
``jax.sharding.Mesh``: :func:`make_mesh` builds one over the default
process group, and each axis's process group carries the collectives.

The rules are JAX's, written over the port's ``state_dict`` keys (no
``.value`` suffix; packed payloads ``weight_mantissa`` /
``weight_exponent``, ``weight_nibbles`` / ``weight_block_scale``); a table
shared by several modules is placed by its canonical key, the first path
``nnx.split`` gives it (:func:`canonical_key`).  So T5's linears, which
JAX's vocabularies do not name, stay replicated, and its shared table is
sharded as ``decoder.embed_tokens``.  A unit is cut only where every value
stays exact: a BFP block must stay whole on a shard (a row-parallel linear
needs ``in / tp`` to be a multiple of each block along its input features,
as JAX's docstring states), a cast on a rank-local activation must be
elementwise or whole-blocked there and hold no per-channel state, a
row-parallel linear holds no SmoothQuant state, and the heads must divide
over tp (query heads) and divide or be divided by it (KV heads).  A unit
that fails one stays replicated on every rank and is logged, as is a
dimension that does not divide its axis elsewhere (the vocabulary, an MLP
width, a projection), as JAX logs its fallback; JAX's GSPMD computes all of
these, and so does the port.  An observer on a rank-local activation sees
it gathered over the group (a whole-tensor statistic).

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
           "canonical_key", "data_sharding", "NamedSharding", "TPShard", "TRANSFORMER_RULES"]


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
# the port's merged column projections (JAX's rules name neither)
_MERGED = r"qkv_merged|gateup_merged"

# (key regex, spec) over the port's state-dict keys; first match wins.  JAX's
# table with the port's names; the port adds the merged projections
# (``qkv_merged`` by heads, ``gateup_merged`` by halves: column parallel,
# as ``c_attn``), which JAX leaves replicated because GSPMD re-lays the
# merged output out itself.
TRANSFORMER_RULES: Tuple[Tuple[str, P], ...] = (
    # column parallel (shard out over tp)
    (rf".*({_COL}|{_MERGED})\.({_W})$", P("tp", None)),
    (rf".*({_COL}|{_MERGED})\.bias$", P("tp")),
    # per-out-channel quantizer state on column-parallel weight casts shards
    # with the out dim; input-cast state follows the (unsharded) in dim
    (rf".*({_COL}|{_MERGED})\.(weight_cast|weight_storage_cast)\.(scale|zero_point)$",
     P("tp")),
    (rf".*({_COL}|{_MERGED}).*(scale|zero_point)$", P()),
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
    col_re, row_re = re.compile(rf"({_COL}|{_MERGED})$"), re.compile(rf"({_ROW})$")
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

    def gatherer(self, dim: int, parts: Optional[Sequence[Tuple[int, int]]] = None):
        """What an observer of a rank-local activation sees: the activation
        gathered over the group along ``dim`` (a whole-tensor statistic).
        With ``parts`` (each a local width and its blocks, as
        ``_Sharder.slice`` cuts them), each part's distinct blocks once: a
        replicated KV head is not counted once per rank."""
        if not parts or all(heads % self.size == 0 for _, heads in parts):
            return lambda x: comm.all_gather(x, self.group, dim=dim)

        def gather(x):
            ranks = comm.all_gather(x, self.group, dim=dim).chunk(self.size, dim)
            out, off = [], 0
            for w, heads in parts:
                seen = set()
                for r, t in enumerate(ranks):
                    block = r if heads % self.size == 0 else r * heads // self.size
                    if block not in seen:
                        seen.add(block)
                        out.append(t.narrow(dim, off, w))
                off += w
            return torch.cat(out, dim)

        return gather


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


def canonical_key(keys: Sequence[str]) -> str:
    """The one of a shared tensor's state-dict keys that JAX's rules place
    it by: the first path ``nnx.split`` gives the shared Variable, a walk of
    the module tree in sorted attribute order (T5's table is
    ``decoder.embed_tokens``, a head that holds its table ``lm_head``)."""
    return min(keys, key=lambda k: [(0, int(p), "") if p.isdigit() else (1, 0, p)
                                    for p in k.split(".")])


def _cast_local_ok(cast, widths: Sequence[int]) -> Optional[str]:
    """Why ``cast`` is not exact on a rank-local activation whose last dim
    is cut at ``widths`` (its local parts' widths and the parts' whole
    widths; None: it is)."""
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
    cut = [w for w in widths if w % block]
    return f"blocks of {block} over {cut[0]} local features" if cut else None


def _observe_whole(casts, gather) -> None:
    """The casts of rank-local tensors observe them as ``gather`` gives
    them whole."""
    from ..numerics.cast import CastTo

    for c in casts:
        for m in (c.modules() if c is not None else ()):
            if isinstance(m, CastTo):
                m.tp_gather = gather


_WEIGHTS = ("weight", "weight_mantissa", "weight_exponent", "weight_nibbles",
            "weight_block_scale")
# an MLP's modules between its column and its row linear
_ACTS = ("activation_fn", "act", "act_fn", "mul", "relu3")


class _Sharder:
    """Slices the model's tensors to this rank and sets the modules' roles.

    A column-parallel tensor is cut along its out dim in parts: ``(rows,
    heads)`` runs of rows, each in ``heads`` equal blocks (a merged q/k/v's
    q, k and v; a merged gate/up's halves).  A rank keeps its 1/tp of a part
    whose blocks divide over tp, and else the one block its ranks share
    (``tp % heads == 0``: Megatron's replicated KV heads)."""

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
        """The key JAX's rules place ``mod.attr`` by (a shared tensor's
        canonical one)."""
        t = getattr(mod, attr, None)
        if isinstance(t, torch.Tensor) and id(t) in self.keys:
            return canonical_key(self.keys[id(t)])
        p = self.prefix[id(mod)]
        return f"{p}.{attr}" if p else attr

    def wants(self, mod, attr, dim) -> bool:
        """The rules shard ``mod.attr`` along ``dim`` over the tp axis."""
        t = getattr(mod, attr, None)
        if t is None:
            return False
        return self.spec(self.key_of(mod, attr), t.ndim)[dim] == "tp"

    def local_rows(self, rows: int, heads: int) -> Tuple[int, int]:
        """This rank's (start, width) in a part of ``rows`` in ``heads``
        blocks."""
        if heads % self.tp == 0:
            w = rows // self.tp
            return self.rank * w, w
        w = rows // heads
        return self.rank * heads // self.tp * w, w

    def widths(self, parts) -> List[int]:
        """The widths a cast on the parts' local outputs must keep blocks
        whole in: each part's and its local run's."""
        return [w for rows, heads in parts for w in (rows, self.local_rows(rows, heads)[1])]

    def slice(self, mod, attr, dim, parts=None) -> None:
        t = getattr(mod, attr, None)
        if t is None or t.ndim == 0 or id(t) in self.done:
            return
        parts = parts or [(t.shape[dim], self.tp)]
        if sum(rows for rows, _ in parts) != t.shape[dim] or any(
                rows % heads or (heads % self.tp and self.tp % heads) for rows, heads in parts):
            raise ValueError(f"{self.key_of(mod, attr)}: {t.shape[dim]} rows do not cut into "
                             f"{parts} over 'tp' ({self.tp})")
        idx, off = [], 0
        for rows, heads in parts:
            start, w = self.local_rows(rows, heads)
            idx.append(torch.arange(off + start, off + start + w))
            off += rows
        self._assign(t, t.detach().index_select(dim, torch.cat(idx).to(t.device)).contiguous())
        # sharded where the ranks' rows differ: a part sliced over tp, or one
        # of several blocks that ranks hold in turns (1 < heads < tp); only a
        # part of one block on every rank is the same everywhere
        spec = [None] * t.ndim
        spec[dim] = "tp"
        whole = P(*spec) if any(heads % self.tp == 0 or heads > 1 for _, heads in parts) else P()
        for k in self.keys.get(id(t), [self.key_of(mod, attr)]):
            self.placement[k] = whole

    def _assign(self, t, local) -> None:
        t.data = local  # in place: a tied Parameter stays shared
        self.done.add(id(t))

    def fallback(self, what: str, dim: int, size: int) -> None:
        if self.warn and size != 1:
            log.warning("sharding fallback: %s dim %d (size %d) does not divide mesh axis %r "
                        "(%d) — replicating that dim", what, dim, size, "tp", self.tp)

    def unit(self, name: str, problems, *mods) -> bool:
        """True where no problem stands in the unit's way; else its modules
        stay whole on every rank, and the first problem is logged."""
        why = next((w for w in problems if w), None)
        if why is None:
            return True
        if self.warn:
            log.warning("sharding fallback: %s replicated over mesh axis %r (%d): %s",
                        name or type(self.module).__name__, "tp", self.tp, why)
        self.replicate(*mods)
        return False

    # ---- problems: why a module cannot be cut exactly
    def col_problem(self, mod, parts) -> Optional[str]:
        """A column-parallel linear's local outputs are cast there."""
        from ..nn.core import DmxModule

        if not isinstance(mod, DmxModule):
            return None
        widths = self.widths(parts)
        why = (_cast_local_ok(mod.output_casts[mod.output_cast_names[0]], widths)
               or _cast_local_ok(mod.bias_cast, widths))
        return why and f"{self.key_of(mod, 'output_casts')} has {why}"

    def row_problem(self, mod, input_sharded=True) -> Optional[str]:
        """A row-parallel linear's blocks along K, its input cast on the
        local input, its SmoothQuant state per input channel."""
        from ..nn.core import DmxModule

        if not isinstance(mod, DmxModule):
            return None
        in_f = mod.in_features
        width = in_f // self.tp
        # the packed payload's blocks and the weight casts' run along K
        blocks = [getattr(mod, "block_size", None)] + [
            getattr(c.format, "block_size", None)
            for c in (mod.weight_cast, mod.weight_storage_cast) if c is not None]
        for b in blocks:
            if b and b > 1 and width % b:
                return (f"{self.key_of(mod, 'weight')}: {in_f} input features over tp "
                        f"{self.tp} cut blocks of {b}")
        why = input_sharded and _cast_local_ok(mod.input_casts[mod.input_cast_names[0]],
                                               [width])
        if why:
            return f"{self.key_of(mod, 'input_casts')} has {why}"
        sq = mod.smoothquant
        if sq is not None and any(getattr(sq, b).numel() for b in ("scale", "a_maxabs",
                                                                    "b_maxabs")):
            return f"{self.key_of(mod, 'smoothquant')} holds per-input-channel state"
        return None

    def act_problem(self, act, width: int) -> Optional[str]:
        from ..nn.core import DmxModule

        if not isinstance(act, DmxModule):
            return None
        for cast in [c for casts in (act.input_casts, act.output_casts) for _, c in casts.items()]:
            why = _cast_local_ok(cast, [width])
            if why:
                return f"{self.prefix[id(act)]} has {why}"
        return None

    def sdpa_problem(self, attn, name: str) -> Optional[str]:
        from ..numerics.cast import CastTo

        for cname, cast in (attn.sdpa.named_modules() if hasattr(attn, "sdpa") else ()):
            if isinstance(cast, CastTo) and any(b.numel() > 1 for b in (cast.scale,
                                                                        cast.zero_point)):
                return f"{name}.sdpa.{cname} has per-channel quantizer state"
        return None

    # ---- roles
    def tp_shard(self, role, **kw) -> TPShard:
        return TPShard(role, self.group, self.rank, self.tp, **kw)

    def set_role(self, mod, role, **kw) -> TPShard:
        tp = self.tp_shard(role, **kw)
        mod.tp_shard = tp
        if type(mod) is nn.Linear:
            mod.__class__ = _RowLinear if role == "row" else _ColLinear
        elif type(mod) is nn.Embedding:
            mod.__class__ = _VocabEmbedding
        elif type(mod).__name__ == "TiedLinear" and not hasattr(mod, "weight"):
            mod.__class__ = _tied_class()
        return tp

    def col(self, mod, role="col", parts=None) -> None:
        from ..nn.core import DmxModule

        parts = parts or [(_linear_out(mod), self.tp)]
        for attr in _WEIGHTS + ("bias",):
            self.slice(mod, attr, 0, parts)
        if isinstance(mod, DmxModule):
            for cast in (mod.weight_cast, mod.weight_storage_cast):
                for attr in (("scale", "zero_point") if cast is not None else ()):
                    if getattr(cast, attr).numel() > 1:
                        self.slice(cast, attr, 0, parts)
            tp = self.tp_shard(role)
            if role == "col":  # a gathering linear casts its whole output
                _observe_whole([c for _, c in mod.output_casts.items()],
                               tp.gatherer(-1, self.local_parts(parts)))
            _observe_whole([mod.bias_cast, mod.weight_cast, mod.weight_storage_cast],
                           tp.gatherer(0, self.local_parts(parts)))
        if hasattr(mod, "out_features"):
            mod.out_features = sum(self.local_rows(rows, heads)[1] for rows, heads in parts)
        self.set_role(mod, role)

    def local_parts(self, parts) -> List[Tuple[int, int]]:
        return [(self.local_rows(rows, heads)[1], heads) for rows, heads in parts]

    def row(self, mod, input_sharded=True) -> None:
        from ..nn.core import DmxModule

        in_f = getattr(mod, "in_features", None) or mod.weight.shape[1]
        for attr in _WEIGHTS:
            self.slice(mod, attr, 1)
        if isinstance(mod, DmxModule):
            tp = self.tp_shard("row")
            if input_sharded:
                _observe_whole([c for _, c in mod.input_casts.items()], tp.gatherer(-1))
            _observe_whole([mod.weight_cast, mod.weight_storage_cast], tp.gatherer(-1))
        if hasattr(mod, "in_features"):
            mod.in_features = in_f // self.tp
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


def _is_attention(m) -> bool:
    return hasattr(m, "num_heads") and hasattr(m, "head_dim") and (
        hasattr(m, "c_attn") or hasattr(m, "q_proj"))


def _is_mlp(m) -> bool:
    return any(hasattr(m, a) and hasattr(m, b)
               for a, b in (("fc1", "fc2"), ("c_fc", "c_proj"), ("gate_proj", "down_proj")))


def _attention_unit(s: _Sharder, attn, name: str) -> None:
    """Query heads over tp; the KV heads sliced where they divide over tp,
    else the ones a rank's query heads read (tp % Hkv == 0), else the unit
    stays replicated."""
    H, D = attn.num_heads, attn.head_dim
    Hkv = getattr(attn, "num_kv_heads", H)
    if hasattr(attn, "c_attn"):  # GPT-2: q, k and v born merged
        cols, row = [(attn.c_attn, [(H * D, H)] * 3)], attn.c_proj
    else:
        q, kv = (H * D, H), (Hkv * D, Hkv)
        cols = [(attn.q_proj, [q]), (attn.k_proj, [kv]), (attn.v_proj, [kv])]
        if getattr(attn, "qkv_merged", None) is not None:
            cols.append((attn.qkv_merged, [q, kv, kv]))
        row = attn.o_proj if hasattr(attn, "o_proj") else attn.out_proj
    if not any(s.wants(m, _weight_attr(m), 0) for m, _ in cols if _weight_attr(m)):
        s.replicate(attn)
        return
    problems = [H % s.tp and f"{H} query heads do not divide over tp {s.tp}",
                Hkv % s.tp and s.tp % Hkv and (f"{Hkv} KV heads neither divide over tp "
                                               f"{s.tp} nor divide it")]
    if not any(problems):
        problems = ([s.col_problem(m, parts) for m, parts in cols]
                    + [s.row_problem(row), s.sdpa_problem(attn, name)])
    if not s.unit(name, problems, attn):
        return
    for m, parts in cols:
        s.col(m, parts=parts)
    s.row(row)
    attn.num_heads = H // s.tp
    if hasattr(attn, "num_kv_heads"):
        attn.num_kv_heads = s.local_rows(Hkv * D, Hkv)[1] // D
    # the ops on local heads observe every head: [B, H, T, D] and, before
    # the transpose, [B, T, H, D]
    tp = s.tp_shard("col")
    _observe_whole([getattr(attn, a, None) for a in ("sdpa", "apply_rope")], tp.gatherer(1))
    _observe_whole([getattr(attn, a, None) for a in ("q_norm", "k_norm")], tp.gatherer(-2))


def _mlp_unit(s: _Sharder, owner, name: str) -> None:
    """The column linears' outputs over tp (gate and up each in halves where
    merged), the activations on the local width, the row linear's input."""
    if hasattr(owner, "gate_proj"):
        m = owner.intermediate_size
        cols = [(owner.gate_proj, [(m, s.tp)]), (owner.up_proj, [(m, s.tp)])]
        if getattr(owner, "gateup_merged", None) is not None:
            cols.append((owner.gateup_merged, [(m, s.tp)] * 2))
        row = owner.down_proj
    else:
        col = owner.fc1 if hasattr(owner, "fc1") else owner.c_fc
        row = owner.fc2 if hasattr(owner, "fc2") else owner.c_proj
        m = _linear_out(col)
        cols = [(col, [(m, s.tp)])]
    acts = [getattr(owner, a) for a in _ACTS if getattr(owner, a, None) is not None]
    mods = [c for c, _ in cols] + [row] + acts
    lead = next((c for c, _ in cols if _weight_attr(c)), None)
    if lead is None or not s.wants(lead, _weight_attr(lead), 0):
        s.replicate(*mods)
        return
    if m % s.tp:
        s.fallback(f"{name} (MLP width)", 0, m)
        s.replicate(*mods)
        return
    problems = ([s.col_problem(c, parts) for c, parts in cols] + [s.row_problem(row)]
                + [s.act_problem(a, m // s.tp) for a in acts])
    if not s.unit(name, problems, *mods):
        return
    _observe_whole(acts, s.tp_shard("col").gatherer(-1))
    for c, parts in cols:
        s.col(c, parts=parts)
    s.row(row)
    if hasattr(owner, "intermediate_size"):
        owner.intermediate_size = m // s.tp


def _vocab_unit(s: _Sharder, embeds, heads) -> None:
    """A token table's rows over tp: every embedding reading it looks up
    its own rows, every head tied to it (or packed from it) gathers."""
    embed = embeds[0]
    name = s.key_of(embed, "weight").rsplit(".", 1)[0]
    V = embed.weight.shape[0]
    if not s.wants(embed, "weight", 0):
        s.replicate(*embeds, *heads)
        return
    if V % s.tp or any(_linear_out(h) % s.tp for h in heads if _weight_attr(h)):
        s.fallback(f"{name}.weight (vocabulary)", 0, V)
        s.replicate(*embeds, *heads)
        return
    s.slice(embed, "weight", 0)
    for e in embeds:
        s.set_role(e, "vocab", start=s.rank * (V // s.tp))
    for h in heads:
        if getattr(h, "embed_ref", None) in embeds or getattr(h, "weight", None) is embed.weight:
            # tied: the table is sliced already
            if hasattr(h, "out_features"):
                h.out_features //= s.tp
            s.set_role(h, "gather")
        else:
            s.col(h, role="gather")


def _lm_table(s: _Sharder, embed) -> bool:
    """``embed`` is an LM's token table (its packed head shards with it)."""
    return any(k.rsplit(".", 2)[-2] in ("embed_tokens", "wte")
               for k in s.keys.get(id(embed.weight), ()))


def shard_state(model, mesh, rules=TRANSFORMER_RULES, data_axis: str = "dp",
                warn_on_fallback: bool = True) -> Dict[str, P]:
    """Make ``model`` rank-local in place over ``mesh``'s "tp" axis (see
    the module docstring) and return the placement of every state-dict key
    (its spec, P() where replicated).  The model's parameters are
    replicated over ``data_axis``: feed each rank its share of a batch
    (``distributed.host_local_batch``).  A unit that cannot be cut exactly
    stays replicated and is logged; a model sharded already, or a rank
    outside the mesh, raises ``ValueError``."""
    module = getattr(model, "module", model)
    if not isinstance(module, nn.Module):
        raise TypeError("shard_state takes a torch module or a DmxModel")
    if getattr(module, "tp_placement", None) is not None:
        raise ValueError("shard_state: the model is sharded already")
    s = _Sharder(module, mesh, rules, warn_on_fallback)
    if s.group is not None:  # tp 1 too: the same modules and collectives, over one rank
        tables: Dict[int, list] = {}  # a table's embeddings (T5's three sites share one)
        for name, m in module.named_modules():
            if _is_attention(m):
                _attention_unit(s, m, name)
            elif _is_mlp(m):
                _mlp_unit(s, m, name)
            elif isinstance(m, nn.Embedding) or type(m).__name__ == "Embedding":
                tables.setdefault(id(m.weight), []).append(m)
        for embeds in tables.values():
            if id(embeds[0].weight) in s.done:
                continue
            heads = [h for h in module.modules() if h not in embeds and (
                getattr(h, "embed_ref", None) in embeds
                or getattr(h, "weight", None) is embeds[0].weight)]
            if _lm_table(s, embeds[0]):
                heads += [h for n, h in module.named_modules() if n.rsplit(".", 1)[-1] == "lm_head"
                          and _weight_attr(h) in ("weight_mantissa", "weight_nibbles")]
            _vocab_unit(s, embeds, heads)
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
            elif s.unit(name, [s.row_problem(m, input_sharded=False)], m):
                s.row(m, input_sharded=False)
    placement = {k: s.placement.get(k, P()) for k in module.state_dict().keys()}
    module.tp_placement = placement
    module.tp_mesh = mesh
    return placement
