"""Core neural building blocks: parameter initialization, the norm and MLP
modules, and the pure functions over them (``repro.models.layers``).

Parameters keep the reference's leaf names and its ``(in, out)`` layout,
used as ``x @ W``. Computation casts each weight to the config's compute
dtype at its use, as the reference casts at every einsum; ``cast`` keeps
the cast copy of a parameter while the parameter is unchanged and no
gradient flows, so serving in bf16 casts each weight once.

The logical-axis sharding rules are the reference's: a parameter's
``PartitionSpec`` comes from its path in the reference's tree (the port's
module path mapped through ``convert.reference_path``):

    vocab axis      -> "model"   (embed / unembed tables)
    heads / d_ff    -> "model"   (column-parallel in, row-parallel out)
    experts' d_ff   -> "model"   (TP-MoE default; EP with ``set_moe_ep``)
    the complement  -> "data"    (FSDP: weights and moments fully sharded)
    batch           -> ("pod", "data")
    everything else -> replicated

The port holds layers one by one where the reference stacks a pattern's
repeats under ``blocks`` (a leading, unsharded axis): a layer's spec is the
reference's without that leading ``None``. ``shardings_for`` places each
block of a parameter on the port's ``launch.mesh.Mesh``; the dry run
(``launch/dryrun.py``) sizes a device's share from them.

One controller drives the port's meshes, with no GSPMD to propagate a
constraint: ``shard_batch``, ``shard_batch_seq`` and
``shard_replicated_model`` return their input, at the reference's call
sites (the dry run's collective count swaps in versions that pin a
DTensor's layout, ``launch/comm_cost.py``). ``set_batch_axes`` records the
data-parallel axes, which the training step reads to split the batch over
the mesh's entries (``launch/train.py``).
"""
from __future__ import annotations

import re
import sys
from typing import Dict, List, Mapping, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .config import ModelConfig

__all__ = ["dtype_of", "cast", "Initializer", "Norm", "MLP", "rms_norm",
           "rope", "gated_mlp", "init_mlp", "init_norm", "cross_entropy_loss",
           "PartitionSpec", "P", "NamedSharding", "set_moe_ep",
           "spec_for_path", "param_specs", "shardings_for",
           "sanitize_pspecs", "placements", "set_batch_axes",
           "get_batch_axes", "shard_batch", "shard_batch_seq",
           "shard_replicated_model", "is_dtensor", "unflatten",
           "merge_last", "lookup", "rejoin", "gathered"]


def dtype_of(name: str) -> torch.dtype:
    return {"float32": torch.float32, "bfloat16": torch.bfloat16,
            "float16": torch.float16}[name]


def cast(w: torch.Tensor, dt: torch.dtype) -> torch.Tensor:
    """``w`` in ``dt``. A parameter's cast copy is made once and reused
    while the parameter keeps its storage and version and no gradient
    flows through it; under autograd every call casts anew."""
    if w.dtype == dt:
        return w
    if not isinstance(w, nn.Parameter) or (w.requires_grad
                                           and torch.is_grad_enabled()):
        return w.to(dt)
    key = (dt, w.data_ptr(), w._version)
    kept = getattr(w, "_cast_copy", None)
    if kept is None or kept[0] != key:
        with torch.no_grad():
            kept = (key, w.detach().to(dt))
        w._cast_copy = kept
    return kept[1]


# ---------------------------------------------------------------------------
# Initialization
# ---------------------------------------------------------------------------

class Initializer:
    """Parameter init from an explicit ``torch.Generator``, with the
    reference's scales: normal scaled by ``1/sqrt(fan_in)`` (``shape[-2]``,
    or ``shape[-1]`` for a vector) unless a scale is given, zeros, ones.
    Values are drawn in float32 on the CPU in the order the model asks for
    them, then cast to the parameter dtype. The reference folds a key from
    each leaf's path instead (through ``hash``, which changes from process
    to process), so neither init reproduces the other: parity tests carry
    the reference's parameters across (``convert.params_from_reference``).
    With ``generator=None`` every tensor is left uninitialized, to be
    loaded."""

    def __init__(self, generator: Optional[torch.Generator],
                 param_dtype: torch.dtype = torch.float32):
        self.generator = generator
        self.dtype = param_dtype

    def normal(self, shape, scale: float = None) -> nn.Parameter:
        if self.generator is None:
            return nn.Parameter(torch.empty(shape, dtype=self.dtype))
        if scale is None:
            scale = 1.0 / np.sqrt(shape[-2] if len(shape) > 1 else shape[-1])
        w = torch.randn(shape, generator=self.generator, dtype=torch.float32)
        return nn.Parameter((w * scale).to(self.dtype))

    def zeros(self, shape) -> nn.Parameter:
        return nn.Parameter(torch.zeros(shape, dtype=self.dtype))

    def ones(self, shape) -> nn.Parameter:
        return nn.Parameter(torch.ones(shape, dtype=self.dtype))


class Norm(nn.Module):
    """An RMS norm's ``scale`` (applied as ``1 + scale``)."""

    def __init__(self, ini: Initializer, d: int):
        super().__init__()
        self.scale = ini.zeros((d,))


class MLP(nn.Module):
    """``w_up``, ``w_down`` and, when gated (SwiGLU), ``w_gate``."""

    def __init__(self, ini: Initializer, d: int, ff: int, gated: bool = True):
        super().__init__()
        self.w_up = ini.normal((d, ff))
        self.w_down = ini.normal((ff, d))
        if gated:
            self.w_gate = ini.normal((d, ff))


def init_mlp(ini: Initializer, d: int, ff: int, gated: bool = True) -> MLP:
    return MLP(ini, d, ff, gated)


def init_norm(ini: Initializer, d: int) -> Norm:
    return Norm(ini, d)


# ---------------------------------------------------------------------------
# Sharding rules
# ---------------------------------------------------------------------------

class PartitionSpec(tuple):
    """A tensor's layout over a mesh, one entry a dimension: an axis name,
    a tuple of axis names (the first most significant), or ``None``
    (replicated); trailing dimensions left out are replicated. The port's
    ``jax.sharding.PartitionSpec``."""

    def __new__(cls, *dims):
        return super().__new__(cls, dims)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


P = PartitionSpec


def _axes(dim) -> Tuple[str, ...]:
    """The mesh axes of one spec entry."""
    if dim is None:
        return ()
    return (dim,) if isinstance(dim, str) else tuple(dim)


def _axis_sizes(mesh) -> Dict[str, int]:
    return dict(zip(mesh.axis_names, mesh.devices.shape))


class NamedSharding:
    """``spec`` placed on ``mesh`` (the port's ``launch.mesh.Mesh``, or
    anything with ``axis_names`` and a ``devices`` array): which entries
    hold which block of a tensor."""

    def __init__(self, mesh, spec: PartitionSpec):
        self.mesh = mesh
        self.spec = PartitionSpec(*spec)

    def _dims(self, ndim: int) -> List[Tuple[str, ...]]:
        dims = list(self.spec) + [None] * (ndim - len(self.spec))
        return [_axes(d) for d in dims[:ndim]]

    def shard_shape(self, shape: Sequence[int]) -> Tuple[int, ...]:
        """The shape of the block one entry holds (each sharded dimension
        divided by its axes' sizes, rounded up)."""
        sizes = _axis_sizes(self.mesh)
        return tuple(-(-int(n) // int(np.prod([sizes[a] for a in axes])))
                     for n, axes in zip(shape, self._dims(len(shape))))

    def blocks(self, shape: Sequence[int]
               ) -> Dict[Tuple[Tuple[int, int], ...], List]:
        """Each block of a tensor of ``shape`` (its ``(start, stop)`` a
        dimension) and the entries that hold it, in the mesh's row-major
        order: an entry holds block ``sum(index(a) * stride(a))`` of a
        dimension over its axes, replicas along the axes the spec leaves
        out."""
        sizes = _axis_sizes(self.mesh)
        dims = self._dims(len(shape))
        block = self.shard_shape(shape)
        out: Dict[Tuple[Tuple[int, int], ...], List] = {}
        for coords in np.ndindex(*self.mesh.devices.shape):
            at = dict(zip(self.mesh.axis_names, coords))
            key = []
            for n, axes, b in zip(shape, dims, block):
                i = 0
                for a in axes:
                    i = i * sizes[a] + at[a]
                key.append((min(i * b, int(n)), min((i + 1) * b, int(n))))
            out.setdefault(tuple(key), []).append(self.mesh.devices[coords])
        return out

    def __repr__(self) -> str:
        return f"NamedSharding({self.spec!r})"


_MOE_EP = False


def set_moe_ep(flag: bool) -> None:
    """Expert parallelism: the experts' own axis on "model" (and their
    d_model on "data") instead of their d_ff. Read by ``param_specs``."""
    global _MOE_EP
    _MOE_EP = bool(flag)


# (regex on the reference's parameter path, spec builder given the
# unstacked ndim), first match wins. FSDP x TP: the tensor-parallel dim
# goes on "model"; the complementary dim is sharded over "data" (ZeRO-3 /
# FSDP: weights, gradients and moments all fully sharded).
_RULES = [
    (r"embed$",          lambda nd: ("model", "data")),
    (r"unembed$",        lambda nd: ("data", "model")),
    (r"(wq|wk|wv|wr|wg)$", lambda nd: ("data", "model")),
    (r"wo$",             lambda nd: ("model", "data")),
    (r"(w_up|w_gate)$",  lambda nd: ("data", "model")),
    (r"w_down$",         lambda nd: ("model", "data")),
    (r"experts_(up|gate)$",
     lambda nd: ("model", "data", None) if _MOE_EP else (None, "data", "model")),
    (r"experts_down$",
     lambda nd: ("model", None, "data") if _MOE_EP else (None, "model", "data")),
    (r"router$",         lambda nd: (None, None)),
    (r"(in_proj|x_proj)$", lambda nd: ("data", "model")),
    (r"(out_proj)$",     lambda nd: ("model", "data")),
    (r"chan_k$",         lambda nd: ("data", "model")),
    (r"chan_v$",         lambda nd: ("model", "data")),
    (r"(time_decay_[ab])$", lambda nd: (None, None)),
    (r"(time_|chan_)\w*$", lambda nd: tuple(None for _ in range(nd))),
]


def spec_for_path(path: str, ndim: int, stacked: bool) -> PartitionSpec:
    """The spec of the reference's leaf at ``path`` ("/blocks/p0/attn/wq")
    of ``ndim`` dimensions, the first of them the repeat axis when
    ``stacked``. (``unembed`` matches ``embed$`` first, as in the
    reference.)"""
    body_nd = ndim - (1 if stacked else 0)
    for pat, fn in _RULES:
        if re.search(pat, path):
            spec = list(fn(body_nd))
            spec = spec[:body_nd] + [None] * (body_nd - len(spec))
            if stacked:
                spec = [None] + spec
            return PartitionSpec(*spec)
    return PartitionSpec(*([None] * ndim))


def _named_shapes(params) -> Tuple[Dict[str, Tuple[int, ...]], int]:
    """``params`` (a model, or a mapping from parameter name to a tensor or
    a shape) as {name: shape}, and the model's pattern length (1 for a
    mapping: a layer's index then names its pattern entry only through
    the leaf, which is all the rules read)."""
    if isinstance(params, nn.Module):
        cfg = getattr(params, "cfg", None)
        return ({n: tuple(p.shape) for n, p in params.named_parameters()},
                len(cfg.pattern) if cfg is not None else 1)
    return ({n: tuple(getattr(v, "shape", v)) for n, v in params.items()}, 1)


def param_specs(params, prefix: str = "", stacked_keys=("blocks",)
                ) -> Dict[str, PartitionSpec]:
    """{parameter name: spec} by the reference's path rules: each of the
    port's parameters gets the reference's spec of its leaf, without the
    repeat axis the reference stacks under ``stacked_keys`` (the port
    holds one tensor a layer)."""
    from .convert import reference_path

    shapes, P_len = _named_shapes(params)
    out = {}
    for name, shape in shapes.items():
        path, stacked = reference_path(name, P_len, stacked_keys)
        spec = spec_for_path(prefix + "/" + "/".join(path),
                             len(shape) + stacked, stacked)
        out[name] = PartitionSpec(*spec[1:]) if stacked else spec
    return out


def shardings_for(params, mesh) -> Dict[str, NamedSharding]:
    """{parameter name: its spec on ``mesh``}."""
    return {n: NamedSharding(mesh, s) for n, s in param_specs(params).items()}


def sanitize_pspecs(pspecs: Mapping[str, PartitionSpec], shapes, mesh
                    ) -> Dict[str, PartitionSpec]:
    """Drop sharding on any dim not divisible by its mesh axes (e.g.
    whisper's 51,865 vocabulary on a 16-way axis), so that rule-generated
    specs stay valid for every architecture. ``shapes``: {name: tensor or
    shape}."""
    sizes = _axis_sizes(mesh)
    out = {}
    for name, spec in pspecs.items():
        shape = tuple(getattr(shapes[name], "shape", shapes[name]))
        dims = list(spec) + [None] * (len(shape) - len(spec))
        fixed = []
        for d, size in zip(dims, shape):
            prod = 1
            for a in _axes(d):
                prod *= sizes.get(a, 1)
            fixed.append(d if (prod > 0 and size % prod == 0) else None)
        out[name] = PartitionSpec(*fixed)
    return out


def placements(spec: PartitionSpec, mesh) -> list:
    """``spec`` (a ``sanitize_pspecs`` entry) as DTensor placements on
    ``mesh`` (the port's ``Mesh`` or a ``DeviceMesh``), one a mesh axis:
    ``Shard(d)`` on each axis that ``spec`` puts on dimension d, else
    ``Replicate()``. DTensor shards a dimension over its mesh axes left to
    right, the first most significant, as ``NamedSharding`` reads a tuple
    entry; an entry whose axes run against the mesh's order, or an axis
    used twice, raises."""
    from torch.distributed.tensor import Replicate, Shard

    names = tuple(getattr(mesh, "axis_names", None)
                  or getattr(mesh, "mesh_dim_names"))
    out = [Replicate() for _ in names]
    seen = set()
    for d, entry in enumerate(spec):
        idx = [names.index(a) for a in _axes(entry)]
        if idx != sorted(idx) or seen & set(idx):
            raise ValueError(f"placements: {spec!r} on mesh axes {names}: "
                             "a dimension's axes out of the mesh's order, "
                             "or an axis used twice")
        seen.update(idx)
        for i in idx:
            out[i] = Shard(d)
    return out


# --- DTensors ----------------------------------------------------------------
# The dry run counts a step's collectives over DTensors on ``meta``
# (``launch/comm_cost.py``, which swaps in its own versions of the
# functions whose DTensor form differs); every other route holds plain
# tensors, on which these are the plain operation. Where DTensor has no
# rule for a view or an index, they make the redistribution explicit, and
# the count includes it.

def is_dtensor(x) -> bool:
    """``x`` is a ``torch.distributed.tensor.DTensor`` (none exists before
    that module is imported)."""
    mod = sys.modules.get("torch.distributed.tensor")
    return mod is not None and isinstance(x, mod.DTensor)


def unflatten(x: torch.Tensor, dim: int, sizes: Sequence[int]
              ) -> torch.Tensor:
    """``x.unflatten(dim, sizes)``. A DTensor is first gathered over the
    mesh axes on ``dim``, from the last, until those left divide
    ``sizes[0]`` (3 heads on a model axis of 2; 16 rows on 256 entries):
    DTensor splits no dimension unevenly."""
    dim = dim % x.ndim
    if is_dtensor(x):
        from torch.distributed.tensor import Replicate

        on = [i for i, p in enumerate(x.placements) if p.is_shard(dim)]
        while on and sizes[0] % int(np.prod([x.device_mesh.size(i)
                                             for i in on])):
            on.pop()
        drop = [i for i, p in enumerate(x.placements)
                if p.is_shard(dim) and i not in on]
        if drop:
            x = x.redistribute(placements=[
                Replicate() if i in drop else p
                for i, p in enumerate(x.placements)])
    return x.unflatten(dim, tuple(sizes))


def merge_last(x: torch.Tensor) -> torch.Tensor:
    """``x`` (..., H, hd) as (..., H hd). A DTensor sharded over hd is
    gathered first; its result is redistributed to its own layout, which
    does nothing forward and brings the gradient back to that layout: a
    gradient sharded over H hd would otherwise split unevenly into the
    heads (``unflatten``)."""
    if is_dtensor(x) and any(p.is_shard(x.ndim - 1) for p in x.placements):
        from torch.distributed.tensor import Replicate

        # hd sharded (a decode cache's head dim): gathered before the
        # merge, which no DTensor version makes of an inner shard
        x = x.redistribute(placements=[
            Replicate() if p.is_shard(x.ndim - 1) else p
            for p in x.placements])
    y = x.flatten(-2)
    if is_dtensor(y) and y.requires_grad:
        y = y.redistribute(placements=y.placements)
    return y


def lookup(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``table[ids]``: the rows of ``ids``. A DTensor table (the dry run's
    count) takes them as the product of the ids' one-hot rows with the
    table, the same rows, through operations every DTensor version has
    rules for (indexing's backward has none in some); over a vocabulary
    sharded on "model" that is a sum of partial rows, summed at once (an
    all-reduce)."""
    if not is_dtensor(table):
        return table[ids]
    from torch.distributed.tensor import Replicate

    vocab = torch.arange(table.shape[0], device=table.device)
    out = (ids[..., None] == vocab).to(table.dtype) @ table
    return out.redistribute(placements=[
        Replicate() if p.is_partial() else p for p in out.placements])


def rejoin(x: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """Plain ``x`` as a replicated DTensor on ``like``'s mesh when
    ``like`` is a DTensor (the dry run's count: a ``gathered`` result
    meeting DTensors again, whose gradient then comes back as one), else
    ``x``."""
    if not is_dtensor(like) or is_dtensor(x):
        return x
    from torch.distributed.tensor import DTensor, Replicate

    mesh = like.device_mesh
    return DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


def gathered(x: torch.Tensor) -> torch.Tensor:
    """``x`` whole, as a plain tensor: a DTensor's ``full_tensor()`` (an
    all-gather the count includes), for index arithmetic DTensor has no
    rule for (``argsort``, ``searchsorted``); a plain tensor as it is."""
    return x.full_tensor() if is_dtensor(x) else x


# --- activation sharding -----------------------------------------------------
# The reference pins every major activation to a batch-sharded layout with
# GSPMD constraints. One controller has no GSPMD: the functions below
# return their input, at the reference's call sites, and the training step
# splits the batch over the entries of the axes recorded here.
_BATCH_AXES: Tuple[str, ...] = ()
_SEQ_AXIS: str = ""


def set_batch_axes(axes, seq_axis: str = "model") -> None:
    """Record the data-parallel axes (``()``: none)."""
    global _BATCH_AXES, _SEQ_AXIS
    _BATCH_AXES = tuple(axes)
    _SEQ_AXIS = seq_axis if axes else ""


def get_batch_axes() -> Tuple[str, ...]:
    """The axes the last ``set_batch_axes`` recorded."""
    return _BATCH_AXES


def shard_batch(x, batch_dim: int = 0):
    """Batch on the data axes: the reference's constraint; ``x`` here."""
    return x


def shard_batch_seq(x, seq_dim: int = 1):
    """Batch on the data axes and sequence on the model axis (the
    reference's sequence-parallel layout); ``x`` here."""
    return x


def shard_replicated_model(x, batch_dim: int = 0):
    """Batch-sharded, replicated elsewhere; ``x`` here."""
    return shard_batch(x, batch_dim)


# ---------------------------------------------------------------------------
# Primitive layers
# ---------------------------------------------------------------------------

def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    """In float32, scaled by ``1 + scale``, back in x's dtype."""
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps) * (1.0 + scale.float())).to(x.dtype)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (..., S, H, hd); positions: (..., S). Rotates halves (not
    interleaved pairs), angles in float32."""
    hd = x.shape[-1]
    half = hd // 2
    freq = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                   device=x.device) / half)
    ang = positions[..., None].float() * freq           # (..., S, half)
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(x.dtype)


def gated_mlp(p: MLP, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """SwiGLU when ``p`` has ``w_gate`` (the llama family), else the plain
    tanh-GELU MLP (starcoder2, whisper: ``jax.nn.gelu``'s default form)."""
    dt = dtype_of(cfg.compute_dtype)
    u = x @ cast(p.w_up, dt)
    if hasattr(p, "w_gate"):
        u = F.silu(x @ cast(p.w_gate, dt)) * u
    else:
        u = F.gelu(u, approximate="tanh")
    return u @ cast(p.w_down, dt)


def _gold(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """The logit of each target: ``logits[..., targets]``."""
    return torch.gather(logits, -1, targets[..., None].long())[..., 0]


def cross_entropy_loss(logits: torch.Tensor, targets: torch.Tensor,
                       mask: Optional[torch.Tensor] = None,
                       z_loss: float = 1e-4,
                       total: Union[None, float, torch.Tensor] = None
                       ) -> torch.Tensor:
    """Causal-LM loss in float32, with the optional z-loss. ``total`` is
    the count a share of a larger batch divides by (a data-parallel step:
    the global batch's tokens, or its mask's sum), so that the shares'
    losses and gradients sum to the global batch's."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    nll = lse - _gold(logits, targets)
    if z_loss:
        nll = nll + z_loss * lse ** 2
    if mask is None:
        return torch.mean(nll) if total is None else torch.sum(nll) / total
    mask = mask.float()
    count = torch.sum(mask) if total is None else total
    return torch.sum(nll * mask) / torch.clamp(torch.as_tensor(count),
                                               min=1.0)
