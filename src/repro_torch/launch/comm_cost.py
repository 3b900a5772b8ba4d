"""Collective bytes of a step: the port's counterpart of the reference's
``launch/hlo_cost.py``.

The reference compiles each dry-run step under GSPMD and reads its
collectives from the compiled HLO. The port has no compiler to ask: it
runs the step once on ``meta`` tensors as DTensors on a ``DeviceMesh`` of
the production mesh's shape (``launch.mesh.device_mesh``, the ``fake``
backend: nothing moves and nothing is allocated), and counts the c10d
functional collectives that DTensor issues to keep every operation's
sharding consistent:

    all_reduce             -> "all-reduce"
    all_gather_into_tensor -> "all-gather"
    reduce_scatter_tensor  -> "reduce-scatter"
    all_to_all_single      -> "all-to-all"

under the reference's five names (``COLLECTIVES``; nothing here issues a
``collective-permute``, which stays 0). Any other collective raises; none
is skipped. The bytes are the reference's rules
(``repro.launch.dryrun.collective_bytes``): each collective's result
bytes on one device, an all-reduce counted twice (a ring's reduce-scatter
plus all-gather).

The parameters take the reference's specs (``layers.param_specs``,
``sanitize_pspecs``), AdamW's moments theirs (a factored moment's rows and
columns their dimensions'), the batch and the decode cache the dry run's
(``batch_shardings``, ``cache_shardings``); ``layers.placements`` maps a
spec onto the mesh. Plain tensors made inside the step (positions, masks)
join as replicated (``implicit_replication``).

The model code runs as it is, except where a function's DTensor form
differs from its plain one: for the count, ``counting_route`` swaps these
module functions for the versions here, and puts them back after.

  * ``cast`` (every module of the model): a weight is gathered over the
    data axes where it is used (FSDP's all-gather, the gradient's
    reduce-scatter in the backward), as the reference's specs make GSPMD
    gather it;
  * ``shard_batch``, ``shard_batch_seq``: redistribute a DTensor as the
    reference's ``with_sharding_constraint`` pins its array (the plain
    versions return their input);
  * the attention (``attention._prefill_route``, ``blockwise_attention``,
    ``ops.decode_attention``), ``moe.route`` and the SSM and RWKV scans
    (``ssm._ssd_chunked``, ``_ssd_step``, ``_wkv6_scan``): run on each
    entry's block of batch rows and heads (``_local_blocks``, the
    reference's ``shard_map``), the attention as every key at once
    (``dense_attention``: the plain versions' per-row stores and the
    blockwise scan's views have no DTensor rule);
  * ``layers._gold`` (the loss's target logits): a masked sum over the
    vocabulary (DTensor's gather over a sharded vocabulary fails on
    ``meta`` once its plan is cached);
  * ``adamw._mean``: a mean over a sharded dimension summed at once, on
    the factored vector rather than on the matrix it scales.

Where DTensor has no rule for a view or an index, the model code itself
redistributes explicitly (``layers.unflatten``, ``merge_last``,
``lookup``; ``gathered`` and ``rejoin`` in the MoE dispatch, whose index
arithmetic runs on whole tensors), and the count includes it. DTensor
and XLA's partitioner choose their own layouts between those
constraints, so the two counts follow the same rules, not the same
choices; the MoE dispatch's whole-tensor gathers and decode's gathers of
every weight make those steps' counts upper bounds (``launch/dryrun.py``).

``HloCost`` multiplies a while loop's body by its trip count. Here every
loop (the layers, the scans over a sequence or a cache, gradient
accumulation's microbatches) runs eagerly, once per iteration, so each
collective is counted as often as it is issued: no trip-count multiplier
is needed.

    python -m repro_torch.launch.comm_cost smollm_135m:train:8:64 \
        olmoe_1b_7b:decode:8:64 [--mesh 4,2]

(with ``PYTHONPATH=src``) counts each ``arch:kind:batch:seq`` step of the
reduced config on a mesh of that shape
("data", "model"; three axes: "pod" first) and prints a JSON line a step:
the torch version and a device's bytes by type.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import logging
import types
from typing import Dict, Iterable, Optional, Sequence, Tuple

import numpy as np

import torch
from torch.utils._python_dispatch import TorchDispatchMode

__all__ = ["COLLECTIVES", "collective_bytes", "CollectiveCounter",
           "counting_route", "dense_attention", "count_collectives",
           "run_step", "main"]

COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
               "collective-permute")
# the c10d functional ops DTensor issues, by the reference's names
_NAMES = {"all_reduce": "all-reduce",
          "all_gather_into_tensor": "all-gather",
          "reduce_scatter_tensor": "reduce-scatter",
          "all_to_all_single": "all-to-all"}
# operations of those namespaces that move nothing: a wait, and the
# autograd wrapper of a collective's result
_NOT_COLLECTIVES = {"wait_tensor", "_wrap_tensor_autograd"}
_NAMESPACES = {"_c10d_functional", "c10d_functional",
               "_c10d_functional_autograd", "c10d"}


def collective_bytes(ops: Iterable[Tuple[str, int]]
                     ) -> Tuple[Dict[str, int], Dict[str, int]]:
    """The reference's accounting of ``ops`` (each ``(name, result
    bytes)``, the name one of ``COLLECTIVES``): bytes and counts by type,
    the bytes a collective's result's, an all-reduce's twice."""
    out = {k: 0 for k in COLLECTIVES}
    counts = {k: 0 for k in COLLECTIVES}
    for name, nbytes in ops:
        if name not in out:
            raise ValueError(f"collective_bytes: {name!r} is none of "
                             f"{COLLECTIVES}")
        out[name] += nbytes * (2 if name == "all-reduce" else 1)
        counts[name] += 1
    return out, counts


class CollectiveCounter(TorchDispatchMode):
    """While active, records ``(name, result bytes)`` of every c10d
    functional collective in ``ops``. It steps aside for DTensor (an
    operation on DTensors returns ``NotImplemented`` here), so it sees the
    collectives that DTensor's redistributions issue on the local
    tensors. A collective it has no name for raises."""

    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor

        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **(kwargs or {}))
        if func.namespace in _NAMESPACES:
            op = func._overloadpacket.__name__
            if op not in _NOT_COLLECTIVES:
                if op not in _NAMES or not isinstance(out, torch.Tensor):
                    raise NotImplementedError(
                        f"CollectiveCounter: {func} is no collective the "
                        f"count knows ({', '.join(_NAMES)})")
                self.ops.append((_NAMES[op],
                                 out.numel() * out.element_size()))
        return out


# ---------------------------------------------------------------------------
# the counting route: the model's functions whose DTensor form differs
# ---------------------------------------------------------------------------

def _is_dtensor(x) -> bool:
    from repro_torch.models.layers import is_dtensor

    return is_dtensor(x)


def _fsdp_gathered(w: torch.Tensor) -> torch.Tensor:
    """DTensor weight ``w`` whole over the mesh's data axes ("pod",
    "data"), still sharded over the others: FSDP's all-gather at the use,
    whose backward reduce-scatters the gradient, as the reference's specs
    (the complement of the tensor-parallel dim on "data") make GSPMD do.
    Without it DTensor may keep the activations whole and the products'
    sums partial over "data" instead."""
    from torch.distributed.tensor import Replicate

    names = w.device_mesh.mesh_dim_names
    want = [Replicate() if names[i] in ("pod", "data") else p
            for i, p in enumerate(w.placements)]
    return w if want == list(w.placements) else w.redistribute(
        placements=want)


def _constrain(x, dims):
    """A DTensor redistributed to ``P(*dims)``, as the reference's
    ``with_sharding_constraint`` pins it; else ``x``."""
    from repro_torch.models.layers import PartitionSpec, placements

    if not _is_dtensor(x):
        return x
    return x.redistribute(placements=placements(PartitionSpec(*dims),
                                                x.device_mesh))


def _block_spec(x: torch.Tensor, batch: Optional[int] = None,
                heads: Optional[int] = None):
    """The layout of DTensor ``x`` that ``_local_blocks`` computes on: its
    dimension ``batch`` over the data axes (``layers.set_batch_axes``) and
    ``heads`` over "model", each where its size divides, the rest
    whole."""
    from repro_torch.models.layers import PartitionSpec, get_batch_axes

    axes = get_batch_axes()
    mesh = x.device_mesh
    sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
    dims = [None] * x.ndim
    dp = int(np.prod([sizes[a] for a in axes]))
    if batch is not None and axes and x.shape[batch] % dp == 0:
        dims[batch] = axes
    if heads is not None and "model" in sizes and \
            x.shape[heads] % sizes["model"] == 0:
        dims[heads] = "model"
    return PartitionSpec(*dims)


def _local_blocks(fn, args: Sequence, specs: Sequence, out_specs: Sequence):
    """``fn`` on one entry's blocks, as the reference's ``shard_map`` runs
    a function per device: each tensor of ``args`` laid out by its spec of
    ``specs`` (a DTensor redistributed to it, the collectives counted; a
    plain tensor taken as replicated, then sliced), ``fn`` run on the local
    blocks (rank 0's: on ``meta`` only their shapes count), and its
    result(s) DTensors laid out by ``out_specs``. For a computation that
    is independent per batch row and head (a scan, the attention's
    products) and whose views DTensor has no rules for in some versions."""
    from torch.distributed.tensor import DTensor, Replicate

    from repro_torch.models.layers import placements

    mesh = next(a for a in args if _is_dtensor(a)).device_mesh

    def block(a, spec):
        if not isinstance(a, torch.Tensor):
            return a
        if not _is_dtensor(a):
            a = DTensor.from_local(a, mesh, [Replicate()] * mesh.ndim,
                                   run_check=False)
        return a.redistribute(placements=placements(spec, mesh)).to_local()

    outs = fn(*[block(a, sp) for a, sp in zip(args, specs)])
    single = not isinstance(outs, tuple)
    outs = tuple(DTensor.from_local(o, mesh, placements(sp, mesh),
                                    run_check=False)
                 for o, sp in zip((outs,) if single else outs, out_specs))
    return outs[0] if single else outs


def dense_attention(q, k, v, *, causal: bool = False, bias=None,
                    group_major: bool = False, window: int = 0,
                    q_pos=None, kv_pos=None) -> torch.Tensor:
    """The counting route's attention (DTensors): q (B, H, S, D), k/v (B,
    KV, T, D), every key at once in float32, out in q's dtype, on each
    entry's block of batch rows and query heads (``_local_blocks``: no
    collective inside it; K and V split over their heads only where those
    blocks keep each query head's KV head, else whole). Query head h reads
    KV head ``h // (H / KV)`` (``h % KV`` when ``group_major``, the
    reference's g-major forward). Keys at positions ``kv_pos`` (default
    0..T-1; negative: padding, left out) against queries at ``q_pos``
    (default 0..S-1): ``causal`` keeps keys at or before the query,
    ``window`` those within it; ``bias`` (B, T) is added to the logits.
    The plain versions' per-group stores, the blockwise scan's views and,
    in some DTensor versions, a product over two sharded batch dims have
    no DTensor rule."""
    from repro_torch.models import attention
    from repro_torch.models.layers import P

    B, H, S, D = q.shape
    KV, T = k.shape[1], k.shape[2]
    G = H // KV
    dev = q.device
    q_pos = torch.arange(S, device=dev) if q_pos is None else q_pos
    kv_pos = torch.arange(T, device=dev) if kv_pos is None else kv_pos
    qs = _block_spec(q, 0, 1)
    split = qs[1] is not None and not group_major and \
        _block_spec(k, None, 1)[1] is not None
    ks = _block_spec(k, 0, 1 if split else None)

    def attend(q, k, v, bias, q_pos, kv_pos):
        h = torch.arange(q.shape[1], device=dev)
        kx = k.index_select(1, h % KV if group_major else h // G).float()
        vx = v.index_select(1, h % KV if group_major else h // G).float()
        s = torch.matmul(q.float(), kx.transpose(-1, -2)) / D ** 0.5
        keep = (kv_pos[None, :] >= 0).expand(S, T)
        if causal:
            keep = keep & (kv_pos[None, :] <= q_pos[:, None])
        if window > 0:
            keep = keep & (kv_pos[None, :] > q_pos[:, None] - window)
        s = torch.where(keep, s, attention.NEG_INF)
        if bias is not None:
            s = s + bias[:, None, None, :]
        return torch.matmul(torch.softmax(s, dim=-1), vx).to(q.dtype)

    return _local_blocks(
        attend, (q, k, v, bias, q_pos, kv_pos),
        (qs, ks, ks, P(qs[0]), P(), P()),
        (qs,))


def _swaps():
    """``(module, name, counting version)`` of every swap, each built over
    the function it stands in for."""
    from repro_torch.kernels import ops
    from repro_torch.models import attention, layers, moe, ssm, transformer
    from repro_torch.models.layers import P
    from repro_torch.optim import adamw

    cast, route, decode = layers.cast, moe.route, ops.decode_attention
    ssd_chunked, ssd_step = ssm._ssd_chunked, ssm._ssd_step
    wkv6_scan, mean = ssm._wkv6_scan, adamw._mean

    def count_cast(w, dt):
        if not _is_dtensor(w):
            return cast(w, dt)
        return _fsdp_gathered(w if w.dtype == dt else w.to(dt))

    def count_shard_batch(x, batch_dim: int = 0):
        axes = layers.get_batch_axes()
        if not axes or x.ndim == 0 or x.shape[batch_dim] == 1:
            return x
        dims = [None] * x.ndim
        dims[batch_dim] = axes
        return _constrain(x, dims)

    def count_shard_batch_seq(x, seq_dim: int = 1):
        axes, seq = layers.get_batch_axes(), layers._SEQ_AXIS
        if not axes or not seq or x.ndim < 2:
            return x
        dims = [None] * x.ndim
        if x.shape[0] > 1:
            dims[0] = axes
        dims[seq_dim] = seq
        return _constrain(x, dims)

    def count_prefill_route(q, k, v, KV, causal, head_shard, policy):
        return dense_attention(q.transpose(1, 2), k.transpose(1, 2),
                               v.transpose(1, 2), causal=causal,
                               group_major=head_shard).transpose(1, 2)

    def count_blockwise(q, k, v, q_pos, kv_pos, *, causal, window=0,
                        chunk=0, head_shard=False, probs_bf16=False):
        return dense_attention(q.transpose(1, 2), k.transpose(1, 2),
                               v.transpose(1, 2), causal=causal,
                               group_major=head_shard, window=window,
                               q_pos=q_pos, kv_pos=kv_pos).transpose(1, 2)

    def count_decode(q, k, v, bias=None, **kw):
        if not _is_dtensor(q):
            return decode(q, k, v, bias, **kw)
        return dense_attention(q[:, :, None], k, v, bias=bias)[:, :, 0]

    def count_route(p, xt, cfg):  # token by token, on each entry's rows
        rows = _block_spec(xt, 0)
        return _local_blocks(
            lambda x, w: route(types.SimpleNamespace(router=w), x, cfg),
            (xt, p.router), (rows, P()), (rows,) * 3)

    def count_ssd_chunked(xh, dt, B, C, A, chunk):
        ys, ss = _block_spec(xh, 0, 2), _block_spec(xh, 0, None)
        return _local_blocks(lambda *a: ssd_chunked(*a, chunk),
                             (xh, dt, B, C, A),
                             (ys, P(*ys[:3]), ss, ss, P(ys[2])),
                             (ys, P(ys[0], ys[2])))

    def count_ssd_step(state, dt, xh, B, C, A):
        ys, ss = _block_spec(xh, 0, 2), _block_spec(xh, 0, None)
        return _local_blocks(ssd_step, (state, dt, xh, B, C, A),
                             (P(ys[0], ys[2]), P(*ys[:3]), ys, ss, ss,
                              P(ys[2])),
                             (ys, P(ys[0], ys[2])))

    def count_wkv6_scan(r, k, v, w, u, state0):
        rs = _block_spec(r, 0, 2)
        return _local_blocks(wkv6_scan, (r, k, v, w, u, state0),
                             (rs, rs, rs, rs, P(rs[2]), P(rs[0], rs[2])),
                             (rs, P(rs[0], rs[2])))

    def count_gold(logits, targets):
        vocab = torch.arange(logits.shape[-1], device=logits.device)
        return torch.where(vocab == targets[..., None].long(), logits,
                           0.0).sum(-1)

    def count_mean(x, dim):
        from torch.distributed.tensor import Replicate

        out = mean(x, dim)
        if not _is_dtensor(out) or not any(p.is_partial()
                                           for p in out.placements):
            return out
        return out.redistribute(placements=[
            Replicate() if p.is_partial() else p for p in out.placements])

    models = (layers, attention, moe, ssm, transformer)
    swaps = [(m, name, fn) for name, fn in (
        ("cast", count_cast), ("shard_batch", count_shard_batch),
        ("shard_batch_seq", count_shard_batch_seq)) for m in models
        if getattr(m, name, None) is getattr(layers, name)]
    return swaps + [
        (layers, "_gold", count_gold),
        (attention, "_prefill_route", count_prefill_route),
        (attention, "blockwise_attention", count_blockwise),
        (ops, "decode_attention", count_decode),
        (moe, "route", count_route),
        (ssm, "_ssd_chunked", count_ssd_chunked),
        (ssm, "_ssd_step", count_ssd_step),
        (ssm, "_wkv6_scan", count_wkv6_scan),
        (adamw, "_mean", count_mean)]


@contextlib.contextmanager
def counting_route():
    """The model's modules with the counting versions of the functions
    whose DTensor form differs (the module docstring) swapped in, for the
    ``with`` block; put back after it."""
    swaps = _swaps()
    saved = [(m, name, getattr(m, name)) for m, name, _ in swaps]
    try:
        for m, name, fn in swaps:
            setattr(m, name, fn)
        yield
    finally:
        for m, name, fn in saved:
            setattr(m, name, fn)


def _distribute(t: torch.Tensor, spec, dmesh, requires_grad=None):
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.models.layers import placements

    d = distribute_tensor(t.detach(), dmesh, placements(spec, dmesh))
    return d if requires_grad is None else torch.nn.Parameter(
        d, requires_grad=requires_grad)


def count_collectives(cfg, kind: str, B: int, S: int, mesh) -> Dict:
    """One step of ``cfg`` (``kind``: "train", "prefill" or "decode", the
    dry run's step functions) at batch ``B`` and sequence ``S`` (decode: a
    cache of ``S``) on the port's ``Mesh`` ``mesh`` (its shape and axis
    names; the entries are not read), run on ``meta`` DTensors and counted
    in full: ``{"bytes": {type: a device's bytes}, "counts": {type: the
    collectives issued}, "ops": [(type, result bytes), ...] in the order
    issued}``. The data-parallel axes are taken for the batch as the dry
    run's cell takes them (``layers.set_batch_axes``)."""
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import device_mesh
    from repro_torch.models import transformer

    # DTensor's advice on its own plans (two collectives where a flattened
    # mesh would take one) is not the count's business
    logging.getLogger("torch.distributed.tensor._redistribute").setLevel(
        logging.ERROR)
    model = transformer.init_model(cfg, device="meta", policy=dryrun.PLAIN)
    batch = dryrun._inputs(cfg, kind, B, S)
    cache = (transformer.init_cache(cfg, B, S, cfg.n_memory_tokens,
                                    device="meta")
             if kind == "decode" else None)
    counter = CollectiveCounter()
    with device_mesh(mesh) as dmesh:
        run_step(cfg, kind, model, batch, mesh, dmesh, cache, S - 1,
                 counter)
    nbytes, counts = collective_bytes(counter.ops)
    return {"bytes": nbytes, "counts": counts, "ops": counter.ops}


def run_step(cfg, kind: str, model, batch: Dict, mesh, dmesh, cache=None,
             cur: int = 0, within=None):
    """The dry run's step ``kind`` on DTensors over ``dmesh`` (``mesh``'s
    ``device_mesh``), through the counting route: ``model``'s parameters
    are replaced in place by DTensors laid out by the reference's specs,
    ``batch`` and the decode ``cache`` (at length ``cur``) by the dry
    run's, AdamW's state made and laid out as the parameters; the step
    runs inside ``within`` (a context manager: the counter) when given.
    Returns the step's result: train ``(opt_state, metrics)``, prefill the
    last position's logits, decode ``(logits, cache)``."""
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.launch import dryrun
    from repro_torch.models import layers
    from repro_torch.models.layers import P
    from repro_torch.optim import AdamWConfig, adamw_init

    params = dict(model.named_parameters())
    pspecs = layers.sanitize_pspecs(layers.param_specs(model), params, mesh)
    bspecs = dryrun.batch_shardings(mesh, batch)
    if kind == "train":  # AdamW's state, laid out as the dry run sizes it
        opt_cfg = AdamWConfig(
            moment_dtype="bfloat16" if cfg.param_dtype == "bfloat16"
            else "float32", factored=cfg.opt_factored)
        state = adamw_init(opt_cfg, params)
        state["step"] = _distribute(state["step"], P(), dmesh)
        for name, sp in pspecs.items():
            sp = list(sp) + [None] * (params[name].ndim - len(sp))
            state["m"][name] = _distribute(state["m"][name], P(*sp), dmesh)
            v = state["v"][name]
            if isinstance(v, dict):  # factored: rows, then columns
                v["vr"] = _distribute(v["vr"], P(*sp[:-1]), dmesh)
                v["vc"] = _distribute(v["vc"], P(*(sp[:-2] + sp[-1:])),
                                      dmesh)
            else:
                state["v"][name] = _distribute(v, P(*sp), dmesh)
    for name, p in params.items():
        owner, _, leaf = name.rpartition(".")
        setattr(model.get_submodule(owner), leaf,
                _distribute(p, pspecs[name], dmesh, p.requires_grad))
    batch = {k: _distribute(v, bspecs[k], dmesh) for k, v in batch.items()}
    if kind == "decode":
        cspecs = dryrun.cache_shardings(mesh, cfg, cache)
        cache = [{k: _distribute(v, sp[k], dmesh) for k, v in layer.items()}
                 for layer, sp in zip(cache, cspecs)]
    with implicit_replication(), counting_route(), \
            within or contextlib.nullcontext():
        if kind == "train":
            return dryrun.make_train_step(cfg, opt_cfg)(model, state, batch)
        if kind == "prefill":
            return dryrun.make_prefill(cfg)(model, batch)
        return dryrun.make_serve_step(cfg)(model, cache, batch["tokens"],
                                           cur)


def main(argv=None) -> int:
    from repro_torch import configs
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import layers

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("cells", nargs="+", help="arch:kind:batch:seq")
    ap.add_argument("--mesh", default="4,2",
                    help="the mesh's shape, comma-separated")
    args = ap.parse_args(argv)
    shape = tuple(int(n) for n in args.mesh.split(","))
    axes = ("pod", "data", "model")[-len(shape):]
    mesh = make_mesh(shape, axes, devices="meta")
    for cell in args.cells:
        arch, kind, B, S = cell.split(":")
        cfg = configs.reduced(configs.get_config(arch))
        layers.set_batch_axes(tuple(a for a in axes if a != "model"))
        layers.set_moe_ep(getattr(cfg, "moe_ep", False))
        got = count_collectives(cfg, kind, int(B), int(S), mesh)["bytes"]
        print(json.dumps({"cell": cell, "mesh": list(shape),
                          "torch": torch.__version__, "bytes": got,
                          "total": sum(got.values())}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
