"""Kernel tile tuning on the card: the port's ``kernels/autotune.py``.

Every tile of the port's kernels resolves through one ladder, applied at
call time by ``kernels/ops.py`` and ``core/probe.py``:

    1. ``KernelPolicy.tile_overrides`` -- a pin per kernel, wins;
    2. ``TUNE_TABLE.json`` (beside this module) -- keyed by
       ``config.backend_key(device)`` (``'cuda/<product name>'`` or
       ``'cpu/cpu'``), then its mandatory ``'default'`` entry; within an
       entry by problem-size bucket (``bucket_of``: powers of two, ``'*'``
       any size);
    3. the kernel's builtin default -- the tile the kernel had before
       tuning.

The table is data: a fresh checkout resolves tiles from the committed
JSON, and its ``default`` entry is the builtin defaults, so a card with no
entry runs the same instances as one that never tunes. Winners are
measured on the card explicitly::

    PYTHONPATH=src python -m repro_torch.kernels.autotune --sweep --write

which times each kernel's candidate grid on the reference's sweep
workloads, device time of calls queued back to back behind a sleep of
the card (``_default_timer``), in two rounds, and writes
under this card's key the tile each bucket keeps: a candidate other than
the builtin only where it won every round by more than the spread
(``_keep``), else the builtin. ``--check`` is the schema gate CI runs on
the CPU: the table parses, has the current version and a ``default`` row
for every kernel, names no other kernel, and every value names an
instance.

What a value means (the reference's names and units, so that a row means
the same thing in both packages):

  * ``block_rows`` (``tree_probe``, ``tree_probe_paged``,
    ``bsearch_probe``): rows of 128 probes a tile. The kernels take a tile
    of 256 threads x ``block_rows / 2`` probes a thread; the builtin 8 is
    1,024 probes (256 x 4). A tree of more than four nodes keeps fewer
    probes a thread in registers (at most 2 up to eight nodes, 1 up to
    sixteen), and takes its largest instance at or below the value.
  * ``block_s`` (``flash_decode``): keys a ring stage of the split kernel,
    the counterpart of the reference's KV tile (the block of keys streamed
    through fast memory per online-softmax step). The splits stay the
    wrapper's choice (``flash_decode.decode_splits``): they set how many
    blocks fill the card, not the tile. The builtin 64 is bf16's stage.
  * ``(block_q, block_k)`` (``flash_prefill``): query rows a block (an
    item) and keys a tile. The builtin (128, 128) is bf16's tile at head
    dim 64 and 128.

A head dim or dtype that cannot take a value launches its largest instance
at or below it on each axis (``flash_decode.instance``,
``flash_prefill.instance``): bf16 prefill at D 256 takes keys tiles of 64
(two stages of K and V of 128 keys would not fit shared memory), bf16
decode takes stages of at most 256 / 128 / 64 keys at D 64 / 128 / 256,
and the float32 kernels (swept through the same row, since attention is
tuned in bf16) keep 64 query rows an item, keys tiles of at most 128 / 64
/ 32 at D 64 / 128 / 256 and of 64 at D 16 (the reduced configs' head
dim, float32 only), and stages of 4096 / D keys, at most 128. A D 16
instance has no row of its own: it resolves from the table like any other
head dim (the ``default`` entry where the card's entry has no row). So
each builtin default above, one value
a kernel, resolves to the tile each head dim and dtype had before tuning:
``_normalize`` writes a default down as that one value, checked like any
other.

A value that names no instance (not in the kernel's candidate grid)
raises; nothing falls back quietly. Tiles never change results: the GET
and the bsearch are bit for bit equal across the grid, the attention
kernels equal within their stated tolerances.
"""
from __future__ import annotations

import argparse
import dataclasses
import functools
import json
import sys
from pathlib import Path
from typing import Callable, Dict, Optional, Sequence

from repro_torch import config

__all__ = [
    "KERNELS", "TABLE_PATH", "TABLE_VERSION", "TunableKernel", "bucket_of",
    "load_table", "tile_for", "check_value", "count_tile", "default_entry",
    "sweep", "check_table", "main",
]

TABLE_PATH = Path(__file__).resolve().parent / "TUNE_TABLE.json"
TABLE_VERSION = 1
TIMER_WARMUP = 3   # calls before timing
TIMER_CALLS = 20   # calls back to back between one pair of events
TIMER_REPS = 7     # such pairs; the median is kept


@dataclasses.dataclass(frozen=True)
class TunableKernel:
    """One tunable kernel: its tile parameter, the candidate grid (each a
    template instance in ``csrc/``), the builtin default, and the problem
    sizes the sweep times a bucket each."""

    param: str
    candidates: tuple
    default: object
    sizes: tuple


# Names are the table's and the policy's keys, the reference's five.
KERNELS: Dict[str, TunableKernel] = {
    # probes a tile of the GET (csrc/tree_get.cu), rows of 128
    "tree_probe": TunableKernel(
        "block_rows", (2, 4, 8, 16), 8, (512, 1 << 14)),
    # the same kernel over a paged index (tree_probe_paged)
    "tree_probe_paged": TunableKernel(
        "block_rows", (2, 4, 8, 16), 8, (512, 1 << 14)),
    # queries a tile of the bulk prefix search (csrc/bsearch_probe.cu)
    "bsearch_probe": TunableKernel(
        "block_rows", (2, 4, 8, 16), 8, (512, 1 << 14)),
    # keys a ring stage of the split decode (csrc/flash_decode.cu)
    "flash_decode": TunableKernel(
        "block_s", (64, 128, 256), 64, (2048,)),
    # (query rows a block, keys a tile) of the prefill
    # (csrc/flash_prefill_tc.cu, csrc/flash_prefill.cu)
    "flash_prefill": TunableKernel(
        "(block_q, block_k)", ((64, 64), (64, 128), (128, 64), (128, 128)),
        (128, 128), (1024,)),
}


def bucket_of(size: int) -> str:
    """The power-of-two bucket of ``size``: ``'p<k>'`` with the smallest k
    such that ``size <= 2**k`` (``p0`` for sizes <= 1)."""
    return f"p{max(int(size) - 1, 0).bit_length()}"


def _normalize(value, spec: TunableKernel):
    """``value`` as the kernel's parameter: JSON lists fold back into
    tuples. Raises ``ValueError`` on a value of the wrong shape or one
    that names no instance (not in the candidate grid). A builtin default
    is one value of the grid too; the kernels' ``instance`` maps it to
    each head dim's own tile."""
    if isinstance(spec.default, tuple):
        if isinstance(value, (str, bytes)) or len(value) != len(spec.default):
            raise ValueError(
                f"want a {len(spec.default)}-tuple, got {value!r}")
        value = tuple(int(v) for v in value)
    else:
        if isinstance(value, (str, bytes, bool)) or not isinstance(
                value, (int, float)) or int(value) != value:
            raise ValueError(f"want an int, got {value!r}")
        value = int(value)
    if value not in spec.candidates:
        raise ValueError(f"{spec.param}={value!r} names no instance "
                         f"(candidates {spec.candidates})")
    return value


def check_value(kernel: str, value):
    """``value`` normalized for ``kernel``, or ``ValueError`` if it names
    no instance: what the wrappers call on an explicit tile."""
    return _normalize(value, KERNELS[kernel])


def count_tile(wrapper, tile: str) -> None:
    """Count one launch of ``wrapper`` at the instance ``tile`` in its
    ``tiles`` dict (beside its ``launches``): which instances a run
    took."""
    wrapper.tiles[tile] = wrapper.tiles.get(tile, 0) + 1


@functools.lru_cache(maxsize=None)
def _load_raw(path_str: str) -> dict:
    try:
        return json.loads(Path(path_str).read_text())
    except (OSError, json.JSONDecodeError):
        return {}


def load_table(path: Optional[Path] = None) -> dict:
    """The parsed table ({} when absent or not JSON), read once a process
    and path, absent or not: every kernel call resolves a tile, and a file
    system call costs more than a small kernel's launch. ``_write_table``
    forgets it; a table another process writes is read by the next
    process. The dict is shared: callers do not change it."""
    return _load_raw(str(path if path is not None else TABLE_PATH))


@functools.lru_cache(maxsize=None)
def _resolve(kernel: str, bucket: str, policy: config.KernelPolicy,
             device, path: Path):
    spec = KERNELS[kernel]
    override = policy.tile_override(kernel)
    if override is not None:
        return _normalize(override, spec)
    if not policy.tuned:
        return spec.default
    entries = _load_raw(str(path)).get("entries", {})
    for name in (config.backend_key(device), "default"):
        rows = entries.get(name, {}).get(kernel)
        if not rows:
            continue
        value = rows.get(bucket, rows.get("*"))
        if value is not None:
            return _normalize(value, spec)
    return spec.default


def tile_for(kernel: str, size: int,
             policy: Optional[config.KernelPolicy] = None, device=None):
    """``kernel``'s tile for a problem of ``size``: the policy's
    ``tile_overrides``, then the table (``device``'s backend entry, then
    ``default``; the size's bucket, then ``'*'``), then the builtin
    default. ``tuned=False`` skips the table. ``device`` is the card the
    kernel runs on (the current card, else the CPU, when ``None``). The
    answer is cached per (kernel, bucket, policy, device, table path)."""
    key = (kernel, bucket_of(size),
           config.DEFAULT_POLICY if policy is None else policy, device,
           TABLE_PATH)
    try:
        return _resolve(*key)
    except TypeError:  # a pin given as a list leaves the policy unhashable
        return _resolve.__wrapped__(*key)


# ---------------------------------------------------------------------------
# The sweep: each candidate timed on the card.
# ---------------------------------------------------------------------------

def _sleep_cycles(seconds: float) -> int:
    """Cycles of ``torch.cuda._sleep`` that keep the current card busy for
    about ``seconds`` (its clock measured once a process)."""
    import torch

    rate = _SLEEP_RATE.get(torch.cuda.current_device())
    if rate is None:
        probe = 1 << 22
        torch.cuda._sleep(probe)  # the first call loads the kernel
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        torch.cuda._sleep(probe)
        end.record()
        end.synchronize()
        rate = _SLEEP_RATE[torch.cuda.current_device()] = (
            probe / (start.elapsed_time(end) * 1e-3))
    return int(rate * seconds) + 1


_SLEEP_RATE: Dict[int, float] = {}


def _default_timer(fn: Callable[[], object]) -> float:
    """Median device microseconds of one ``fn()`` on the current card.

    A call of the sweep's small workloads takes less time on the card than
    the host takes to issue it (a wrapper's checks and its ctypes launch,
    tens of microseconds), so events around single calls would time the
    host. Here the card first sleeps (``torch.cuda._sleep``) for twice the
    host's time to issue ``TIMER_CALLS`` calls, the host queues those calls
    behind the sleep, and the two events around them time the calls back
    to back on the card alone. ``TIMER_WARMUP`` calls first; the median of
    ``TIMER_REPS`` such pairs, divided by ``TIMER_CALLS``."""
    import time

    import torch

    for _ in range(TIMER_WARMUP):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(TIMER_CALLS):
        fn()
    issue_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    cycles = _sleep_cycles(2 * issue_s)
    times = []
    for _ in range(TIMER_REPS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        start.record()
        for _ in range(TIMER_CALLS):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) * 1e3 / TIMER_CALLS)
    times.sort()
    return times[len(times) // 2]


def _chain_shred(device):
    """The reference's GET sweep index: the chain R(x, y) - S(y, z) -
    T(z, u) of 512 rows each (numpy seed 0), shredded and packed."""
    import numpy as np

    from repro_torch.core import Atom, Database, JoinQuery, build_shred

    rng = np.random.default_rng(0)
    m = 512

    def column():
        return rng.integers(0, m // 4, m)

    db = Database.from_columns({
        "R": {"x": column(), "y": column()},
        "S": {"y": column(), "z": column()},
        "T": {"z": column(), "u": column()},
    }, device=device)
    q = JoinQuery((Atom.of("R", "x", "y"), Atom.of("S", "y", "z"),
                   Atom.of("T", "z", "u")))
    shred = build_shred(db, q, rep="usr")
    if shred.packed is None:
        raise RuntimeError("sweep workload failed to pack an arena")
    return shred


def _candidate_thunks(kernel: str, size: int, device):
    """``candidate -> zero-argument thunk`` for one (kernel, size) on
    ``device``: the reference's workloads, made with numpy and torch."""
    import numpy as np
    import torch

    rows = -(-size // 128)
    if kernel == "bsearch_probe":
        from .bsearch_probe import bsearch_probe
        n = 1 << 15
        pref = torch.arange(n, dtype=torch.int32, device=device)
        q = torch.from_numpy(np.random.default_rng(0).integers(
            0, n, rows * 128).astype(np.int32)).to(device)
        return lambda cand: (lambda: bsearch_probe(pref, q, block_rows=cand))
    if kernel in ("tree_probe", "tree_probe_paged"):
        from repro_torch.core import PagedArena
        from .tree_probe import tree_probe, tree_probe_paged
        shred = _chain_shred(device)
        packed = shred.packed
        n = int(shred.join_size)
        qs = torch.from_numpy(np.random.default_rng(1).integers(
            0, max(n, 1), rows * 128).astype(np.int32)).to(device)
        if kernel == "tree_probe":
            return lambda cand: (lambda: tree_probe(
                packed.arena, qs, packed.layout, block_rows=cand))
        paged = PagedArena.from_packed(packed)
        return lambda cand: (lambda: tree_probe_paged(
            paged, qs, block_rows=cand))
    gen = torch.Generator(device="cpu")
    if kernel == "flash_decode":
        from .flash_decode import flash_decode
        B, H, D, S = 2, 4, 64, size
        gen.manual_seed(2)
        qv = torch.randn((B, H, D), generator=gen).to(device, torch.bfloat16)
        kv = torch.randn((B, H, S, D), generator=gen).to(device,
                                                          torch.bfloat16)
        bias = torch.zeros((B, S), dtype=torch.float32, device=device)
        return lambda cand: (lambda: flash_decode(qv, kv, kv, bias,
                                                  block_s=cand))
    if kernel == "flash_prefill":
        from .flash_prefill import flash_prefill
        B, H, D, S = 1, 2, 64, size
        gen.manual_seed(3)
        qv = torch.randn((B, H, S, D), generator=gen).to(device,
                                                         torch.bfloat16)
        return lambda cand: (lambda: flash_prefill(
            qv, qv, qv, True, block_q=cand[0], block_k=cand[1]))
    raise ValueError(f"no sweep workload for kernel {kernel!r}")


def _keep(times: dict, default):
    """The tile a sweep keeps for one bucket from ``{candidate: [us of
    each round]}``, and why: the fastest candidate when it won every round
    and is the builtin, or its slowest round beats the builtin's fastest
    (its lead is more than either's spread); else the builtin."""
    rounds = len(next(iter(times.values())))
    firsts = {min(times, key=lambda c: times[c][r]) for r in range(rounds)}
    if len(firsts) > 1:
        return default, "the rounds' winners differ: the builtin kept"
    best = firsts.pop()
    if best == default or default not in times:
        return best, "the fastest"
    if max(times[best]) < min(times[default]):
        return best, "the fastest, ahead of the builtin in every round"
    return default, "within the builtin's spread: the builtin kept"


def sweep(kernels: Optional[Sequence[str]] = None, *,
          timer: Optional[Callable[[Callable], float]] = None,
          candidates: Optional[dict] = None,
          sizes: Optional[dict] = None,
          rounds: int = 2,
          entry_key: Optional[str] = None,
          write: bool = False,
          path: Optional[Path] = None,
          device=None,
          out: Callable[[str], None] = print) -> dict:
    """Time every candidate per (kernel, size bucket) ``rounds`` times
    (each round every candidate once, in turn) and return the tiles kept,
    ``{kernel: {bucket: value}}`` (``_keep``: with one round the fastest;
    with more, a candidate other than the builtin only where it won every
    round by more than the spread). With ``write=True`` store them under
    ``entry_key`` (default: ``backend_key(device)``) in the table at
    ``path`` (default ``TABLE_PATH``), made with its ``default`` entry if
    absent; a swept kernel's rows replace its earlier ones. ``timer``
    (default: device time on the card, ``_default_timer``) maps a thunk to
    microseconds; ``candidates`` and ``sizes`` replace a kernel's grid and
    sizes; ``device`` defaults to the current card."""
    timer = timer or _default_timer
    if device is None:
        device = "cuda"
    names = list(kernels) if kernels else list(KERNELS)
    winners: dict = {}
    for name in names:
        spec = KERNELS[name]  # a KeyError is the caller's
        cands = tuple((candidates or {}).get(name, spec.candidates))
        ksizes = tuple((sizes or {}).get(name, spec.sizes))
        winners[name] = {}
        for size in ksizes:
            bucket = bucket_of(size)
            make = _candidate_thunks(name, size, device)
            times = {cand: [] for cand in cands}
            for r in range(rounds):
                for cand in cands:
                    times[cand].append(timer(make(cand)))
                    out(f"autotune: {name}[{bucket}] "
                        + (f"round {r + 1} " if rounds > 1 else "")
                        + f"{spec.param}={cand}: {times[cand][-1]:.1f}us")
            kept, why = _keep(times, spec.default)
            winners[name][bucket] = kept
            out(f"autotune: {name}[{bucket}] winner: {spec.param}={kept} "
                f"({why})")
    if write:
        key = entry_key or config.backend_key(device)
        _write_table(winners, key, Path(path) if path else TABLE_PATH, out)
    return winners


def default_entry() -> dict:
    """The mandatory ``default`` entry: each kernel's builtin default
    under the any-size bucket."""
    return {name: {"*": spec.default} for name, spec in KERNELS.items()}


def _write_table(winners: dict, entry_key: str, path: Path, out) -> None:
    # a copy: load_table's dict is shared
    table = json.loads(json.dumps(load_table(path))) or {
        "version": TABLE_VERSION, "entries": {}}
    table.setdefault("entries", {})["default"] = default_entry()
    table["entries"].setdefault(entry_key, {}).update(winners)
    path.write_text(json.dumps(table, indent=2, sort_keys=True) + "\n")
    _load_raw.cache_clear()
    _resolve.cache_clear()
    out(f"autotune: wrote {path} (entry {entry_key!r})")


# ---------------------------------------------------------------------------
# --check: the schema gate, standard library only.
# ---------------------------------------------------------------------------

def check_table(path: Optional[Path] = None,
                out: Callable[[str], None] = print) -> int:
    """Validate a table: it parses, has the current version, a ``default``
    entry covering every kernel, no unknown kernel, buckets ``'p<k>'`` or
    ``'*'``, and every value an instance of its kernel. Returns 0 (ok) or
    1."""
    path = Path(path) if path is not None else TABLE_PATH
    errors = []
    if not path.is_file():
        errors.append(f"missing {path.name}: run `python -m "
                      f"repro_torch.kernels.autotune --sweep --write` or "
                      f"commit the default table")
        table = {}
    else:
        try:
            table = json.loads(path.read_text())
        except json.JSONDecodeError as e:
            errors.append(f"{path.name} is not valid JSON: {e}")
            table = {}
    if table:
        if table.get("version") != TABLE_VERSION:
            errors.append(f"version {table.get('version')!r} != "
                          f"{TABLE_VERSION} (schema drift)")
        entries = table.get("entries")
        if not isinstance(entries, dict) or "default" not in entries:
            errors.append("entries.default missing: every checkout must "
                          "resolve tiles without tuning")
            entries = entries if isinstance(entries, dict) else {}
        for ekey, entry in entries.items():
            stale = sorted(set(entry) - set(KERNELS))
            if stale:
                errors.append(f"entry {ekey!r} names unknown kernels "
                              f"{stale}: renamed? prune or re-sweep")
            for kname, rows in entry.items():
                if kname not in KERNELS:
                    continue
                spec = KERNELS[kname]
                for bucket, value in rows.items():
                    if bucket != "*" and not (
                            bucket.startswith("p") and bucket[1:].isdigit()):
                        errors.append(f"{ekey}/{kname}: bad bucket "
                                      f"{bucket!r} (want 'p<k>' or '*')")
                    try:
                        _normalize(value, spec)
                    except (TypeError, ValueError) as e:
                        errors.append(f"{ekey}/{kname}[{bucket}]: value "
                                      f"{value!r} is no {spec.param}: {e}")
        if "default" in entries:
            missing = sorted(set(KERNELS) - set(entries["default"]))
            if missing:
                errors.append(f"default entry missing rows for {missing}: "
                              f"every kernel needs a default")
    if errors:
        out(f"autotune --check: FAILED ({path})")
        for e in errors:
            out(f"  {e}")
        return 1
    n = sum(len(rows) for e in table["entries"].values()
            for rows in e.values())
    out(f"autotune --check: ok ({len(table['entries'])} entries, "
        f"{n} rows, {len(KERNELS)} kernels)")
    return 0


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description="Kernel tile tuning on the card")
    ap.add_argument("--check", action="store_true",
                    help="validate TUNE_TABLE.json (the CI schema gate)")
    ap.add_argument("--sweep", action="store_true",
                    help="time the candidate grids on the card")
    ap.add_argument("--kernel", default=None,
                    help="comma-separated kernel names (default: all)")
    ap.add_argument("--write", action="store_true",
                    help="store the sweep's winners in TUNE_TABLE.json "
                         "under this card's key")
    args = ap.parse_args(argv)
    if args.check:
        return check_table()
    if args.sweep:
        names = args.kernel.split(",") if args.kernel else None
        unknown = sorted(set(names or ()) - set(KERNELS))
        if unknown:
            print(f"autotune: unknown kernels {unknown} "
                  f"(have: {sorted(KERNELS)})", file=sys.stderr)
            return 2
        import torch
        if not torch.cuda.is_available():
            print("autotune: --sweep times the kernels on a CUDA device; "
                  "none is available", file=sys.stderr)
            return 1
        sweep(names, write=args.write)
        return 0
    ap.print_help()
    return 2


if __name__ == "__main__":
    sys.exit(main())
