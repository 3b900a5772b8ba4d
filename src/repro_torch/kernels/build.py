"""Build the port's CUDA kernels with ``nvcc`` and load them with ``ctypes``.

Each ``csrc/<name>.cu`` becomes one shared library with a plain C
interface, compiled for Hopper (``sm_90a``) at first use into the
repository's ``build/kernels/`` directory (git-ignored). A library's file
name carries a digest of every source in ``csrc/``, so an edited source
is never served by a stale build. ``build_all`` starts one ``nvcc`` per
source, all at once, and waits for them together. ``VARIANTS`` are
other builds of a source with flags of their own: the checked build of
each of the nine sources.

No source links ``libcuda``: ``flash_prefill_tc.cu`` fetches
``cuTensorMapEncodeTiled`` at run time through the runtime's entry-point
query, so every build takes the same flags.

Nothing here runs at import: the CPU tests import every module, and this
machine may have no ``nvcc``.
"""
from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable

import torch

__all__ = ["SOURCES", "VARIANTS", "BUILD_DIR", "build_all", "library",
           "library_path", "entry", "check", "on_device", "current_stream",
           "ptxas_report", "vector_operand", "checked_run", "bounds_check",
           "CHECK_RECORDS"]

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
SOURCES = ("bsearch_probe", "tree_get", "tree_probe_paged", "fused_draw",
           "scan", "flash_decode", "flash_prefill", "flash_prefill_tc",
           "csr_walk")
# Other builds of a source, each with its own flags and library: name ->
# (source, extra nvcc flags). The checked builds, one a source, hold every
# access of a launch against its operands (fused_draw.out_of_bounds,
# flash_prefill.out_of_bounds, tree_probe.out_of_bounds,
# flash_decode.out_of_bounds; and, through csrc/bounds_check.cuh,
# prefix_sum.out_of_bounds and geo_gaps.out_of_bounds,
# bsearch_probe.out_of_bounds, csr_walk.out_of_bounds and
# tree_probe.paged_out_of_bounds), a measurement.
VARIANTS = {"fused_draw_checked": ("fused_draw", ("-DFD_CHECK_BOUNDS",)),
            "flash_prefill_tc_checked": ("flash_prefill_tc",
                                         ("-DFPT_CHECK_BOUNDS",)),
            "tree_get_checked": ("tree_get", ("-DTG_CHECK_BOUNDS",)),
            "flash_decode_checked": ("flash_decode",
                                     ("-DFDT_CHECK_BOUNDS",)),
            "flash_prefill_checked": ("flash_prefill",
                                      ("-DFP_CHECK_BOUNDS",)),
            "scan_checked": ("scan", ("-DSC_CHECK_BOUNDS",)),
            "bsearch_probe_checked": ("bsearch_probe", ("-DBP_CHECK_BOUNDS",)),
            "csr_walk_checked": ("csr_walk", ("-DCW_CHECK_BOUNDS",)),
            "tree_probe_paged_checked": ("tree_probe_paged",
                                         ("-DTPP_CHECK_BOUNDS",))}
# BC_CHECK_RECORDS in csrc/bounds_check.cuh: the accesses a checked launch
# of its builds keeps
CHECK_RECORDS = 64
ARCH = "arch=compute_90a,code=sm_90a"

_libs: Dict[str, ctypes.CDLL] = {}
_ENTRIES: Dict[tuple, object] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _digest() -> str:
    h = hashlib.sha1()
    for p in sorted(CSRC.iterdir()):
        if p.suffix in (".cu", ".cuh"):
            h.update(p.name.encode())
            h.update(p.read_bytes())
    return h.hexdigest()[:12]


def _target(name: str) -> Path:
    return BUILD_DIR / f"lib{name}-{_digest()}.so"


def build_all(names: Iterable[str] = SOURCES) -> Dict[str, str]:
    """Compile every named source (or ``VARIANTS`` entry) that has no
    current build, one ``nvcc`` process each, all started together.
    Returns name -> the compiler's ``-Xptxas -v`` report (registers,
    shared memory, spills); raises if any build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = _target(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        source, flags = VARIANTS.get(name, (name, ()))
        cmd = [_nvcc(), "-gencode", ARCH, "-std=c++17", "-O3",
               "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
               "-Xptxas", "-v", *flags, "-o", str(tmp),
               str(CSRC / f"{source}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    reports = {}
    failed = []
    for name, (proc, tmp, out) in procs.items():
        text, _ = proc.communicate()
        reports[name] = text
        if proc.returncode != 0:
            failed.append(f"{name}:\n{text}")
            continue
        os.replace(tmp, out)
        (BUILD_DIR / f"{name}.ptxas.txt").write_text(text)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return reports


def ptxas_report(name: str) -> str:
    """The last build's ``-Xptxas -v`` report for ``name`` ('' if none)."""
    p = BUILD_DIR / f"{name}.ptxas.txt"
    return p.read_text() if p.exists() else ""


def library_path(name: str) -> Path:
    """Where the current build of ``csrc/<name>.cu`` lives (or will)."""
    return _target(name)


def library(name: str) -> ctypes.CDLL:
    """The loaded shared library of ``csrc/<name>.cu`` (or of the build
    ``VARIANTS[name]``), built on first use."""
    lib = _libs.get(name)
    if lib is None:
        if not _target(name).exists():
            build_all([name])
        lib = ctypes.CDLL(str(_target(name)))
        _libs[name] = lib
    return lib


def entry(lib: str, name: str, argtypes):
    """``csrc/<lib>.cu``'s C function ``name``, its argument types and its
    int result (a CUDA error code) set once."""
    fn = _ENTRIES.get((lib, name))
    if fn is None:
        fn = getattr(library(lib), name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _ENTRIES[(lib, name)] = fn
    return fn


def check(err: int, what: str) -> None:
    """Raise if a C entry reported a CUDA error (``cudaGetLastError``)."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")


def on_device(device: torch.device):
    """A context in which ``device`` is the current card: none when it
    already is (the usual case), else ``torch.cuda.device``."""
    if device.index is None or device.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(device)


def current_stream(device: torch.device) -> int:
    """The handle of ``device``'s current stream, as a launch takes it:
    the raw query behind ``torch.cuda.current_stream(device).cuda_stream``,
    without building a ``Stream`` object on every call."""
    return torch._C._cuda_getCurrentRawStream(device.index)


def vector_operand(t):
    """``t`` contiguous with a 16-byte-aligned start, as kernels that load
    16-byte vectors need (a contiguous view may start mid-allocation)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def checked_run(check_set, launch, check_get, operands, device,
                records: int) -> dict:
    """One launch of a checked build (``VARIANTS``), its accesses held
    against the byte ranges of ``operands`` (name, tensor or None), then a
    wait for it. ``check_set(lo, hi, n)`` and ``check_get(count, rec)`` are
    the build's C entries, ``launch(stream)`` launches it. Returns
    ``{"count": the accesses outside the ranges, "loads": the first
    recorded, each as (source line, the nearest operand, the access's byte
    offset from that operand's start, the operand's bytes, the access's
    bytes)}``."""
    spans = [(name, t.data_ptr(), t.data_ptr() + t.numel() * t.element_size())
             for name, t in operands if t is not None]
    lo = (ctypes.c_ulonglong * len(spans))(*[a for _, a, _ in spans])
    hi = (ctypes.c_ulonglong * len(spans))(*[b for _, _, b in spans])
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device)
        stream.synchronize()  # the ranges are device globals of the build
        check(check_set(lo, hi, len(spans)), "check_set")
        launch(stream.cuda_stream)
        stream.synchronize()
        count = ctypes.c_uint()
        rec = (ctypes.c_ulonglong * (3 * records))()
        check(check_get(ctypes.byref(count), rec), "check_get")
    loads = []
    for i in range(min(count.value, records)):
        addr, nbytes, line = rec[3 * i], rec[3 * i + 1], rec[3 * i + 2]
        name, a, b = min(spans, key=lambda s: min(abs(addr - s[1]),
                                                  abs(addr - s[2])))
        loads.append((int(line), name, int(addr - a), int(b - a),
                      int(nbytes)))
    return {"count": count.value, "loads": loads}


def bounds_check(lib: str, launch, operands, device) -> dict:
    """``checked_run`` of a build that takes ``csrc/bounds_check.cuh``
    (``VARIANTS[lib]``, whose entries are ``<source>_check_set`` and
    ``<source>_check_get``) on the card ``device``; raises for any other
    device: a checked build never runs the plain version instead."""
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"{lib}: the checked build runs on the card, not "
                         f"on {device}")
    source = VARIANTS[lib][0]
    return checked_run(
        entry(lib, f"{source}_check_set", [ctypes.c_void_p, ctypes.c_void_p,
                                           ctypes.c_int]),
        launch, entry(lib, f"{source}_check_get", [ctypes.c_void_p,
                                                   ctypes.c_void_p]),
        operands, device, CHECK_RECORDS)
