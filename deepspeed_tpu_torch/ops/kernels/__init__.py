"""Build, load and count the port's hand-written CUDA kernels.

Each kernel is a plain C entry point in a CUDA C++ source under
``deepspeed_tpu_torch/csrc/`` (two kernels may share a source: B4 and B5
live in ``flash_decode.cu``, LAMB's two passes B7a and B7b in
``fused_lamb.cu``, the two-pass attention backward B6a and B6b in
``flash_bwd_2pass.cu``, the block-sparse forward B8 and its backward B9a
and B9b in ``splash_attn.cu``; the attention sources share the device
functions of ``flash_common.cuh``).  A kernel may have a second body in
a source of its own (:data:`BODIES`): the flash forward, the single-pass
backward, the two passes of the two-pass backward, the block-sparse
forward and its backward's two passes run bf16 tensors on tensor-core bodies
(``flash_fwd_tc.cu``, ``flash_bwd_tc.cu``, ``flash_bwd_2pass_tc.cu``,
``splash_attn_tc.cu``, sharing ``flash_tc.cuh``) and f32 tensors on the
CUDA-core bodies of ``flash_fwd.cu``, ``flash_bwd.cu``,
``flash_bwd_2pass.cu`` and ``splash_attn.cu``; a body counts its launches
under its kernel's name, with the body in the variant.  At
first use the source is compiled with ``nvcc`` for ``sm_90a`` into a
shared library under
``deepspeed_tpu_torch/build/`` (listed in ``.gitignore``) and loaded with
``ctypes``; no PyTorch headers are compiled, so a build takes seconds.
:func:`build` compiles several sources at once, one ``nvcc`` each.

There is no switch between kernels and their plain versions: a wrapper
launches its kernel for a CUDA tensor and takes the plain PyTorch
version for a CPU tensor.  Each wrapper counts its launches here
(:func:`count_launch`), so a run can show which kernels its path went
through, and by variant (:func:`launch_variants`: the attention kernels
name their bias form and dropout), so a run can show which options they
ran with.  Tile sizes are fixed in the sources (the JAX package's block
autotuner is not ported).
"""
from __future__ import annotations

import ctypes
import os
import re
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable, Optional

PACKAGE_DIR = Path(__file__).resolve().parents[2]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "build"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)

_LOCAL_INCLUDE = re.compile(r'^#include "([^"]+)"', re.M)

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_L = ctypes.c_longlong
_U = ctypes.c_uint32

# the extended options every flash-attention entry point takes after its
# tensors: kbias, fbias, fbias's four element strides, dropout, k0, k1,
# threshold, inv_keep
_FLASH_EXT = [_P, _P, _L, _L, _L, _L, _I, _U, _U, _U, _F]

# kernel name -> (source, C entry point, argtypes)
KERNELS = {
    "flash_fwd": (
        "flash_fwd.cu", "ds_flash_fwd",
        # q, k, v, out, lse, <ext>, BH, H, sq, sk, d, dtype, causal, sm_scale, stream
        [_P, _P, _P, _P, _P, *_FLASH_EXT, _I, _I, _I, _I, _I, _I, _I, _F, _P],
    ),
    "flash_decode": (
        "flash_decode.cu", "ds_flash_decode",
        # q, k, v, ks, vs, pos, kpm, ws, out, B, H, S, splits, d, q_dtype, kv_dtype, sm_scale,
        # stream
        [*[_P] * 9, *[_I] * 7, _F, _P],
    ),
    "flash_decode_paged": (
        "flash_decode.cu", "ds_flash_decode_paged",
        # q, k, v, ks, vs, table, pos, ws, out, B, H, P, page_len, num_pages, splits, d, q_dtype,
        # kv_dtype, sm_scale, stream
        [*[_P] * 9, *[_I] * 9, _F, _P],
    ),
    "flash_bwd": (
        "flash_bwd.cu", "ds_flash_bwd",
        # q, k, v, dout, lse, delta, dq32, dq_turn, dk, dv, <ext>, BH, H, sq, sk, d, dtype,
        # causal, sm_scale, stream
        [*[_P] * 10, *_FLASH_EXT, _I, _I, _I, _I, _I, _I, _I, _F, _P],
    ),
    "flash_bwd_dq": (
        "flash_bwd_2pass.cu", "ds_flash_bwd_dq",
        # q, k, v, dout, lse, delta, dq, <ext>, BH, H, sq, sk, d, dtype, causal, sm_scale, stream
        [_P, _P, _P, _P, _P, _P, _P, *_FLASH_EXT, _I, _I, _I, _I, _I, _I, _I, _F, _P],
    ),
    "flash_bwd_dkv": (
        "flash_bwd_2pass.cu", "ds_flash_bwd_dkv",
        # q, k, v, dout, lse, delta, dk, dv, <ext>, BH, H, sq, sk, d, dtype, causal, sm_scale,
        # stream
        [_P, _P, _P, _P, _P, _P, _P, _P, *_FLASH_EXT, _I, _I, _I, _I, _I, _I, _I, _F, _P],
    ),
    "splash_fwd": (
        "splash_attn.cu", "ds_splash_fwd",
        # q, k, v, out, lse, idx, valid, BH, H, LH, T, block, deg, d, dtype, causal, sm_scale,
        # stream
        [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _F, _P],
    ),
    "splash_bwd_dq": (
        "splash_attn.cu", "ds_splash_bwd_dq",
        # q, k, v, dout, lse, delta, dq, idx, valid, BH, H, LH, T, block, deg, d, dtype, causal,
        # sm_scale, stream
        [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _F, _P],
    ),
    "splash_bwd_dkv": (
        "splash_attn.cu", "ds_splash_bwd_dkv",
        # q, k, v, dout, lse, delta, dk, dv, dk32, dv32, qidx, flags, item_col, item_off,
        # col_items, BH, H, LH, T, block, E, W, d, dtype, causal, sm_scale, stream
        [*[_P] * 15, *[_I] * 10, _F, _P],
    ),
    "fused_adam": (
        "fused_adam.cu", "ds_fused_adam",
        # p, g, m, v, scal, n, p_dtype, g_dtype, b1m1, omb1, b2m1, omb2, eps, wd, adam_w_mode, stream
        [_P, _P, _P, _P, _P, _L, _I, _I, _F, _F, _F, _F, _F, _F, _I, _P],
    ),
    "fused_lamb_dir": (
        "fused_lamb.cu", "ds_fused_lamb_dir",
        # p, g, m, v, dir, partials, scal, n, blocks, p_dtype, g_dtype, b1m1, omb1, b2m1, omb2,
        # eps, wd, stream
        [_P, _P, _P, _P, _P, _P, _P, _L, _I, _I, _I, _F, _F, _F, _F, _F, _F, _P],
    ),
    "fused_lamb_apply": (
        "fused_lamb.cu", "ds_fused_lamb_apply",
        # p, dir, scal, trust, n, p_dtype, stream
        [_P, _P, _P, _P, _L, _I, _P],
    ),
}


# a kernel's second body -> (source, C entry point, argtypes): built like a
# kernel, launched by its kernel's wrapper (by dtype) and counted under the
# kernel's name, its variant ending in "/tc" (the tensor-core body) where
# the kernel's own body's ends in "/simt"
BODIES = {
    "flash_fwd_tc": ("flash_fwd_tc.cu", "ds_flash_fwd_tc", KERNELS["flash_fwd"][2]),
    "flash_bwd_tc": ("flash_bwd_tc.cu", "ds_flash_bwd_tc", KERNELS["flash_bwd"][2]),
    "flash_bwd_dq_tc": ("flash_bwd_2pass_tc.cu", "ds_flash_bwd_dq_tc", KERNELS["flash_bwd_dq"][2]),
    "flash_bwd_dkv_tc": ("flash_bwd_2pass_tc.cu", "ds_flash_bwd_dkv_tc",
                         KERNELS["flash_bwd_dkv"][2]),
    "splash_fwd_tc": ("splash_attn_tc.cu", "ds_splash_fwd_tc", KERNELS["splash_fwd"][2]),
    "splash_bwd_dq_tc": ("splash_attn_tc.cu", "ds_splash_bwd_dq_tc", KERNELS["splash_bwd_dq"][2]),
    "splash_bwd_dkv_tc": ("splash_attn_tc.cu", "ds_splash_bwd_dkv_tc",
                          KERNELS["splash_bwd_dkv"][2]),
}
# every library that builds: the kernels and the second bodies
_UNITS = {**KERNELS, **BODIES}


class KernelBuildError(RuntimeError):
    pass


def _nvcc() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
        shutil.which("nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise KernelBuildError(
        "nvcc not found (set CUDA_HOME or put nvcc on PATH); the port's CUDA "
        "kernels are built from source on the machine that has the GPU"
    )


class KernelLibrary:
    """The built kernels of one process: shared libraries, their entry
    points, per-kernel launch counts and the last build's log."""

    def __init__(self, build_dir: Path = BUILD_DIR):
        self.build_dir = Path(build_dir)
        self.launches: Dict[str, int] = {name: 0 for name in KERNELS}
        self.variants: Dict[str, Dict[str, int]] = {name: {} for name in KERNELS}
        self.build_seconds: Dict[str, float] = {}
        self.build_log: Dict[str, str] = {}
        self._fns: Dict[str, ctypes._CFuncPtr] = {}
        self._libs: Dict[str, ctypes.CDLL] = {}
        # the sources a build is compiling now (on any thread): fn() waits
        # for its unit's compile in flight rather than start another beside it
        self._in_flight: set = set()
        self._flight = threading.Condition()

    def _so_path(self, name: str) -> Path:
        return self.build_dir / f"lib{Path(_UNITS[name][0]).stem}.so"

    def _stale(self, name: str) -> bool:
        so = self._so_path(name)
        if not so.exists():
            return True
        # a source's own file and the headers of csrc/ that it includes
        src = CSRC_DIR / _UNITS[name][0]
        deps = [src, *(CSRC_DIR / h for h in _LOCAL_INCLUDE.findall(src.read_text()))]
        return so.stat().st_mtime < max(p.stat().st_mtime for p in deps)

    def build(self, names: Optional[Iterable[str]] = None, force: bool = False) -> Dict[str, float]:
        """Compile the named kernels and bodies (default: all) that are
        missing or older than their source, one ``nvcc`` per source, all
        started together.  Returns the wall seconds of each compile, by
        kernel or body (kernels that share a source share its compile)."""
        names = list(_UNITS if names is None else names)
        with self._flight:
            todo = [n for n in names if force or self._stale(n)]
            sources = {_UNITS[n][0] for n in todo}
            self._in_flight.update(sources)
        try:
            return self._build(todo)
        finally:
            with self._flight:
                self._in_flight.difference_update(sources)
                self._flight.notify_all()

    def _build(self, todo):
        if not todo:
            return {}
        sources = {_UNITS[n][0]: n for n in todo}  # one nvcc per source
        nvcc = _nvcc()
        self.build_dir.mkdir(parents=True, exist_ok=True)
        procs = {}
        t0 = time.perf_counter()
        for src, name in sources.items():
            tmp = self.build_dir / f"lib{Path(src).stem}.{os.getpid()}.tmp.so"
            cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / src)]
            procs[src] = (name, tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
            ))
        failed = []
        for src, (name, tmp, proc) in procs.items():
            log, _ = proc.communicate()
            seconds = time.perf_counter() - t0
            for n in todo:
                if _UNITS[n][0] == src:
                    self.build_seconds[n] = seconds
                    self.build_log[n] = log
            if proc.returncode != 0:
                failed.append(f"{src} (nvcc exit {proc.returncode}):\n{log}")
                continue
            # atomic publish: a concurrent loader never sees half a file
            os.replace(tmp, self._so_path(name))
        if failed:
            raise KernelBuildError("kernel build failed: " + "\n".join(failed))
        return {n: self.build_seconds[n] for n in todo}

    def fn(self, name: str):
        """The C entry point of kernel or body ``name``, built and loaded
        on first use."""
        f = self._fns.get(name)
        if f is None:
            with self._flight:
                self._flight.wait_for(lambda: _UNITS[name][0] not in self._in_flight)
            if self._stale(name):
                self.build([name])
            lib = ctypes.CDLL(str(self._so_path(name)))  # dlopen: one handle per file
            src, entry, argtypes = _UNITS[name]
            f = getattr(lib, entry)
            f.argtypes = argtypes
            f.restype = ctypes.c_int
            lib.ds_error_string.argtypes = [ctypes.c_int]
            lib.ds_error_string.restype = ctypes.c_char_p
            self._libs[name] = lib
            self._fns[name] = f
        return f

    def check(self, name: str, err: int) -> None:
        """Raise when a launch returned a CUDA error (a refused launch
        never runs, and a later synchronize would not report it)."""
        if err:
            msg = self._libs[name].ds_error_string(err).decode()
            raise RuntimeError(f"{name} kernel launch failed: CUDA error {err} ({msg})")

    def reset_launches(self) -> None:
        for name in self.launches:
            self.launches[name] = 0
            self.variants[name] = {}


_LIBRARY = KernelLibrary()


def library() -> KernelLibrary:
    """The process's kernel library (one set of built kernels and launch
    counts per process)."""
    return _LIBRARY


def build(names: Optional[Iterable[str]] = None, force: bool = False) -> Dict[str, float]:
    return _LIBRARY.build(names, force=force)


_COST_SINK = None


def set_cost_sink(sink):
    """Route every launch's analytic cost to ``sink(name, variant, flops,
    nbytes)`` (the telemetry's counted step, ``telemetry/attribution.py``),
    or stop with ``None``; returns the previous sink."""
    global _COST_SINK
    prev, _COST_SINK = _COST_SINK, sink
    return prev


def count_launch(name: str, variant: Optional[str] = None, cost=None) -> None:
    """One launch of kernel ``name``; ``variant`` names the options it ran
    with (for the attention kernels: ``none``, ``kbias`` or ``fbias``, plus
    ``+dropout``; for B1, B2, B6a, B6b, B8, B9a and B9b also the body,
    ``/tc`` or ``/simt``).  ``cost``: a callable giving the launch's
    ``(flops, bytes)`` (the formulas of its bound in ``PERF.md``), called
    only while a cost sink is set."""
    _LIBRARY.launches[name] += 1
    if variant is not None:
        v = _LIBRARY.variants[name]
        v[variant] = v.get(variant, 0) + 1
    sink = _COST_SINK
    if sink is not None and cost is not None:
        flops, nbytes = cost()
        sink(name, variant, float(flops), float(nbytes))


def reset_launches() -> None:
    _LIBRARY.reset_launches()


def launches() -> Dict[str, int]:
    return dict(_LIBRARY.launches)


def launch_variants() -> Dict[str, Dict[str, int]]:
    """Per kernel, its launches since the last :func:`reset_launches` by
    the variant it ran (kernels that name none have an empty dict)."""
    return {name: dict(v) for name, v in _LIBRARY.variants.items()}


def kernels_report() -> Dict[str, Dict[str, object]]:
    """Per kernel: its source (and its second body's, ``tc_source``), whether
    a built library is present, and the launches counted since the last
    :func:`reset_launches`."""
    def rel(src):
        return str((CSRC_DIR / src).relative_to(PACKAGE_DIR.parent))

    report = {
        name: {
            "source": rel(src),
            "built": _LIBRARY._so_path(name).exists(),
            "launches": _LIBRARY.launches[name],
        }
        for name, (src, _, _) in KERNELS.items()
    }
    for body, (src, _, _) in BODIES.items():
        report[body[:-len("_tc")]]["tc_source"] = rel(src)
    return report
