"""Build, load and count the port's hand-written CUDA kernels.

Each kernel is one CUDA C++ source under ``deepspeed_tpu_torch/csrc/``
with a plain C entry point.  At first use the source is compiled with
``nvcc`` for ``sm_90a`` into a shared library under
``deepspeed_tpu_torch/build/`` (listed in ``.gitignore``) and loaded with
``ctypes``; no PyTorch headers are compiled, so a build takes seconds.
:func:`build` compiles several sources at once, one ``nvcc`` each.

There is no switch between kernels and their plain versions: a wrapper
launches its kernel for a CUDA tensor and takes the plain PyTorch
version for a CPU tensor.  Each wrapper counts its launches here
(:func:`count_launch`), so a run can show which kernels its path went
through.  Tile sizes are fixed in the sources (the JAX package's block
autotuner is not ported).
"""
from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
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

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_L = ctypes.c_longlong

# kernel name -> (source, C entry point, argtypes)
KERNELS = {
    "flash_fwd": (
        "flash_fwd.cu", "ds_flash_fwd",
        # q, k, v, out, lse, BH, sq, sk, d, dtype, causal, sm_scale, stream
        [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _P],
    ),
    "flash_decode": (
        "flash_decode.cu", "ds_flash_decode",
        # q, k, v, ks, vs, pos, kpm, out, B, H, S, d, q_dtype, kv_dtype, sm_scale, stream
        [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _P],
    ),
    "flash_bwd": (
        "flash_bwd.cu", "ds_flash_bwd",
        # q, k, v, dout, lse, delta, dq32, dk, dv, BH, sq, sk, d, dtype, causal, sm_scale, stream
        [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _P],
    ),
    "fused_adam": (
        "fused_adam.cu", "ds_fused_adam",
        # p, g, m, v, scal, n, p_dtype, g_dtype, b1m1, omb1, b2m1, omb2, eps, wd, adam_w_mode, stream
        [_P, _P, _P, _P, _P, _L, _I, _I, _F, _F, _F, _F, _F, _F, _I, _P],
    ),
}


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
        self.build_seconds: Dict[str, float] = {}
        self.build_log: Dict[str, str] = {}
        self._fns: Dict[str, ctypes._CFuncPtr] = {}
        self._libs: Dict[str, ctypes.CDLL] = {}

    def _so_path(self, name: str) -> Path:
        return self.build_dir / f"lib{name}.so"

    def _stale(self, name: str) -> bool:
        so = self._so_path(name)
        src = CSRC_DIR / KERNELS[name][0]
        return not so.exists() or so.stat().st_mtime < src.stat().st_mtime

    def build(self, names: Optional[Iterable[str]] = None, force: bool = False) -> Dict[str, float]:
        """Compile the named kernels (default: all) that are missing or
        older than their source, one ``nvcc`` per source, all started
        together.  Returns the wall seconds of each compile."""
        names = list(KERNELS if names is None else names)
        todo = [n for n in names if force or self._stale(n)]
        if not todo:
            return {}
        nvcc = _nvcc()
        self.build_dir.mkdir(parents=True, exist_ok=True)
        procs = {}
        t0 = time.perf_counter()
        for name in todo:
            tmp = self.build_dir / f"lib{name}.{os.getpid()}.tmp.so"
            cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / KERNELS[name][0])]
            procs[name] = (tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
            ))
        failed = []
        for name, (tmp, proc) in procs.items():
            log, _ = proc.communicate()
            self.build_seconds[name] = time.perf_counter() - t0
            self.build_log[name] = log
            if proc.returncode != 0:
                failed.append(f"{name} (nvcc exit {proc.returncode}):\n{log}")
                continue
            # atomic publish: a concurrent loader never sees half a file
            os.replace(tmp, self._so_path(name))
        if failed:
            raise KernelBuildError("kernel build failed: " + "\n".join(failed))
        return {n: self.build_seconds[n] for n in todo}

    def fn(self, name: str):
        """The C entry point of kernel ``name``, built and loaded on first
        use."""
        f = self._fns.get(name)
        if f is None:
            if self._stale(name):
                self.build([name])
            lib = ctypes.CDLL(str(self._so_path(name)))
            src, entry, argtypes = KERNELS[name]
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


_LIBRARY = KernelLibrary()


def library() -> KernelLibrary:
    """The process's kernel library (one set of built kernels and launch
    counts per process)."""
    return _LIBRARY


def build(names: Optional[Iterable[str]] = None, force: bool = False) -> Dict[str, float]:
    return _LIBRARY.build(names, force=force)


def count_launch(name: str) -> None:
    _LIBRARY.launches[name] += 1


def reset_launches() -> None:
    _LIBRARY.reset_launches()


def launches() -> Dict[str, int]:
    return dict(_LIBRARY.launches)


def kernels_report() -> Dict[str, Dict[str, object]]:
    """Per kernel: its source, whether a built library is present, and
    the launches counted since the last :func:`reset_launches`."""
    return {
        name: {
            "source": str((CSRC_DIR / src).relative_to(PACKAGE_DIR.parent)),
            "built": _LIBRARY._so_path(name).exists(),
            "launches": _LIBRARY.launches[name],
        }
        for name, (src, _, _) in KERNELS.items()
    }
