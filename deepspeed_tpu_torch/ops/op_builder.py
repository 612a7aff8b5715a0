"""Host (C++) op builder (counterpart of ``deepspeed_tpu/ops/op_builder.py``).

The port's device kernels build with ``nvcc`` (``ops/kernels``); the host
code of ZeRO-Offload and ZeRO-Infinity — the OpenMP Adam
(``csrc/host/cpu_adam.cpp``) and the async disk I/O engine
(``csrc/host/ds_aio.cpp``) — builds here with ``g++`` at first use into
``deepspeed_tpu_torch/build/host/<name>-<hash>.so`` and loads with
``ctypes``.

Differences from the JAX package's builder:

* the library is written under a temporary name and moved into place with
  ``os.replace``, so processes that build at once (test workers) never
  load a half-written file;
* the hash covers the sources, the flags, ``g++ --version`` and the host
  CPU's model and flags, so a ``-march=native`` library is never reused
  on another host;
* a failed build raises with the compiler's stderr: there is no Python
  fallback.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Dict, List, Optional

from deepspeed_tpu_torch.utils.logging import logger

PACKAGE_DIR = Path(__file__).resolve().parents[1]
HOST_CSRC_DIR = PACKAGE_DIR / "csrc" / "host"
BUILD_DIR = PACKAGE_DIR / "build" / "host"

BASE_FLAGS = ["-O3", "-std=c++17", "-shared", "-fPIC", "-fopenmp", "-Wall"]
ARCH_FLAGS = ["-march=native", "-funroll-loops"]

_LOADED: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def _host_fingerprint() -> bytes:
    """``g++ --version`` and the CPU's model name and feature flags (the
    first processor's lines of ``/proc/cpuinfo``)."""
    out = subprocess.run(["g++", "--version"], capture_output=True, text=True, check=True).stdout
    cpu = []
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                key = line.split(":", 1)[0].strip()
                if key in ("model name", "flags") and key not in dict(cpu):
                    cpu.append((key, line.strip()))
    except OSError:
        pass
    return (out + "\n".join(v for _, v in cpu)).encode()


def _source_hash(paths: List[Path], flags: List[str]) -> str:
    h = hashlib.sha256()
    for p in sorted(paths):
        h.update(p.read_bytes())
    h.update(" ".join(flags).encode())
    h.update(_host_fingerprint())
    return h.hexdigest()[:16]


def build_native(name: str, sources: List[str], extra_flags: Optional[List[str]] = None) -> str:
    """Compile ``sources`` (paths relative to ``csrc/host``) into
    ``build/host/<name>-<hash>.so`` and return its path; an existing
    library of the same hash is reused.  Raises ``RuntimeError`` with the
    compiler's stderr when ``g++`` fails."""
    srcs = [Path(s) if os.path.isabs(s) else HOST_CSRC_DIR / s for s in sources]
    flags = BASE_FLAGS + ARCH_FLAGS + list(extra_flags or [])
    out = BUILD_DIR / f"{name}-{_source_hash(srcs, flags)}.so"
    if out.exists():
        return str(out)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.{threading.get_ident()}.tmp")
    res = subprocess.run(["g++", *flags, *map(str, srcs), "-o", str(tmp)],
                         capture_output=True, text=True)
    if res.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"host build of '{name}' failed (g++ exit {res.returncode}):\n"
                           f"{res.stderr[-4000:]}")
    os.replace(tmp, out)
    logger.info(f"built host op '{name}' -> {out}")
    return str(out)


def load_native(name: str, sources: List[str], extra_flags: Optional[List[str]] = None) -> ctypes.CDLL:
    """The loaded library (built first if needed), once per process."""
    with _LOCK:
        lib = _LOADED.get(name)
        if lib is None:
            lib = _LOADED[name] = ctypes.CDLL(build_native(name, sources, extra_flags))
        return lib
