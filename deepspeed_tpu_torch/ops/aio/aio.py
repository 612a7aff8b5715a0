"""Async host I/O — the Python surface over the native engine (counterpart
of ``deepspeed_tpu/ops/aio/aio.py``).

The reference's ``aio_handle(block_size, queue_depth, single_submit,
overlap_events, thread_count)`` with sync/async pread/pwrite and
``wait()``, bound with ``ctypes`` to ``csrc/host/ds_aio.cpp``: kernel AIO
over ``O_DIRECT`` descriptors, and the engine's own C++ thread pool on a
filesystem that refuses ``O_DIRECT`` (``used_kernel_aio`` says which ran).
The library builds with ``g++`` at first use; a failed build raises (the
JAX package's Python thread-pool fallback is not ported).

Buffers are contiguous CPU tensors or numpy arrays of any type; a request
reads or writes their raw bytes at ``file_offset``.  An async request's
buffer must stay alive, and untouched, until :meth:`AioHandle.wait`.
Every submitted byte is counted (:func:`counts`).
"""
from __future__ import annotations

import ctypes
from typing import Dict, Union

import numpy as np
import torch

Buffer = Union[torch.Tensor, np.ndarray]
_P, _L, _I = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int

_counts: Dict[str, int] = {"reads": 0, "writes": 0, "read_bytes": 0, "write_bytes": 0}


def counts() -> Dict[str, int]:
    """Requests and bytes submitted by every handle since :func:`reset_counts`."""
    return dict(_counts)


def reset_counts() -> None:
    for k in _counts:
        _counts[k] = 0


def _lib() -> ctypes.CDLL:
    from deepspeed_tpu_torch.ops.op_builder import load_native

    lib = load_native("ds_aio", ["ds_aio.cpp"], extra_flags=["-pthread"])
    lib.ds_aio_create.restype = _P
    lib.ds_aio_create.argtypes = [_L, _I, _I, _I, _I]
    lib.ds_aio_destroy.argtypes = [_P]
    for fn in (lib.ds_aio_pread, lib.ds_aio_pwrite):
        fn.restype = _L
        fn.argtypes = [_P, _P, _L, ctypes.c_char_p, _L]
    lib.ds_aio_wait.restype = _L
    lib.ds_aio_wait.argtypes = [_P]
    lib.ds_aio_used_kernel_aio.restype = _I
    lib.ds_aio_used_kernel_aio.argtypes = [_P]
    return lib


def _ptr_and_size(buf: Buffer):
    if isinstance(buf, torch.Tensor):
        if buf.device.type != "cpu" or not buf.is_contiguous():
            raise ValueError(f"aio buffers must be contiguous CPU tensors, got {buf.device} "
                             f"contiguous={buf.is_contiguous()}")
        return buf.data_ptr(), buf.numel() * buf.element_size()
    if not buf.flags["C_CONTIGUOUS"]:
        raise ValueError("aio buffers must be contiguous")
    return buf.ctypes.data, buf.nbytes


class AioHandle:
    """``aio_handle`` analog over the native engine."""

    def __init__(self, block_size: int = 1 << 20, queue_depth: int = 8,
                 single_submit: bool = False, overlap_events: bool = True,
                 thread_count: int = 4):
        self.block_size = block_size
        self.queue_depth = queue_depth
        self.thread_count = thread_count
        self._lib = _lib()
        self._h = self._lib.ds_aio_create(block_size, queue_depth, int(single_submit),
                                          int(overlap_events), max(1, thread_count))

    def _submit(self, fn, buffer: Buffer, path: str, file_offset: int, kind: str) -> int:
        ptr, nbytes = _ptr_and_size(buffer)
        r = fn(self._h, ptr, nbytes, path.encode(), file_offset)
        if r < 0:
            raise IOError(f"aio {kind} submit failed for {path}")
        _counts[kind + "s"] += 1
        _counts[kind + "_bytes"] += nbytes
        return int(r)

    def async_pread(self, buffer: Buffer, path: str, file_offset: int = 0) -> int:
        return self._submit(self._lib.ds_aio_pread, buffer, path, file_offset, "read")

    def async_pwrite(self, buffer: Buffer, path: str, file_offset: int = 0) -> int:
        return self._submit(self._lib.ds_aio_pwrite, buffer, path, file_offset, "write")

    def wait(self) -> int:
        """Complete every request in flight; returns how many there were."""
        n = self._lib.ds_aio_wait(self._h)
        if n < 0:
            raise IOError("aio: one or more requests failed")
        return int(n)

    def sync_pread(self, buffer: Buffer, path: str, file_offset: int = 0) -> int:
        self.async_pread(buffer, path, file_offset)
        return self.wait()

    def sync_pwrite(self, buffer: Buffer, path: str, file_offset: int = 0) -> int:
        self.async_pwrite(buffer, path, file_offset)
        return self.wait()

    @property
    def uses_native(self) -> bool:
        return True

    @property
    def used_kernel_aio(self) -> bool:
        """True once a request ran through the ``O_DIRECT`` kernel-AIO
        engine (False: the thread pool served every request)."""
        return bool(self._lib.ds_aio_used_kernel_aio(self._h))

    def __del__(self):
        h, self._h = getattr(self, "_h", None), None
        if h is not None:
            self._lib.ds_aio_destroy(h)


def aio_handle(block_size=1 << 20, queue_depth=8, single_submit=False, overlap_events=True,
               thread_count=4) -> AioHandle:
    """The reference's factory name (``py_ds_aio.cpp`` binds the class as
    ``aio_handle``)."""
    return AioHandle(block_size, queue_depth, single_submit, overlap_events, thread_count)
