"""The kernel library's build bookkeeping, on the CPU (no ``nvcc``: the
compile and the loader are stand-ins).  A unit's first ``fn()`` while
another thread's build compiles its source waits for that build and
loads what it wrote; it never starts a second compile of the source
beside it (the two would share one temporary file)."""
import threading
import time
from unittest import mock

from deepspeed_tpu_torch.ops import kernels


def test_fn_waits_for_its_source_compile_in_flight(tmp_path, monkeypatch):
    lib = kernels.KernelLibrary(build_dir=tmp_path)
    started, release = threading.Event(), threading.Event()
    compiled = []

    def compile_units(todo):
        compiled.append(sorted(todo))
        if not started.is_set():  # the background build holds until released
            started.set()
            assert release.wait(30)
        for name in todo:
            lib._so_path(name).touch()
        return {}

    monkeypatch.setattr(lib, "_build", compile_units)
    monkeypatch.setattr(lib, "_stale", lambda name: not lib._so_path(name).exists())
    monkeypatch.setattr(kernels.ctypes, "CDLL", mock.MagicMock())
    background = threading.Thread(target=lib.build, args=(["flash_bwd_dq", "flash_bwd_dkv"],))
    background.start()
    assert started.wait(30)
    got = []
    # flash_bwd_dkv shares flash_bwd_2pass.cu with the unit in flight
    loader = threading.Thread(target=lambda: got.append(lib.fn("flash_bwd_dkv")))
    loader.start()
    time.sleep(0.2)
    assert got == []  # waiting on the compile in flight
    # a unit of another source builds and loads beside it
    assert lib.fn("fused_adam") is not None
    release.set()
    background.join(30)
    loader.join(30)
    assert got and compiled == [["flash_bwd_dkv", "flash_bwd_dq"], ["fused_adam"]]
