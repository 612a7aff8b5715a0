"""Rules of the PyTorch port (deepspeed_tpu_torch) that hold on any machine:
it imports neither JAX nor the JAX package, its entry points do not drift
to the CPU when no card is present, its kernel launchers refuse CPU
tensors, its CUDA sources stay free of PyTorch's headers (so the ctypes
build takes seconds), and the JAX package's GPT-2 parameters carry over
unchanged."""
import ast
from pathlib import Path

import numpy as np
import pytest
import torch

import deepspeed_tpu_torch
from deepspeed_tpu.models import gpt2 as jgpt2
from deepspeed_tpu_torch.models import gpt2 as tgpt2
from deepspeed_tpu_torch.ops.attention import flash_attention as tfa
from deepspeed_tpu_torch.ops.kernels import flash_decode as tfd
from deepspeed_tpu_torch.ops.kernels import fused_update as tfu
from deepspeed_tpu_torch.ops.kernels import kernels_report

REPO = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((REPO / "deepspeed_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "deepspeed_tpu")
CUDA_SOURCES = sorted((REPO / "deepspeed_tpu_torch" / "csrc").glob("*.cu"))
# the modules of each ported slice; the import walk must reach all of them
SLICE_MODULES = (
    "deepspeed_tpu_torch/__init__.py",
    "deepspeed_tpu_torch/config/config.py",
    "deepspeed_tpu_torch/models/gpt2.py",
    "deepspeed_tpu_torch/ops/normalize.py",
    "deepspeed_tpu_torch/ops/attention/flash_attention.py",
    "deepspeed_tpu_torch/ops/kernels/__init__.py",
    "deepspeed_tpu_torch/ops/kernels/flash_decode.py",
    "deepspeed_tpu_torch/ops/kernels/fused_update.py",
    "deepspeed_tpu_torch/ops/adam/fused_adam.py",
    "deepspeed_tpu_torch/runtime/lr_schedules.py",
    "deepspeed_tpu_torch/runtime/fp16/loss_scaler.py",
    "deepspeed_tpu_torch/runtime/engine.py",
    "deepspeed_tpu_torch/inference/engine.py",
    "deepspeed_tpu_torch/serving/engine.py",
)


def _imported_roots(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.lineno, node.module.split(".")[0]


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(REPO)))
def test_port_imports_no_jax_and_nothing_of_the_jax_package(path):
    bad = [(line, root) for line, root in _imported_roots(path) if root in FORBIDDEN]
    assert not bad, f"{path.relative_to(REPO)} imports {bad}"


def test_import_walk_covers_every_slice_module():
    walked = {str(p.relative_to(REPO)) for p in PORT_FILES}
    missing = [m for m in SLICE_MODULES if m not in walked]
    assert not missing, missing
    assert {p.name for p in CUDA_SOURCES} >= {"flash_fwd.cu", "flash_decode.cu", "flash_bwd.cu",
                                              "fused_adam.cu"}


@pytest.mark.parametrize("path", CUDA_SOURCES, ids=lambda p: p.name)
def test_cuda_sources_include_no_pytorch_headers(path):
    """Each kernel builds with a plain C interface and ctypes: a source
    that included torch/ATen/c10 headers would take minutes to compile."""
    includes = [ln.strip() for ln in path.read_text().splitlines() if ln.strip().startswith("#include")]
    bad = [ln for ln in includes if any(h in ln for h in ("torch/", "ATen/", "c10/", "pybind11"))]
    assert not bad, f"{path.name} includes {bad}"
    assert any("cuda_runtime.h" in ln for ln in includes)


def test_entry_points_raise_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        deepspeed_tpu_torch.init_inference(model="tiny")
    with pytest.raises(RuntimeError, match="is_available"):
        deepspeed_tpu_torch.init_serving(model="tiny")
    model_fn, init_fn, _ = tgpt2.make_model(tgpt2.GPT2_TINY)
    with pytest.raises(RuntimeError, match="is_available"):
        deepspeed_tpu_torch.initialize(model=model_fn, model_parameters=init_fn(seed=0),
                                       config={"train_batch_size": 2})


def test_kernel_launchers_refuse_cpu_tensors():
    q = torch.zeros(1, 2, 128, 64)
    with pytest.raises(ValueError, match="CUDA"):
        tfa.flash_fwd_cuda(q, q, q, causal=True, sm_scale=0.125)
    dq = torch.zeros(1, 2, 1, 64)
    with pytest.raises(ValueError, match="CUDA"):
        tfd.flash_decode_cuda(dq, q, q, torch.zeros(1, dtype=torch.int32))
    lse = torch.zeros(1, 2, 128)
    with pytest.raises(ValueError, match="CUDA"):
        tfa.flash_bwd_cuda(q, q, q, q, lse, lse, causal=True, sm_scale=0.125)
    p = torch.zeros(300)
    with pytest.raises(ValueError, match="CUDA"):
        tfu.adam_leaf_cuda(p, p, p, p, torch.ones(4), b1=0.9, b2=0.999, eps=1e-8,
                           weight_decay=0.0, adam_w_mode=True)
    report = kernels_report()
    assert set(report) == {"flash_fwd", "flash_decode", "flash_bwd", "fused_adam"}
    assert all(r["launches"] == 0 for r in report.values())
    assert all((REPO / r["source"]).is_file() for r in report.values())


def test_params_from_jax_round_trips_shapes_and_values():
    cfg = jgpt2.GPT2Config(vocab_size=96, n_positions=32, n_embd=32, n_layer=2, n_head=4)
    tree = jgpt2.init_params(cfg, seed=3)
    got = tgpt2.params_from_jax(tree)
    assert set(got) == set(tree) and set(got["blocks"]) == set(tree["blocks"])
    for name in ("wte", "wpe", "lnf_g", "lnf_b"):
        np.testing.assert_array_equal(got[name].numpy(), np.asarray(tree[name]))
    for name, a in tree["blocks"].items():
        t = got["blocks"][name]
        assert t.dtype == torch.float32 and tuple(t.shape) == np.shape(a)
        np.testing.assert_array_equal(t.numpy(), np.asarray(a))
    # (in, out) layout kept: x @ qkv_w projects d -> 3d on both sides
    assert tuple(got["blocks"]["qkv_w"].shape) == (2, 32, 96)
    # the port's own numpy init draws the same values as the JAX package's
    mine = tgpt2.init_params(tgpt2.GPT2Config(vocab_size=96, n_positions=32, n_embd=32,
                                              n_layer=2, n_head=4), seed=3)
    np.testing.assert_array_equal(mine["blocks"]["fc_proj_w"], tree["blocks"]["fc_proj_w"])
    bf = tgpt2.params_from_jax(tree, dtype=torch.bfloat16)
    assert bf["wte"].dtype == torch.bfloat16
