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
from deepspeed_tpu_torch.ops.attention import sparse as tsp
from deepspeed_tpu_torch.ops.kernels import flash_decode as tfd
from deepspeed_tpu_torch.ops.kernels import fused_update as tfu
from deepspeed_tpu_torch.ops.kernels import kernels_report
from deepspeed_tpu_torch.ops.transformer import transformer as ttr

REPO = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((REPO / "deepspeed_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "deepspeed_tpu")
CUDA_SOURCES = sorted((REPO / "deepspeed_tpu_torch" / "csrc").glob("*.cu"))
# the modules of each ported slice; the import walk must reach all of them
SLICE_MODULES = (
    "deepspeed_tpu_torch/__init__.py",
    "deepspeed_tpu_torch/config/config.py",
    "deepspeed_tpu_torch/models/gpt2.py",
    "deepspeed_tpu_torch/models/bert.py",
    "deepspeed_tpu_torch/ops/normalize.py",
    "deepspeed_tpu_torch/ops/attention/flash_attention.py",
    "deepspeed_tpu_torch/ops/attention/sparse.py",
    "deepspeed_tpu_torch/ops/kernels/__init__.py",
    "deepspeed_tpu_torch/ops/kernels/flash_decode.py",
    "deepspeed_tpu_torch/ops/kernels/fused_update.py",
    "deepspeed_tpu_torch/ops/adam/fused_adam.py",
    "deepspeed_tpu_torch/ops/lamb/fused_lamb.py",
    "deepspeed_tpu_torch/runtime/lr_schedules.py",
    "deepspeed_tpu_torch/runtime/fp16/loss_scaler.py",
    "deepspeed_tpu_torch/runtime/engine.py",
    "deepspeed_tpu_torch/inference/engine.py",
    "deepspeed_tpu_torch/serving/engine.py",
    "deepspeed_tpu_torch/resilience/__init__.py",
    "deepspeed_tpu_torch/resilience/atomic.py",
    "deepspeed_tpu_torch/resilience/faults.py",
    "deepspeed_tpu_torch/resilience/manager.py",
    "deepspeed_tpu_torch/resilience/policy.py",
    "deepspeed_tpu_torch/resilience/watchdog.py",
    "deepspeed_tpu_torch/runtime/checkpointing.py",
    "deepspeed_tpu_torch/runtime/dataloader.py",
    "deepspeed_tpu_torch/runtime/overlap/__init__.py",
    "deepspeed_tpu_torch/runtime/overlap/async_writer.py",
    "deepspeed_tpu_torch/runtime/overlap/prefetch.py",
    "deepspeed_tpu_torch/runtime/overlap/timeline.py",
    "deepspeed_tpu_torch/runtime/overlap/worker.py",
    "deepspeed_tpu_torch/serving/kvcache/__init__.py",
    "deepspeed_tpu_torch/serving/kvcache/prefix.py",
    "deepspeed_tpu_torch/serving/kvcache/sessions.py",
    "deepspeed_tpu_torch/serving/kvcache/pages.py",
    "deepspeed_tpu_torch/ops/transformer/transformer.py",
    "deepspeed_tpu_torch/utils/device.py",
    "deepspeed_tpu_torch/comm/topology.py",
    "deepspeed_tpu_torch/comm/distributed.py",
    "deepspeed_tpu_torch/comm/mesh.py",
    "deepspeed_tpu_torch/comm/collectives.py",
    "deepspeed_tpu_torch/comm/strategy.py",
    "deepspeed_tpu_torch/sharding/__init__.py",
    "deepspeed_tpu_torch/sharding/spec.py",
    "deepspeed_tpu_torch/sharding/layout.py",
    "deepspeed_tpu_torch/sharding/update.py",
    "deepspeed_tpu_torch/sharding/rules.py",
    "deepspeed_tpu_torch/sharding/mesh.py",
    "deepspeed_tpu_torch/runtime/zero/stages.py",
    "deepspeed_tpu_torch/runtime/zero/partition.py",
    "deepspeed_tpu_torch/runtime/zero/api.py",
    "deepspeed_tpu_torch/runtime/zero/utils.py",
    "deepspeed_tpu_torch/tools/zero_worker.py",
    "deepspeed_tpu_torch/tools/profile_zero.py",
    "deepspeed_tpu_torch/parallel/__init__.py",
    "deepspeed_tpu_torch/parallel/sequence.py",
    "deepspeed_tpu_torch/parallel/tensor.py",
    "deepspeed_tpu_torch/telemetry/__init__.py",
    "deepspeed_tpu_torch/telemetry/registry.py",
    "deepspeed_tpu_torch/telemetry/spans.py",
    "deepspeed_tpu_torch/telemetry/exporters.py",
    "deepspeed_tpu_torch/telemetry/regression.py",
    "deepspeed_tpu_torch/telemetry/aggregate.py",
    "deepspeed_tpu_torch/telemetry/attribution.py",
    "deepspeed_tpu_torch/telemetry/manager.py",
    "deepspeed_tpu_torch/profiling/flops_profiler.py",
    "deepspeed_tpu_torch/utils/monitor.py",
    "deepspeed_tpu_torch/utils/timer.py",
)
# the layers above the ops, which no op module may import
ABOVE_OPS = ("deepspeed_tpu_torch.models", "deepspeed_tpu_torch.inference",
             "deepspeed_tpu_torch.runtime", "deepspeed_tpu_torch.serving")
OPS_FILES = sorted((REPO / "deepspeed_tpu_torch" / "ops").rglob("*.py"))


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
                                              "fused_adam.cu", "fused_lamb.cu",
                                              "flash_bwd_2pass.cu", "splash_attn.cu"}


@pytest.mark.parametrize("path", OPS_FILES, ids=lambda p: str(p.relative_to(REPO)))
def test_ops_import_nothing_from_the_layers_above(path):
    """The ops are the bottom layer: a model, an engine or the serving
    stack builds on them, never the other way round."""
    bad = []
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        names = ([a.name for a in node.names] if isinstance(node, ast.Import) else
                 [node.module] if isinstance(node, ast.ImportFrom) and node.module else [])
        bad += [(node.lineno, n) for n in names if n.startswith(ABOVE_OPS)]
    assert not bad, f"{path.relative_to(REPO)} imports {bad}"


def test_a_header_edit_rebuilds_only_the_sources_that_include_it(tmp_path, monkeypatch):
    """A built kernel is stale when its source or a csrc/ header that the
    source includes is newer than its library: the flash and splash sources
    follow flash_common.cuh, the optimizer and decode kernels do not."""
    import os
    import shutil

    from deepspeed_tpu_torch.ops import kernels

    csrc = tmp_path / "csrc"
    shutil.copytree(kernels.CSRC_DIR, csrc)
    monkeypatch.setattr(kernels, "CSRC_DIR", csrc)
    lib = kernels.KernelLibrary(tmp_path / "build")
    lib.build_dir.mkdir()
    for src in csrc.iterdir():
        os.utime(src, (1000, 1000))
    for name in kernels.KERNELS:  # every library built after every source
        lib._so_path(name).touch()
        os.utime(lib._so_path(name), (2000, 2000))
    assert not any(lib._stale(name) for name in kernels.KERNELS)
    os.utime(csrc / "flash_common.cuh", (3000, 3000))
    stale = {name for name in kernels.KERNELS if lib._stale(name)}
    assert stale == {"flash_fwd", "flash_bwd", "flash_bwd_dq", "flash_bwd_dkv", "splash_fwd",
                     "splash_bwd_dq", "splash_bwd_dkv"}


def test_tensor_core_bodies_are_libraries_of_their_own(tmp_path, monkeypatch):
    """The bf16 bodies of B1, B2, B6a, B6b, B8, B9a and B9b build from
    their own sources (B6a's and B6b's share one, B8's, B9a's and B9b's
    another), in the same parallel round as the kernels: an edit of
    flash_tc.cuh rebuilds those seven and nothing else, an edit of flash_common.cuh
    rebuilds them with the other attention kernels; the report names each
    beside its kernel's f32 source, and the launch counts stay by
    kernel."""
    import os
    import shutil

    from deepspeed_tpu_torch.ops import kernels

    assert set(kernels.BODIES) == {"flash_fwd_tc", "flash_bwd_tc", "flash_bwd_dq_tc",
                                   "flash_bwd_dkv_tc", "splash_fwd_tc", "splash_bwd_dq_tc",
                                   "splash_bwd_dkv_tc"}
    for body, (src, entry, argtypes) in kernels.BODIES.items():
        kernel = body[:-len("_tc")]
        assert (kernels.CSRC_DIR / src).is_file() and src != kernels.KERNELS[kernel][0]
        assert argtypes == kernels.KERNELS[kernel][2] and entry == f"ds_{body}"
    report = kernels_report()
    assert report["flash_fwd"]["tc_source"].endswith("csrc/flash_fwd_tc.cu")
    assert report["flash_bwd"]["tc_source"].endswith("csrc/flash_bwd_tc.cu")
    assert report["flash_fwd"]["source"].endswith("csrc/flash_fwd.cu")
    for name in ("flash_bwd_dq", "flash_bwd_dkv"):
        assert report[name]["tc_source"].endswith("csrc/flash_bwd_2pass_tc.cu")
        assert report[name]["source"].endswith("csrc/flash_bwd_2pass.cu")
    for name in ("splash_fwd", "splash_bwd_dq", "splash_bwd_dkv"):
        assert report[name]["tc_source"].endswith("csrc/splash_attn_tc.cu")
        assert report[name]["source"].endswith("csrc/splash_attn.cu")
    csrc = tmp_path / "csrc"
    shutil.copytree(kernels.CSRC_DIR, csrc)
    monkeypatch.setattr(kernels, "CSRC_DIR", csrc)
    lib = kernels.KernelLibrary(tmp_path / "build")
    lib.build_dir.mkdir()
    units = [*kernels.KERNELS, *kernels.BODIES]
    assert len({lib._so_path(n) for n in units}) == len(units) - 8  # shared sources
    for src in csrc.iterdir():
        os.utime(src, (1000, 1000))
    for name in units:
        lib._so_path(name).touch()
        os.utime(lib._so_path(name), (2000, 2000))
    os.utime(csrc / "flash_tc.cuh", (3000, 3000))
    tc_bodies = {"flash_fwd_tc", "flash_bwd_tc", "flash_bwd_dq_tc", "flash_bwd_dkv_tc",
                 "splash_fwd_tc", "splash_bwd_dq_tc", "splash_bwd_dkv_tc"}
    assert {n for n in units if lib._stale(n)} == tc_bodies
    os.utime(csrc / "flash_common.cuh", (4000, 4000))
    assert tc_bodies | {"flash_fwd", "flash_bwd", "flash_bwd_dq", "flash_bwd_dkv"} <= {
        n for n in units if lib._stale(n)}
    assert set(lib.launches) == set(kernels.KERNELS)


def test_flash_wrappers_pick_the_body_by_dtype():
    """bf16 goes to the tensor-core body, f32 to the CUDA-core one; the
    launch variant names the body."""
    assert tfa._body("flash_fwd", torch.bfloat16) == ("flash_fwd_tc", "tc")
    assert tfa._body("flash_bwd", torch.bfloat16) == ("flash_bwd_tc", "tc")
    assert tfa._body("flash_fwd", torch.float32) == ("flash_fwd", "simt")
    assert tfa._body("flash_bwd", torch.float32) == ("flash_bwd", "simt")
    for name in ("flash_bwd_dq", "flash_bwd_dkv", "splash_fwd", "splash_bwd_dq",
                 "splash_bwd_dkv"):
        assert tfa._body(name, torch.bfloat16) == (name + "_tc", "tc")
        assert tfa._body(name, torch.float32) == (name, "simt")
    q = torch.zeros(1, 2, 128, 64, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA"):  # bf16 on the CPU: no body at all
        tfa.flash_fwd_cuda(q, q, q, causal=True, sm_scale=0.125)
    lse = torch.zeros(1, 2, 128)
    for launch in (tfa.flash_bwd_dq_cuda, tfa.flash_bwd_dkv_cuda):
        with pytest.raises(ValueError, match="CUDA"):
            launch(q, q, q, q, lse, lse, causal=False, sm_scale=0.125)
    layout = np.tril(np.ones((1, 2, 2), np.uint8))
    with pytest.raises(ValueError, match="CUDA"):
        tsp.splash_fwd_cuda(q, q, q, layout, 64, causal=True, sm_scale=0.125)
    for launch in (tsp.splash_bwd_dq_cuda, tsp.splash_bwd_dkv_cuda):
        with pytest.raises(ValueError, match="CUDA"):
            launch(q, q, q, q, lse, lse, layout, 64, causal=True, sm_scale=0.125)


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
    with pytest.raises(RuntimeError, match="is_available"):
        ttr.DeepSpeedTransformerLayer(ttr.DeepSpeedTransformerConfig(
            hidden_size=64, intermediate_size=128, heads=4))


def test_kernel_launchers_refuse_cpu_tensors():
    q = torch.zeros(1, 2, 128, 64)
    with pytest.raises(ValueError, match="CUDA"):
        tfa.flash_fwd_cuda(q, q, q, causal=True, sm_scale=0.125)
    dq = torch.zeros(1, 2, 1, 64)
    with pytest.raises(ValueError, match="CUDA"):
        tfd.flash_decode_cuda(dq, q, q, torch.zeros(1, dtype=torch.int32))
    pool = torch.zeros(3, 2, 16, 64)
    with pytest.raises(ValueError, match="CUDA"):
        tfd.flash_decode_paged_cuda(dq, pool, pool, torch.zeros(1, 2, dtype=torch.int32),
                                    torch.zeros(1, dtype=torch.int32))
    lse = torch.zeros(1, 2, 128)
    with pytest.raises(ValueError, match="CUDA"):
        tfa.flash_bwd_cuda(q, q, q, q, lse, lse, causal=True, sm_scale=0.125)
    p = torch.zeros(300)
    with pytest.raises(ValueError, match="CUDA"):
        tfu.adam_leaf_cuda(p, p, p, p, torch.ones(4), b1=0.9, b2=0.999, eps=1e-8,
                           weight_decay=0.0, adam_w_mode=True)
    with pytest.raises(ValueError, match="CUDA"):
        tfu.lamb_leaf_cuda(p, p, p, p, torch.ones(4), b1=0.9, b2=0.999, eps=1e-8,
                           weight_decay=0.0, min_coeff=0.01, max_coeff=10.0)
    with pytest.raises(ValueError, match="CUDA"):
        tfa.flash_fwd_cuda(q, q, q, causal=False, sm_scale=0.125, kbias=torch.zeros(1, 128))
    with pytest.raises(ValueError, match="CUDA"):
        tfa.flash_bwd2_cuda(q, q, q, q, lse, lse, causal=False, sm_scale=0.125,
                            kbias=torch.zeros(1, 128))
    layout = np.tril(np.ones((1, 2, 2), np.uint8))
    with pytest.raises(ValueError, match="CUDA"):
        tsp.splash_fwd_cuda(q, q, q, layout, 64, causal=True, sm_scale=0.125)
    with pytest.raises(ValueError, match="CUDA"):
        tsp.splash_bwd_dq_cuda(q, q, q, q, lse, lse, layout, 64, causal=True, sm_scale=0.125)
    with pytest.raises(ValueError, match="CUDA"):
        tsp.splash_bwd_dkv_cuda(q, q, q, q, lse, lse, layout, 64, causal=True, sm_scale=0.125)
    report = kernels_report()
    assert set(report) == {"flash_fwd", "flash_decode", "flash_decode_paged", "flash_bwd",
                           "fused_adam", "fused_lamb_dir", "fused_lamb_apply", "flash_bwd_dq",
                           "flash_bwd_dkv", "splash_fwd", "splash_bwd_dq", "splash_bwd_dkv"}
    assert report["fused_lamb_dir"]["source"] == report["fused_lamb_apply"]["source"]
    assert report["flash_bwd_dq"]["source"] == report["flash_bwd_dkv"]["source"]
    assert report["splash_fwd"]["source"] == report["splash_bwd_dq"]["source"] == \
        report["splash_bwd_dkv"]["source"]
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
