"""ZeRO memory estimators (counterpart of
``deepspeed_tpu/runtime/zero/utils.py``; the same formulas).

Reference: ``runtime/zero/stage2.py`` ``estimate_zero2_model_states_mem_needs``
(:2019) and the stage-3 equivalents — quick planning calculators that
print per-device memory needs for a model size × world size × offload
combination before anyone burns GPUs finding out empirically.

Memory model (bf16 compute, fp32 masters — matching this engine):

* stage 0:  device = 4N (fp32 params) + 4N (grads acc) + 8N (Adam m+v)
* stage 1:  optimizer states sharded over fsdp → 8N/W
* stage 2:  + grads sharded → 4N/W
* stage 3:  + params sharded → 4N/W (gather-on-use working set extra)
* offload_optimizer: masters+moments to host → device keeps 2N (bf16
  params) + grads; host gets 12N
"""
from __future__ import annotations

from typing import Any, Tuple

import numpy as np


def _count(model_params) -> int:
    if isinstance(model_params, (int, np.integer)):
        return int(model_params)
    from deepspeed_tpu_torch.runtime.engine import tree_flatten

    return sum(int(np.prod(np.shape(p))) for p in tree_flatten(model_params)[0])


def _fmt_gb(n_bytes: float) -> str:
    return f"{n_bytes / 2**30:.2f}GB"


def estimate_zero2_model_states_mem_needs(
    total_params: Any,
    num_gpus_per_node: int = 1,
    num_nodes: int = 1,
    cpu_offload: bool = True,
    additional_buffer_factor: float = 1.5,
) -> Tuple[float, float]:
    """Returns (cpu_mem, device_mem) bytes per device for ZeRO-2
    (reference signature preserved)."""
    N = _count(total_params)
    W = max(1, num_gpus_per_node * num_nodes)
    if cpu_offload:
        device = 2 * N + 4 * N / W  # bf16 params + fp32 grad shard
        cpu = 12 * N * additional_buffer_factor  # masters + m + v
    else:
        device = 4 * N + 4 * N / W + 8 * N / W  # fp32 params + grad/opt shards
        cpu = 4 * N * additional_buffer_factor  # host init copy
    return cpu, device


def estimate_zero3_model_states_mem_needs(
    total_params: Any,
    largest_layer_params: int = 0,
    num_gpus_per_node: int = 1,
    num_nodes: int = 1,
    cpu_offload: bool = True,
    cpu_offload_params: bool = False,
    zero_init: bool = True,
    additional_buffer_factor: float = 1.5,
) -> Tuple[float, float, float]:
    """Returns (cpu_mem, device_mem, largest_layer_mem) bytes per device
    for ZeRO-3."""
    N = _count(total_params)
    L = int(largest_layer_params)
    W = max(1, num_gpus_per_node * num_nodes)
    largest = 4 * L  # gathered working set (bf16 fwd+bwd pair)
    if cpu_offload:
        device = (2 * N + 4 * N) / W + largest
        cpu = 12 * N * additional_buffer_factor
    else:
        device = (4 * N + 4 * N + 8 * N) / W + largest
        cpu = (4 * N if not zero_init else 4 * N / W) * additional_buffer_factor
    if cpu_offload_params:
        device = 4 * N / W + largest
        cpu = (12 * N + 2 * N) * additional_buffer_factor
    return cpu, device, largest


def _print_table(rows, header):
    widths = [max(len(str(r[i])) for r in [header] + rows) for i in range(len(header))]
    line = "  ".join(str(h).ljust(w) for h, w in zip(header, widths))
    print(line)
    print("-" * len(line))
    for r in rows:
        print("  ".join(str(c).ljust(w) for c, w in zip(r, widths)))


def estimate_zero2_model_states_mem_needs_all_live(
    model_params: Any, num_gpus_per_node: int = 1, num_nodes: int = 1, additional_buffer_factor: float = 1.5
) -> None:
    """Reference ``estimate_zero2_model_states_mem_needs_all_live``:
    prints the offload matrix for a live params pytree (or a param
    count)."""
    N = _count(model_params)
    print(f"Estimated memory needed for params={N / 1e6:.0f}M, ZeRO-2, "
          f"{num_nodes} node(s) x {num_gpus_per_node} GPU(s)")
    rows = []
    for offload in (True, False):
        cpu, dev = estimate_zero2_model_states_mem_needs(
            N, num_gpus_per_node, num_nodes, cpu_offload=offload, additional_buffer_factor=additional_buffer_factor
        )
        rows.append([_fmt_gb(cpu), _fmt_gb(dev), f"offload_optimizer={'cpu' if offload else 'none'}"])
    _print_table(rows, ["host mem", "per-GPU mem", "options"])


def estimate_zero3_model_states_mem_needs_all_live(
    model_params: Any,
    largest_layer_params: int = 0,
    num_gpus_per_node: int = 1,
    num_nodes: int = 1,
    additional_buffer_factor: float = 1.5,
) -> None:
    N = _count(model_params)
    print(f"Estimated memory needed for params={N / 1e6:.0f}M, ZeRO-3, "
          f"{num_nodes} node(s) x {num_gpus_per_node} GPU(s)")
    rows = []
    for offload, offload_params in ((False, False), (True, False), (True, True)):
        cpu, dev, live = estimate_zero3_model_states_mem_needs(
            N, largest_layer_params, num_gpus_per_node, num_nodes,
            cpu_offload=offload, cpu_offload_params=offload_params,
            additional_buffer_factor=additional_buffer_factor,
        )
        opt = "none" if not offload else ("cpu" if not offload_params else "cpu+params")
        rows.append([_fmt_gb(cpu), _fmt_gb(dev), _fmt_gb(live), f"offload={opt}"])
    _print_table(rows, ["host mem", "per-GPU mem", "gathered layer", "options"])
