"""`deepspeed.zero`-compatible namespace (counterpart of
``deepspeed_tpu/runtime/zero/api.py``).

* ``Init`` — context manager that cuts a parameter tree to this rank's
  stage-3 shards (``Init.shard(params)``), or a no-op compatibility shim
  around model construction.
* ``GatheredParameters`` — yields a whole host copy of the parameters (an
  engine's are gathered from every rank: call it on every rank).
* ``estimate_zero2/3_model_states_mem_needs`` — the reference's memory
  estimators (stage2.py:2019, stage3.py analog), same formulas as the JAX
  package's.
"""
from __future__ import annotations

import contextlib
from typing import Any, Optional

import numpy as np
import torch

from deepspeed_tpu_torch.runtime.zero.stages import ZeroShardingRules, tree_map_with_path


class Init:
    """Cut params to this rank's fsdp shards at construction time::

        params = zero.Init(mesh=mesh).shard(init_fn())

    ``mesh``: the port's mesh (``comm.mesh.make_mesh``; default: a mesh
    over the started process group).  As a context manager it is a no-op
    shim so reference-style ``with zero.Init():`` blocks still run.
    """

    def __init__(self, mesh=None, config=None, module=None, data_parallel_group=None, **_compat):
        from deepspeed_tpu_torch.config.config import ZeroConfig

        self.mesh = mesh
        self.config = config or ZeroConfig(stage=3)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def shard(self, params: Any, tp_spec_fn=None) -> Any:
        """A tree of this rank's contiguous shards (tensors), each leaf cut
        by its stage-3 parameter spec."""
        mesh = self.mesh
        if mesh is None:
            from deepspeed_tpu_torch.comm.mesh import make_mesh

            mesh = make_mesh()
        rules = ZeroShardingRules(self.config, fsdp_size=mesh.sizes.get("fsdp", 1),
                                  tp_spec_fn=tp_spec_fn)

        def cut(path, leaf):
            t = leaf if isinstance(leaf, torch.Tensor) else torch.from_numpy(np.asarray(leaf))
            return mesh.local_block(t, rules.param_spec(path, tuple(t.shape)))

        return tree_map_with_path(cut, params)


@contextlib.contextmanager
def GatheredParameters(params: Any, modifier_rank: Optional[int] = None, fwd_module=None, enabled: bool = True):
    """Yield a whole host copy of ``params`` (reference
    partition_parameters.py:1079): a tree of arrays or tensors, or an
    engine, whose masters are gathered from every rank."""
    if not enabled:
        yield params
        return
    tree = params.params if hasattr(params, "_params") else params
    yield tree_map_with_path(
        lambda _, p: p.detach().cpu().numpy() if isinstance(p, torch.Tensor) else np.asarray(p),
        tree)


def estimate_zero2_model_states_mem_needs(total_params: int, num_gpus_per_node: int = 1, num_nodes: int = 1, cpu_offload: bool = True, additional_buffer_factor: float = 1.5):
    """Reference stage2.py:2019 formulas (bytes per device / host)."""
    total_gpus = num_nodes * num_gpus_per_node
    if cpu_offload:
        gpu_mem = 2 * total_params  # bf16 params
        cpu_mem = total_params * max(4 * total_gpus, 16) * additional_buffer_factor
    else:
        gpu_mem = 4 * total_params + 16 * total_params / total_gpus
        cpu_mem = total_params * 4 * num_gpus_per_node * additional_buffer_factor
    return int(cpu_mem), int(gpu_mem)


def estimate_zero3_model_states_mem_needs(total_params: int, largest_layer_params: int = 0, num_gpus_per_node: int = 1, num_nodes: int = 1, cpu_offload: bool = True, cpu_offload_params: bool = False, zero_init: bool = True, additional_buffer_factor: float = 1.5):
    total_gpus = num_nodes * num_gpus_per_node
    gpu_mem_largest = 4 * largest_layer_params
    if cpu_offload:
        if cpu_offload_params:
            gpu_mem = gpu_mem_largest
            cpu_mem = total_params * max(4 * total_gpus, 18) * additional_buffer_factor
        else:
            gpu_mem = gpu_mem_largest + 2 * total_params / total_gpus
            cpu_mem = total_params * max(4 * total_gpus, 16) * additional_buffer_factor
    else:
        gpu_mem = gpu_mem_largest + 18 * total_params / total_gpus
        cpu_mem = total_params * 4 * num_gpus_per_node * additional_buffer_factor if zero_init else 0
    return int(cpu_mem), int(gpu_mem)
