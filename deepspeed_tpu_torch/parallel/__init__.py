"""Parallelism beyond ZeRO's data-parallel grid (counterpart of
``deepspeed_tpu/parallel/``).

* ``sequence`` — ring attention and Ulysses all-to-all attention over the
  ``seq`` axis, and the ambient mesh the models resolve them from.
* ``tensor`` — the Megatron operators over the ``model`` axis: what GSPMD
  inserted around the JAX package's tensor-parallel specs, written out.
"""
from deepspeed_tpu_torch.parallel.sequence import (
    SEQ_AXIS,
    ambient_mesh,
    get_global_mesh,
    ring_attention,
    scoped_to,
    set_global_mesh,
    ulysses_attention,
)

__all__ = ["SEQ_AXIS", "ring_attention", "ulysses_attention", "set_global_mesh",
           "get_global_mesh", "ambient_mesh", "scoped_to"]
