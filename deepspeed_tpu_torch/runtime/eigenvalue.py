"""The Hessian's dominant eigenvalue by power iteration (counterpart of
``deepspeed_tpu/runtime/eigenvalue.py``), MoQ's precision gate.

Hessian-vector products are exact, forward over reverse:
``torch.func.jvp(torch.func.grad(f))``, as the JAX package's ``jax.jvp``
over ``jax.grad``.  The port's hand-kernel autograd Functions (flash and
block-sparse attention) are not twice differentiable, as the JAX
package's Pallas ``custom_vjp`` kernels take no ``jvp``: a probe through
them raises.  Probe a model built with plain attention and without remat
(``use_flash_attention=False, remat=False``: ``torch.func`` takes no
checkpoint regions).
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional

import torch
from torch.utils._pytree import tree_flatten, tree_unflatten

from deepspeed_tpu_torch.utils.logging import logger


def _normalize(leaves: List[torch.Tensor]):
    norm = torch.sqrt(sum(torch.sum(torch.square(v.float())) for v in leaves))
    safe = torch.clamp(norm, min=1e-12)
    return [(v / safe).to(v.dtype) for v in leaves], norm


class Eigenvalue:
    """``Eigenvalue(verbose, max_iter, tol, stability, ...)``, as the JAX
    package's; the eigenvalue is over the whole parameter tree given."""

    def __init__(self, verbose: bool = False, max_iter: int = 100, tol: float = 1e-2,
                 stability: float = 1e-6, gas_boundary_resolution: int = 1,
                 layer_name: str = "", layer_num: int = 0):
        self.verbose = verbose
        self.max_iter = max_iter
        self.tol = tol
        self.stability = stability
        self.gas_boundary_resolution = gas_boundary_resolution
        self.layer_name = layer_name
        self.layer_num = layer_num
        self._hvp_cache: Dict[int, Callable] = {}

    def _hvp(self, loss_fn: Callable[[Any], torch.Tensor]) -> Callable:
        """The HVP of ``loss_fn``, built once per function."""
        hvp = self._hvp_cache.get(id(loss_fn))
        if hvp is None:
            grad_fn = torch.func.grad(lambda p: torch.as_tensor(loss_fn(p)).float())

            def hvp(params, vec):
                return torch.func.jvp(grad_fn, (params,), (vec,))[1]

            self._hvp_cache[id(loss_fn)] = hvp
        return hvp

    def compute_eigenvalue(self, loss_fn: Callable[[Any], torch.Tensor], params: Any,
                           generator: Optional[torch.Generator] = None,
                           start: Any = None) -> float:
        """The dominant eigenvalue of the Hessian of ``loss_fn`` at
        ``params`` (a tree of tensors) by power iteration, stopping when
        two estimates agree within ``tol`` (relative).  The start vector is
        normal, drawn from ``generator`` (a CPU generator seeded 0 when
        None; the JAX package draws it from its key: ROADMAP C4), or the
        tree ``start`` given."""
        leaves, spec = tree_flatten(params)
        if start is not None:
            v = [torch.as_tensor(s).to(device=p.device, dtype=p.dtype)
                 for s, p in zip(tree_flatten(start)[0], leaves)]
        else:
            gen = generator if generator is not None else torch.Generator().manual_seed(0)
            v = [torch.randn(p.shape, generator=gen, dtype=torch.float32,
                             device=gen.device).to(device=p.device, dtype=p.dtype)
                 for p in leaves]
        v, _ = _normalize(v)
        hvp = self._hvp(loss_fn)
        eig = 0.0
        for i in range(self.max_iter):
            try:
                hv = hvp(params, tree_unflatten(v, spec))
            except RuntimeError as e:
                if "setup_context" in str(e) or "saved tensor hooks" in str(e):
                    raise RuntimeError(
                        "Eigenvalue: the loss is not twice differentiable here: it runs through "
                        "a hand-kernel autograd Function (flash or block-sparse attention) or a "
                        "checkpoint region; probe a model built with use_flash_attention=False "
                        "and remat=False") from e
                raise
            v, norm = _normalize(tree_flatten(hv)[0])
            new_eig = float(norm)
            if self.verbose:
                logger.info(f"eigenvalue iter {i}: {new_eig:.4e}")
            if eig and abs(new_eig - eig) / (abs(eig) + self.stability) < self.tol:
                eig = new_eig
                break
            eig = new_eig
        return max(eig, self.stability)
