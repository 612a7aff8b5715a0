"""Strategy-selected collectives: one comm layer for every exchange
(counterpart of ``deepspeed_tpu/comm/strategy.py``).

The policy (:func:`select_strategy`) and the per-step byte model
(:func:`step_comm_bytes`) are the JAX package's.  ``dense`` runs
full-precision ``torch.distributed`` collectives (``comm/collectives.py``)
on the process groups of the mesh's axes; ``int8`` (EQuARX-style
quantized all-reduce, ``collectives.quantized_allreduce``) and ``onebit``
(error-feedback sign compression, ``comm/compressed.py``) run through
:meth:`CommLayer.exchange_rows`, once a step, on the rank's own gradient
row.  Every decision lands in ``CommLayer.decisions``, as in the JAX
package.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from deepspeed_tpu_torch.config import constants as C
from deepspeed_tpu_torch.utils.logging import logger

STRATEGY_AUTO = C.COMM_STRATEGY_AUTO
STRATEGY_DENSE = C.COMM_STRATEGY_DENSE
STRATEGY_INT8 = C.COMM_STRATEGY_INT8
STRATEGY_ONEBIT = C.COMM_STRATEGY_ONEBIT


def _torch_dtype(dtype):
    if isinstance(dtype, torch.dtype):
        return dtype
    if isinstance(dtype, str) and isinstance(getattr(torch, dtype, None), torch.dtype):
        return getattr(torch, dtype)
    return None


def _is_float(dtype) -> bool:
    t = _torch_dtype(dtype)
    if t is not None:
        return t.is_floating_point
    return bool(np.issubdtype(np.dtype(dtype), np.floating))


def _dtype_name(dtype) -> str:
    t = _torch_dtype(dtype)
    return str(t).replace("torch.", "") if t is not None else np.dtype(dtype).name


@dataclass(frozen=True)
class Decision:
    """One policy-table row: which strategy a site got, and why."""

    strategy: str
    reason: str


def select_strategy(cfg, nbytes: int, dtype, n_ranks: int, link: str = "ici") -> Decision:
    """Pure policy: strategy for one exchange of ``nbytes`` bytes of
    ``dtype`` across ``n_ranks`` ranks riding ``link`` (``"ici"``,
    ``"dcn"``, or ``"ici+dcn"`` from the mesh topology descriptor),
    under a ``CommConfig``.

    The dense floor applies to every strategy request: quantization of
    integer/bool payloads is meaningless, a single-rank axis moves no
    bytes, and sub-threshold tensors are latency- (not bandwidth-)
    bound, where the quantize/dequantize round trip only adds steps.
    DCN-crossing exchanges hit the bandwidth wall ~25x sooner (per-link
    GB/s gap), so their dense floor is ``comm.dcn_threshold_bytes`` and
    ``auto`` compresses them aggressively (EQuARX motivation: topology
    is a first-class input to comm decisions)."""
    crosses_dcn = link != "ici"
    threshold = cfg.dcn_threshold_bytes if crosses_dcn else cfg.threshold_bytes
    if n_ranks <= 1:
        return Decision(STRATEGY_DENSE, "axis size 1 — nothing crosses the wire")
    if not _is_float(dtype):
        return Decision(STRATEGY_DENSE, f"dtype {_dtype_name(dtype)} is not a float — quantized exchange undefined")
    if nbytes < threshold:
        knob = "comm.dcn_threshold_bytes" if crosses_dcn else "comm.threshold_bytes"
        return Decision(
            STRATEGY_DENSE,
            f"{nbytes} B < {knob} ({threshold}) on {link} — latency-bound, dense wins",
        )
    want = cfg.strategy
    if want == STRATEGY_DENSE:
        if crosses_dcn:
            return Decision(
                STRATEGY_DENSE,
                f"comm.strategy = dense (explicit; NOTE: {link} link — "
                "strategy 'auto' would compress the inter-slice hops)",
            )
        return Decision(STRATEGY_DENSE, "comm.strategy = dense")
    if want == STRATEGY_INT8:
        return Decision(STRATEGY_INT8, f"comm.strategy = int8 ({link})")
    if want == STRATEGY_ONEBIT:
        ef = "with" if cfg.error_feedback else "WITHOUT"
        return Decision(STRATEGY_ONEBIT, f"comm.strategy = onebit ({ef} error feedback, {link})")
    # auto: bandwidth-bound float exchange on a multi-rank grid → int8
    # (stateless + unbiased; onebit needs the residual rows, so it stays
    # an explicit opt-in — its win over int8 is marginal on TPU, where
    # signs ride ICI as int8 anyway; the JAX package's docs/comm.md)
    if crosses_dcn:
        return Decision(
            STRATEGY_INT8,
            f"auto policy: {nbytes} B float over {n_ranks} ranks crosses DCN "
            f"({link}) — compressed inter-slice exchange",
        )
    return Decision(
        STRATEGY_INT8,
        f"auto policy: {nbytes} B float over {n_ranks} ranks is bandwidth-bound",
    )


def strategy_wire_bytes_per_param(strategy: str, grad_bytes: int = 4) -> float:
    """First-order ring-traffic bytes/param of ONE gradient exchange
    (the utils/hlo.py convention: all-reduce counts 2x its payload).

    dense: ring allreduce of fp32 grads = 2 x 4 B.  int8/onebit: int8
    payload crosses twice (scatter-shaped all_to_all + gather-shaped
    all_gather) = 2 x 1 B, plus per-chunk fp32 scales (epsilon).
    """
    if strategy == STRATEGY_DENSE:
        return 2.0 * grad_bytes
    if strategy in (STRATEGY_INT8, STRATEGY_ONEBIT):
        return 2.0
    raise ValueError(f"unknown comm strategy {strategy!r}")


def step_comm_bytes(
    n_params: int,
    mesh_sizes: Dict[str, int],
    stage: int,
    gas: int = 1,
    strategy: str = STRATEGY_DENSE,
    param_bytes: int = 2,
    grad_bytes: int = 4,
    reduce_scatter: bool = True,
    topology=None,
) -> Dict[str, Any]:
    """Per-train-step collective-byte model extending
    :func:`~deepspeed_tpu_torch.runtime.zero.stages.zero_step_comm_model` with
    the strategy-dependent gradient-exchange term.

    The ZeRO model covers the ``fsdp``-axis traffic (param gathers +
    grad reduce-scatter).  This adds the data-parallel grad exchange:
    dense runs per micro batch (the port's engine all-reduces each
    micro-step's whole gradient over ``data``), while the explicit
    compressed strategies accumulate per-rank rows locally and exchange
    ONCE per step — so their byte advantage grows with ``gas``.

    ``topology`` (a :class:`~deepspeed_tpu_torch.sharding.mesh.MeshTopology`)
    splits the grad-exchange term into intra-slice (ICI) and
    inter-slice (DCN) rows when the exchange's grid spans slices.  The
    split is pure *attribution* — ``grad-exchange`` and ``total`` are
    unchanged (the runtime executes one flat exchange): the DCN row —
    the scarce-bandwidth one the policy table keys on — carries 1/ici
    of the ring weight and is gas-independent for the compressed
    strategies.
    """
    from deepspeed_tpu_torch.runtime.zero.stages import zero_step_comm_model

    fsdp = mesh_sizes.get("fsdp", 1)
    data = mesh_sizes.get("data", 1)
    dp = data * fsdp
    base = zero_step_comm_model(
        n_params, fsdp, stage, gas=gas,
        param_bytes=param_bytes, grad_bytes=grad_bytes,
        reduce_scatter=reduce_scatter,
    )
    out = dict(base)
    dp_axes = ("data", "fsdp")
    dcn_ranks = topology.dcn_ranks(dp_axes) if topology is not None else 1
    if dp <= 1:
        ge = 0
    elif strategy == STRATEGY_DENSE:
        # the fsdp-axis share is already in `base`; add the data-axis
        # all-reduce when a pure-data axis exists (per micro batch)
        ge = 2 * n_params * grad_bytes * gas if data > 1 else 0
    else:
        # one whole-grid compressed exchange per step (rows accumulate
        # locally across micro batches): int8 payload both ways + the
        # fp32 scale vectors.  The explicit path replaces the dense grad
        # reduction ENTIRELY — grads never hit the base model's
        # reduce-scatter/all-reduce terms (the post-exchange constraint
        # on the replicated mean is a slice, not a reduce), so zero them
        out["reduce-scatter"] = 0
        out["all-reduce"] = 0
        ge = 2 * n_params + 8 * dp
    if ge > 0 and topology is not None:
        # link-tier attribution of the SAME flat exchange (the runtime
        # executes one flat ring — the split does not change `ge` or
        # `total`, it only names where the bytes ride): a ring over a
        # grid spanning `split_dcn` slices crosses DCN on split_dcn of
        # its hops, so the DCN row carries 1/ici of the ring weight —
        # the scarce-bandwidth row the policy table keys on, and
        # gas-independent for the compressed strategies (their flat ge
        # is).  Dense with data==1 has ge==0 (its fsdp share lives in
        # `base`), so no rows are fabricated for it.
        split_axes = ("data",) if strategy == STRATEGY_DENSE else dp_axes
        grid = data if strategy == STRATEGY_DENSE else dp
        split_dcn = topology.dcn_ranks(split_axes)
        if split_dcn > 1:
            inter = ge * split_dcn // grid  # == ge / ici ranks
            out["grad-exchange-ici"] = int(ge - inter)
            out["grad-exchange-dcn"] = int(inter)
    out["grad-exchange"] = int(ge)
    out["strategy"] = strategy
    out["total"] = int(out["all-gather"] + out["reduce-scatter"] + out["all-reduce"] + ge)
    return out


class CommLayer:
    """Per-engine comm facade: the policy decisions and the explicit rows
    exchange the engine runs (``runtime/engine.py``)."""

    def __init__(self, mesh, mesh_info, config, zero_config=None, topology=None):
        self.mesh = mesh
        self.mesh_info = mesh_info
        self.config = config
        self.zero_config = zero_config
        self.topology = topology
        # site -> Decision: the active strategy table
        self.decisions: Dict[str, Decision] = {}

    def _axis_ranks(self, axes) -> int:
        names = axes if isinstance(axes, (tuple, list)) else (axes,)
        return int(np.prod([self.mesh_info.sizes.get(a, 1) for a in names]))

    def _axis_link(self, axes) -> str:
        """The link kind an exchange over ``axes`` rides (topology row
        key: ici / dcn / ici+dcn)."""
        if self.topology is None:
            return "ici"
        names = axes if isinstance(axes, (tuple, list)) else (axes,)
        links = {self.topology.link(a) for a in names if self.mesh_info.sizes.get(a, 1) > 1}
        if not links or links == {"ici"}:
            return "ici"
        if links == {"dcn"}:
            return "dcn"
        return "ici+dcn"

    def select(self, nbytes: int, dtype, axes, site: str) -> str:
        """Pick and record the strategy for one exchange site, keyed on the
        (size, dtype, rank-count, link) row of the policy table."""
        d = select_strategy(
            self.config, int(nbytes), dtype, self._axis_ranks(axes),
            link=self._axis_link(axes),
        )
        self.decisions[site] = d
        self._publish_decision(site, d.strategy)
        if d.strategy == STRATEGY_DENSE and self.config.strategy in (STRATEGY_INT8, STRATEGY_ONEBIT):
            logger.info(f"comm: site '{site}' stays dense ({d.reason})")
        return d.strategy

    def exchange_rows(self, rows, strategy: str, group=None, generator=None,
                      residuals: Optional[Tuple[Any, Any]] = None):
        """The mean over the exchange's ranks under ``strategy``: ``rows``
        is this rank's row ``(M,)`` on ``group``, or with ``group`` None
        every rank's rows ``(n, M)`` in one process (the plain version,
        nearest rounding for ``int8``).  Returns ``(mean (M,),
        new_residuals | None)``; only ``onebit`` with error feedback takes
        and gives ``residuals`` (``(worker_error, server_error)``, this
        rank's or stacked).  ``generator``: ``int8``'s stochastic rounding
        (``comm.stochastic_rounding``)."""
        from deepspeed_tpu_torch.comm import collectives, compressed

        if strategy == STRATEGY_DENSE:
            if group is None:
                return collectives.dense_allreduce_rows(rows), None
            return collectives.dense_allreduce(rows, group), None
        if strategy == STRATEGY_INT8:
            if group is None:
                return collectives.quantized_allreduce_rows(rows), None
            gen = generator if self.config.stochastic_rounding else None
            return collectives.quantized_allreduce(rows, group, generator=gen), None
        if strategy == STRATEGY_ONEBIT:
            if group is None:
                n, m = rows.shape
                werr, serr = residuals if residuals is not None else (
                    torch.zeros((n, m)), torch.zeros((n, m // n)))
                out, new_werr, new_serr = compressed.compressed_allreduce_rows(rows, werr, serr)
                return out[0], None if residuals is None else (new_werr, new_serr)
            n = collectives.group_size(group)
            if residuals is None:
                # error feedback off: a stateless sign exchange (biased a
                # step; the residual that would carry the bias is dropped)
                zeros = (torch.zeros_like(rows), torch.zeros(rows.shape[0] // n,
                                                             device=rows.device))
                out, _, _ = compressed.compressed_allreduce(rows, *zeros, group)
                return out, None
            out, new_werr, new_serr = compressed.compressed_allreduce(rows, *residuals, group)
            return out, (new_werr, new_serr)
        raise ValueError(f"unknown comm strategy {strategy!r}")

    def note(self, site: str, strategy: str, reason: str) -> None:
        """Record a decision made elsewhere (the engine's forced-dense
        fallbacks, the 1-bit optimizers' momentum exchange)."""
        self.decisions[site] = Decision(strategy, reason)
        self._publish_decision(site, strategy)

    def _publish_decision(self, site: str, strategy: str) -> None:
        """Per-site strategy decisions into the telemetry registry and the
        trace (``comm/decisions``).  Made at engine build or at a phase
        change, never per step."""
        from deepspeed_tpu_torch.telemetry import get_registry, get_tracer

        reg = get_registry()
        if reg.enabled:
            reg.counter("comm/decisions", site=site, strategy=strategy).inc()
        tracer = get_tracer()
        if tracer.enabled:
            tracer.add_instant("comm_decision", "comm", args={"site": site, "strategy": strategy})

    def table(self) -> Dict[str, Tuple[str, str]]:
        return {site: (d.strategy, d.reason) for site, d in sorted(self.decisions.items())}
