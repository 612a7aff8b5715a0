"""Mixture-of-experts with expert parallelism over the ``expert`` axis
(counterpart of ``deepspeed_tpu/moe/layer.py``).

The routing contract is the JAX package's, step for step
(:func:`route`): the router's softmax in f32; top-k by repeated argmax
with the earlier picks masked (ties to the first index, as
``jnp.argmax``); the experts' capacity shared across the k rounds through
``fill``; a token's slot in its expert's buffer from an exclusive cumsum;
picks past the capacity dropped with their gate zeroed; pads
(``token_mask``) routed nowhere and left out of the aux loss; ``aux = E *
sum(mean_prob * frac_tokens)`` with ``frac_tokens`` from round 0.

Where the JAX package builds dense ``(T, E, C)`` dispatch and combine
tensors and contracts them with einsums (``4 E C T D`` FLOPs a layer),
:func:`moe_ffn` moves rows by index: each expert slot holds at most one
token, so the dispatch is one row gather (``index_select``) and the
combine adds, for every token, its at most ``k`` gated expert rows, in
f32 — the same sums, one nonzero term a slot.  :func:`top_k_gating`
still returns the dense tensors (the JAX package's public form).

**Expert parallelism** (an ``expert`` axis of ``ep`` ranks in the ambient
mesh): every ``expert`` rank sees the same tokens (the batch is cut over
``data x fsdp`` only) and holds its ``E / ep`` experts' leaves (``w1``,
``b1``, ``w2``, ``b2`` cut on their expert dimension, ``gate_w``
replicated).  Each rank computes the same routing, runs its own experts
and combines their rows; the partial sums are added over the group
(:func:`reduce_from_expert`, counted as ``expert-all-reduce``).  The
tokens and the gates enter the experts through :func:`copy_to_expert`,
whose backward sums their gradients over the group, so everything
outside the expert FFNs (attention, norms, router, embeddings, and the
aux loss's path) gets its whole gradient once on every rank — never
``ep`` times.  :func:`expert_comm_model` is the byte model beside the
count.  Where JAX's GSPMD picks its own all-to-alls, this is a sum over
the group (ROADMAP C4).

**Tensor parallelism** of the experts (a ``model`` axis): ``w1``/``b1``
cut on the hidden dimension, ``w2`` on its rows, as the family table
says; the expert buffer enters through ``copy_to_model`` and leaves
through ``reduce_from_model`` before ``b2``.

Inside :func:`record_drops` the dropped assignments are counted and,
for each call, which tokens lost a pick — what a server needs to tell a
capacity drop from a wrong token; outside it the layer counts nothing.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from deepspeed_tpu_torch.comm import collectives
# the partition-rule table's MoE specs, re-exported as the JAX package does
from deepspeed_tpu_torch.sharding.rules import moe_param_specs  # noqa: F401

EXPERT_AXIS = "expert"
EXPERT_ALL_REDUCE = "expert-all-reduce"
MOE_ROUTING = "moe-routing"


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    d_model: int
    d_ff: int
    top_k: int = 2
    capacity_factor: float = 1.25
    eval_capacity_factor: float = 2.0
    min_capacity: int = 4
    # router jitter (training only), as in the Switch Transformer; the
    # aux-loss weight is the caller's (moe_ffn returns the unweighted loss)
    router_jitter: float = 0.0


def init_moe_params(cfg: MoEConfig, rng: np.random.Generator, std: float = 0.02,
                    proj_std: Optional[float] = None) -> Dict[str, Any]:
    """Expert FFN and router weights, experts stacked on dim 0: the JAX
    package's draws from the same numpy generator, in the same order."""
    if proj_std is None:
        proj_std = std
    E, D, Fd = cfg.num_experts, cfg.d_model, cfg.d_ff
    return {
        "gate_w": (rng.standard_normal((D, E)) * std).astype(np.float32),
        "w1": (rng.standard_normal((E, D, Fd)) * std).astype(np.float32),
        "b1": np.zeros((E, Fd), np.float32),
        "w2": (rng.standard_normal((E, Fd, D)) * proj_std).astype(np.float32),
        "b2": np.zeros((E, D), np.float32),
    }


def _capacity(tokens: int, num_experts: int, factor: float, min_capacity: int) -> int:
    cap = int(np.ceil(tokens / num_experts * factor))
    return max(cap, min_capacity)


# ---------------------------------------------------------------------------
# the expert group
# ---------------------------------------------------------------------------

class EPGroup:
    """The ``expert`` group of one rank: the process group, its size and
    this rank's place (its block of experts)."""

    __slots__ = ("group", "size", "rank")

    def __init__(self, group, size: int, rank: int):
        self.group, self.size, self.rank = group, int(size), int(rank)


def expert_group(mesh=None) -> Optional[EPGroup]:
    """The ambient (or given) mesh's ``expert`` group; None where the axis
    has one rank or no mesh is set."""
    if mesh is None:
        from deepspeed_tpu_torch.parallel.sequence import get_global_mesh

        mesh = get_global_mesh()
    if mesh is None or mesh.sizes.get(EXPERT_AXIS, 1) <= 1:
        return None
    return EPGroup(mesh.group((EXPERT_AXIS,)), mesh.sizes[EXPERT_AXIS], mesh.coords[EXPERT_AXIS])


class _CopyToExpert(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return collectives.all_reduce(g.clone(), ctx.group, kind=EXPERT_ALL_REDUCE), None


class _ReduceFromExpert(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return collectives.all_reduce(x.clone(), group, kind=EXPERT_ALL_REDUCE)

    @staticmethod
    def backward(ctx, g):
        return g, None


class RouteGroup:
    """The data-parallel grid (``data x fsdp``) a training step routes
    over: its process group, its size, this rank's chunk of the global
    batch and the gather's chunk order (``comm/mesh.py``)."""

    __slots__ = ("group", "size", "rank", "order")

    def __init__(self, group, size: int, rank: int, order):
        self.group, self.size, self.rank, self.order = group, int(size), int(rank), order


def route_group(mesh=None) -> Optional[RouteGroup]:
    """The ambient (or given) mesh's ``data x fsdp`` grid; None for one
    rank.  The JAX package routes the global batch (its arrays are
    global), so a training step routes every rank's tokens together."""
    if mesh is None:
        from deepspeed_tpu_torch.parallel.sequence import get_global_mesh

        mesh = get_global_mesh()
    axes = ("data", "fsdp")
    if mesh is None or mesh.size(axes) <= 1:
        return None
    return RouteGroup(mesh.group(axes), mesh.size(axes), mesh.chunk_index(axes),
                      mesh.chunk_order(axes))


def copy_to_expert(x: torch.Tensor, ep: Optional[EPGroup]) -> torch.Tensor:
    """``x`` as it is; its gradient summed over the ``expert`` group."""
    return x if ep is None else _CopyToExpert.apply(x, ep.group)


def reduce_from_expert(x: torch.Tensor, ep: Optional[EPGroup]) -> torch.Tensor:
    """``x`` summed over the ``expert`` group; its gradient as it is."""
    return x if ep is None else _ReduceFromExpert.apply(x, ep.group)


def expert_comm_model(n_layer: int, tokens: int, d_model: int, top_k: int, ep: int,
                      act_bytes: int, recompute: bool = False) -> int:
    """``expert-all-reduce`` bytes of one training micro-step on one rank
    (``comm/collectives.py``'s convention: an all-reduce twice its
    payload), ``tokens`` the rows x positions a rank routes: per MoE
    layer the f32 combine (``tokens x d_model``) forward — twice where a
    checkpointed block's recompute runs it again (``recompute``) — and, in
    the backward, the tokens' gradient (``act_bytes``) and the gates' (``k
    x tokens`` f32).  Zero at one rank."""
    if ep <= 1:
        return 0
    fwd = 2 * tokens * d_model * 4 * (2 if recompute else 1)
    return n_layer * (fwd + 2 * tokens * d_model * act_bytes + 2 * top_k * tokens * 4)


# ---------------------------------------------------------------------------
# routing
# ---------------------------------------------------------------------------

class Routing(NamedTuple):
    """Per round ``r`` and token ``t``: the expert picked, the slot in its
    buffer, whether the pick is kept (routed and within capacity), the
    gate (the pick's probability, zero where dropped or a pad) and whether
    the token routes at all; with the aux loss."""

    expert: torch.Tensor   # (k, T) int64
    pos: torch.Tensor      # (k, T) int64
    kept: torch.Tensor     # (k, T) bool
    gate: torch.Tensor     # (k, T) f32
    routed: torch.Tensor   # (T,) bool
    aux: torch.Tensor      # () f32


def _jitter(logits: torch.Tensor, generator: torch.Generator, jitter: float) -> torch.Tensor:
    """``logits * U(1 - jitter, 1 + jitter)``; the draw comes from
    ``generator`` on its own device (another stream than JAX's PRNG,
    ROADMAP C4)."""
    u = torch.rand(logits.shape, generator=generator, device=generator.device)
    u = u.to(logits.device) * (2.0 * jitter) + (1.0 - jitter)
    return logits * u


def route(logits: torch.Tensor, top_k: int, capacity: int,
          generator: Optional[torch.Generator] = None, jitter: float = 0.0,
          token_mask: Optional[torch.Tensor] = None) -> Routing:
    """GShard top-k routing of ``logits`` (T, E) with static capacity: the
    JAX package's ``top_k_gating`` without its dense tensors."""
    T, E = logits.shape
    if generator is not None and jitter > 0.0:
        logits = _jitter(logits, generator, jitter)
    probs = torch.softmax(logits.float(), dim=-1)                       # (T, E)
    if token_mask is None:
        tmask = torch.ones((T,), dtype=torch.float32, device=logits.device)
        n_real = torch.tensor(float(T), device=logits.device)
    else:
        tmask = token_mask.reshape(T).float()
        n_real = torch.clamp(tmask.sum(), min=1.0)
    routed = tmask > 0
    masked = probs
    fill = torch.zeros((E,), dtype=torch.int64, device=logits.device)
    experts, slots, kept, gates = [], [], [], []
    frac_tokens = None
    for r in range(top_k):
        idx = torch.argmax(masked, dim=-1)                              # first max on ties
        onehot = F.one_hot(idx, E) * routed[:, None]                    # (T, E) int; pads none
        gate = probs.gather(1, idx[:, None])[:, 0] * tmask
        # exclusive cumsum: the earlier tokens of this round on the same expert
        pos = ((torch.cumsum(onehot, dim=0) - onehot) * onehot).sum(-1) + fill[idx] * routed
        keep = (pos < capacity) & routed
        gates.append(gate * keep)
        fill = fill + (onehot * keep[:, None]).sum(0)
        if r == 0:
            frac_tokens = onehot.sum(0).float() / n_real
        masked = masked * (1.0 - onehot.float())
        experts.append(idx)
        slots.append(pos)
        kept.append(keep)
    mean_prob = (probs * tmask[:, None]).sum(0) / n_real
    aux = E * torch.sum(mean_prob * frac_tokens)
    return Routing(torch.stack(experts), torch.stack(slots), torch.stack(kept),
                   torch.stack(gates), routed, aux)


def top_k_gating(logits: torch.Tensor, top_k: int, capacity: int,
                 generator: Optional[torch.Generator] = None, jitter: float = 0.0,
                 token_mask: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The JAX package's ``top_k_gating``: ``(dispatch (T, E, C), combine
    (T, E, C) f32, aux)``, dense, from :func:`route`."""
    T, E = logits.shape
    rt = route(logits, top_k, capacity, generator, jitter, token_mask)
    t_idx = torch.arange(T, device=logits.device).expand(top_k, T)
    where = (t_idx, rt.expert, rt.pos.clamp(0, capacity - 1))
    dispatch = torch.zeros((T, E, capacity), dtype=torch.float32, device=logits.device)
    dispatch = dispatch.index_put(where, rt.kept.float(), accumulate=True)
    combine = torch.zeros((T, E, capacity), dtype=torch.float32, device=logits.device)
    combine = combine.index_put(where, rt.gate, accumulate=True)
    return dispatch, combine, rt.aux


# ---------------------------------------------------------------------------
# dropped assignments
# ---------------------------------------------------------------------------

class DropRecord:
    """What :func:`record_drops` collects over the :func:`moe_ffn` calls
    in its block: per call, a (tokens,) bool tensor in :attr:`tokens`
    (whether the token lost a pick to capacity); the routed assignments
    (every routed token's ``k`` picks) and those dropped, summed on the
    device (:meth:`counts` reads them)."""

    def __init__(self):
        self.tokens: List[torch.Tensor] = []
        self._routed: Optional[torch.Tensor] = None
        self._dropped: Optional[torch.Tensor] = None

    def note(self, rt: Routing) -> None:
        lost = rt.routed[None, :] & ~rt.kept                           # (k, T)
        routed = rt.routed.sum() * rt.kept.shape[0]
        dropped = lost.sum()
        self._routed = routed if self._routed is None else self._routed + routed
        self._dropped = dropped if self._dropped is None else self._dropped + dropped
        self.tokens.append(lost.any(0))

    def counts(self) -> Dict[str, int]:
        """``{"assignments", "dropped"}`` so far (waits for the device)."""
        return {"assignments": 0 if self._routed is None else int(self._routed),
                "dropped": 0 if self._dropped is None else int(self._dropped)}


_RECORD: Optional[DropRecord] = None


@contextlib.contextmanager
def record_drops():
    """Count the dropped assignments of every :func:`moe_ffn` call in the
    block (a :class:`DropRecord`); outside such a block nothing is
    counted."""
    global _RECORD
    prev, _RECORD = _RECORD, DropRecord()
    try:
        yield _RECORD
    finally:
        _RECORD = prev


@contextlib.contextmanager
def _not_recorded():
    global _RECORD
    prev, _RECORD = _RECORD, None
    try:
        yield
    finally:
        _RECORD = prev


def recompute_contexts():
    """``torch.utils.checkpoint``'s ``context_fn`` for a checkpointed
    block that holds a MoE layer: its recompute in the backward records
    nothing (its forward did)."""
    return contextlib.nullcontext(), _not_recorded()


# ---------------------------------------------------------------------------
# the layer
# ---------------------------------------------------------------------------

def _route_global(logits: torch.Tensor, top_k: int, capacity: int, dp: RouteGroup,
                  generator, jitter: float, token_mask) -> Routing:
    """:func:`route` over the global batch of a data-parallel step: every
    rank gathers the grid's router logits (and pad masks) in chunk order,
    routes them all alike, and keeps its own tokens' picks.  The gates
    come from this rank's own probabilities (its gradient path); the aux
    loss is this rank's share of the global one, times the grid's size,
    so the engine's mean over the grid gives the global loss and its
    gradient."""
    T, E = logits.shape
    if generator is not None and jitter > 0.0:
        logits = _jitter(logits, generator, jitter)
    tmask = (torch.ones((T,), dtype=torch.float32, device=logits.device)
             if token_mask is None else token_mask.float())
    payload = torch.cat([logits.detach().float(), tmask[:, None]], dim=1)
    every = collectives.all_gather(payload, dp.group, order=dp.order, kind=MOE_ROUTING)
    g = route(every[:, :E], top_k, capacity,
              token_mask=None if token_mask is None else every[:, E])
    mine = slice(dp.rank * T, (dp.rank + 1) * T)
    expert, pos, kept = g.expert[:, mine], g.pos[:, mine], g.kept[:, mine]
    probs = torch.softmax(logits.float(), dim=-1)
    gate = probs.gather(1, expert.t()).t() * tmask * kept
    n_real = torch.clamp(every[:, E].sum(), min=1.0)
    frac_tokens = F.one_hot(g.expert[0], E).mul(every[:, E:] > 0).sum(0).float() / n_real
    mean_prob = (probs * tmask[:, None]).sum(0) / n_real
    aux = dp.size * E * torch.sum(mean_prob * frac_tokens)
    return Routing(expert, pos, kept, gate, tmask > 0, aux)


def moe_ffn(params: Dict[str, Any], x: torch.Tensor, cfg: MoEConfig,
            generator: Optional[torch.Generator] = None, training: bool = False,
            token_mask: Optional[torch.Tensor] = None, ep: Optional[EPGroup] = None,
            tp=None, dp: Optional[RouteGroup] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """MoE feed-forward over ``x (B, T, D)`` → ``(out (B, T, D), aux)``.

    ``training`` picks ``capacity_factor`` (else ``eval_capacity_factor``)
    and turns on the router jitter (drawn from ``generator``);
    ``token_mask`` (B, T) keeps pads out of routing, capacity and aux.
    ``params``' expert leaves are this rank's ``E / ep`` experts under
    ``ep`` (an :class:`EPGroup`), their hidden-dimension block under
    ``tp`` (the ``model`` group).  ``dp`` (a training step's
    :class:`RouteGroup`): route the grid's global batch, as the JAX
    package's global arrays do (capacity from the global token count).
    The router and the gates in f32; the experts in ``x``'s type; the
    combine in f32 (the JAX package's casts); GELU the tanh form."""
    from deepspeed_tpu_torch.parallel.tensor import copy_to_model, reduce_from_model

    B, T, D = x.shape
    tokens = B * T
    E = cfg.num_experts
    factor = cfg.capacity_factor if training else cfg.eval_capacity_factor
    C = _capacity(tokens, E, factor, cfg.min_capacity)

    xt = x.reshape(tokens, D)
    logits = xt.float() @ params["gate_w"].float()
    tmask = token_mask.reshape(tokens) if token_mask is not None else None
    gen = generator if training else None
    jitter = cfg.router_jitter if training else 0.0
    if dp is None:
        rt = route(logits, cfg.top_k, C, generator=gen, jitter=jitter, token_mask=tmask)
    else:
        C = _capacity(tokens * dp.size, E, factor, cfg.min_capacity)
        rt = _route_global(logits, cfg.top_k, C, dp, gen, jitter, tmask)
    if _RECORD is not None:
        _RECORD.note(rt)

    w1 = params["w1"]
    El = w1.shape[0]                                  # this rank's experts
    if El * (ep.size if ep is not None else 1) != E:
        raise ValueError(f"{El} experts on each of {ep.size if ep else 1} expert ranks for "
                         f"{E} experts: an expert axis needs the experts cut (pass the "
                         "model's tp_spec_fn)")
    e0 = ep.rank * El if ep is not None else 0
    local = rt.kept & (rt.expert >= e0) & (rt.expert < e0 + El)         # (k, T)
    slot = (rt.expert - e0) * C + rt.pos                                # (k, T)
    t_idx = torch.arange(tokens, device=x.device).expand_as(slot)
    # the token each local slot holds (``tokens``: the zero row, an empty
    # slot); picks that are not this rank's land in a spare last entry
    src = torch.full((El * C + 1,), tokens, dtype=torch.int64, device=x.device)
    src = src.scatter(0, torch.where(local, slot, El * C).reshape(-1), t_idx.reshape(-1))
    src = src[:El * C]

    xin = copy_to_expert(xt, ep)
    xpad = torch.cat([xin, xin.new_zeros((1, D))])
    expert_in = xpad.index_select(0, src).view(El, C, D)
    expert_in = copy_to_model(expert_in, tp)
    h = torch.baddbmm(params["b1"].to(x.dtype)[:, None, :], expert_in, w1.to(x.dtype))
    h = F.gelu(h, approximate="tanh")
    out = reduce_from_model(torch.bmm(h, params["w2"].to(x.dtype)), tp)
    out = out + params["b2"].to(x.dtype)[:, None, :]
    rows = out.float().reshape(El * C, D)

    gates = copy_to_expert(rt.gate, ep) * local                         # (k, T) f32
    y = None
    for r in range(cfg.top_k):
        term = gates[r][:, None] * rows.index_select(0, slot[r].clamp(0, El * C - 1))
        y = term if y is None else y + term
    y = reduce_from_expert(y, ep)
    return y.reshape(B, T, D).to(x.dtype), rt.aux.float()


MOE_PARAM_KEYS = ("gate_w", "w1", "b1", "w2", "b2")


def moe_ffn_from_block(lp: Dict[str, Any], h: torch.Tensor, *, top_k: int = 2,
                       capacity_factor: float = 1.25, eval_capacity_factor: float = 2.0,
                       generator: Optional[torch.Generator] = None, training: bool = False,
                       token_mask: Optional[torch.Tensor] = None, ep: Optional[EPGroup] = None,
                       tp=None, dp: Optional[RouteGroup] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """A block's MoE FFN from its layer params ``lp`` (the number of
    experts from ``gate_w``, ``d_ff`` from ``b1`` times the ``model``
    cut): the one place the training block (``models/gpt2.py``) and the
    inference block (``ops/transformer/inference.py``) build their
    :class:`MoEConfig`, so their capacity rules cannot drift."""
    cfg = MoEConfig(
        num_experts=lp["gate_w"].shape[-1],
        d_model=h.shape[-1],
        d_ff=lp["b1"].shape[-1] * (tp.size if tp is not None else 1),
        top_k=top_k,
        capacity_factor=capacity_factor,
        eval_capacity_factor=eval_capacity_factor,
    )
    params = {k: lp[k] for k in MOE_PARAM_KEYS}
    return moe_ffn(params, h, cfg, generator=generator, training=training,
                   token_mask=token_mask, ep=ep, tp=tp, dp=dp)
