"""Sequence parallelism over ``seq`` across gloo ranks (ring and Ulysses
attention, ``deepspeed_tpu_torch/parallel/sequence.py``) against the JAX
package's ``deepspeed_tpu.parallel.sequence`` and engine on a host mesh,
and against the port at world size 1.

* ``ring_attention`` and ``ulysses_attention`` over 4 ranks (one spawn of
  ``tools/zero_worker.py``'s ``seq_attention_check``), causal and full,
  forward and gradients, on numpy inputs from a seed: within
  ``ATTN_TOL`` of the JAX functions on a 4-device ``seq`` mesh (f32 sums
  in other orders).  The ring's schedule on a ``VirtualRing`` of 4 lanes
  in one process gives the same, and its backward the same bits twice.
* The GPT-2 step (GPT2_TINY, T 64, ``tests/test_torch_zero.py``'s f32
  parity run) at ``seq 2`` ring, ``seq 4`` ring and Ulysses, ``seq 2 x
  model 2`` Ulysses and ``seq 2 x data 2`` ring at stage 1: losses within
  ``F32_LOSS_RTOL`` and masters within ``F32_PARAM_ATOL`` of the port at
  world 1 and of the JAX engine on the same host mesh; the bytes counted
  equal the models kind by kind (``seq-p2p``, ``seq-all-to-all``,
  ``seq-loss``, ``seq-grad-exchange``, ``tp-all-reduce``); every rank that
  holds the same block of a leaf holds the same bits.
* The ring's bf16 gradients within ``ring_bwd_float64``'s bound (every
  block's bf16 contract from ``flash_bwd_float64``, summed with the f32
  sum's and the last rounding's); a dK missing one block far outside it.
* The label shift across shard edges: each ``seq`` rank's labels are the
  whole rows' next tokens, the sequence's last position masked on the
  last rank.
* The refusals with the JAX package's wording: ``T % seq`` and Ulysses'
  ``H % seq``; a ``seq`` axis under flash attention.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.comm.mesh import make_mesh
from deepspeed_tpu.config.config import MeshConfig
from deepspeed_tpu.parallel import sequence as jseq
from deepspeed_tpu_torch.models import gpt2 as tgpt2
from deepspeed_tpu_torch.parallel import sequence as tseq

from tests.test_torch_tensor_parallel import (
    _engine,
    assert_bytes_equal_the_models,
    dp_of,
    gpt2_case,
)
from tests.test_torch_zero import (
    GAS,
    MB,
    STEPS,
    T,
    _assert_close,
    _gpt2_config,
    _jax,
    _launch,
    _one_process,
    _read,
)

# ring / Ulysses vs the JAX functions (f32): blockwise online softmax and
# its gradients summed in other orders; the JAX package's own
# test_sequence_parallel.py holds its ring to 2e-5 forward and 5e-4 on
# the gradients against dense attention
ATTN_TOL = {"out": 2e-5, "grad": 5e-4}
B, H, AT, D = 2, 4, 64, 16

SEQ_MESHES = {
    "s2_ring": ({"data": 1, "seq": 2}, "ring", 0),
    "s4_ring": ({"data": 1, "seq": 4}, "ring", 0),
    "s4_ulysses": ({"data": 1, "seq": 4}, "ulysses", 2),
    "s2m2_ulysses": ({"data": 1, "seq": 2, "model": 2}, "ulysses", 2),
    "s2d2_ring": ({"data": 2, "seq": 2}, "ring", 1),
}


def _inputs():
    rng = np.random.default_rng(0)
    return {n: rng.standard_normal((B, H, AT, D)).astype(np.float32)
            for n in ("q", "k", "v", "do")}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("seq")
    rng = np.random.default_rng(0)
    ids = np.repeat(rng.integers(0, tgpt2.GPT2_TINY.vocab_size, (1, GAS * MB * 2, T),
                                 dtype=np.int32), STEPS, axis=0)
    np.savez(tmp / "g2.npz", input_ids=ids)
    np.savez(tmp / "g1.npz", input_ids=ids[:, :GAS * MB])
    np.savez(tmp / "qkv.npz", **_inputs())

    def cases(world):
        out = []
        for name, (mesh, mode, stage) in SEQ_MESHES.items():
            if int(np.prod(list(mesh.values()))) == world:
                bfile = tmp / ("g2.npz" if dp_of(mesh) == 2 else "g1.npz")
                out.append(gpt2_case(name, mesh, stage, bfile, mode))
        return out

    # with dropout and chunked cross-entropy: the seeds folded per rank, the
    # recompute's all-reduce after the MLP, each chunk's loss run twice
    drop = gpt2_case("s2m2_ring_dropout_chunked", {"data": 1, "seq": 2, "model": 2}, 0,
                     tmp / "g1.npz", "ring", model_cfg={"dropout": 0.1, "xent_chunk_size": 16},
                     steps=2)
    _launch(4, cases(4) + [drop], tmp, extra={"seq_attention_check": str(tmp / "qkv.npz")})
    _launch(2, cases(2), tmp)
    with np.load(tmp / "seq_attention.npz") as z:
        attn = {k: z[k] for k in z.files}
    return {"tmp": tmp, "ids": ids, "attn": attn}


def _jax_attention(fn, causal):
    """The JAX function on a 4-device ``seq`` mesh: output and gradients of
    ``sum(out * do)``."""
    x = {k: jnp.asarray(v) for k, v in _inputs().items()}
    mesh = make_mesh(MeshConfig(seq=4, data=1), devices=jax.devices()[:4])

    def loss(q, k, v):
        return jnp.sum(fn(q, k, v, causal=causal, mesh=mesh) * x["do"])

    out = jax.jit(lambda q, k, v: fn(q, k, v, causal=causal, mesh=mesh))(x["q"], x["k"], x["v"])
    grads = jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(x["q"], x["k"], x["v"])
    return [np.asarray(out)] + [np.asarray(g) for g in grads]


def _close(got, want, tol):
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, atol=tol * scale, rtol=tol)


@pytest.mark.parametrize("name", ["ring", "ulysses"])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_attention_over_4_ranks_matches_the_jax_package(runs, name, causal):
    fn = jseq.ring_attention if name == "ring" else jseq.ulysses_attention
    want = _jax_attention(fn, causal)
    tag = f"{name}_{'causal' if causal else 'full'}"
    for key, w in zip(("out", "dq", "dk", "dv"), want):
        _close(runs["attn"][f"{tag}_{key}"], w, ATTN_TOL["out" if key == "out" else "grad"])


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_virtual_ring_matches_the_jax_ring_and_repeats_its_bits(causal):
    """The ring's schedule over 4 lanes in one process (how the card holds
    it against dense attention): the JAX ring's output and gradients, and
    the same bits on a second backward."""
    x = {k: torch.from_numpy(v) for k, v in _inputs().items()}
    runs = []
    for _ in range(2):
        q, k, v = (x[n].clone().requires_grad_(True) for n in ("q", "k", "v"))
        out = tseq.ring_attention(q, k, v, causal=causal, ring=tseq.VirtualRing(4))
        out.backward(x["do"])
        runs.append([out.detach(), q.grad, k.grad, v.grad])
    want = _jax_attention(jseq.ring_attention, causal)
    for key, got, w in zip(("out", "dq", "dk", "dv"), runs[0], want):
        _close(got.numpy(), w, ATTN_TOL["out" if key == "out" else "grad"])
    assert all(torch.equal(a, b) for a, b in zip(*runs))


_REFS = {}


def _reference(runs, dp):
    if dp not in _REFS:
        _REFS[dp] = _one_process(_gpt2_config(0, {"data": 1}, mb=MB * dp), "gpt2",
                                 {"input_ids": runs["ids"][:, :GAS * MB * dp]}, STEPS)
    return _REFS[dp]


@pytest.mark.parametrize("case", list(SEQ_MESHES))
def test_gpt2_matches_the_port_at_world_1(runs, case):
    mesh, mode, _ = SEQ_MESHES[case]
    meta, state = _read(runs, case)
    assert meta["world_size"] == int(np.prod(list(mesh.values())))
    assert meta["mesh"]["seq"] == mesh["seq"]
    losses, ref = _reference(runs, dp_of(mesh))
    _assert_close(meta, state, losses, ref)
    assert meta["losses"][-1] < meta["losses"][0]


@pytest.mark.parametrize("case", list(SEQ_MESHES))
def test_gpt2_matches_the_jax_engine_on_a_host_mesh(runs, case):
    mesh, mode, stage = SEQ_MESHES[case]
    dp = dp_of(mesh)
    losses, params = _jax("gpt2", mesh, stage, {"input_ids": runs["ids"][:, :GAS * MB * dp]},
                             mode=mode)
    meta, state = _read(runs, case)
    _assert_close(meta, state, losses, params)


@pytest.mark.parametrize("case", list(SEQ_MESHES) + ["s2m2_ring_dropout_chunked"])
def test_counted_bytes_equal_the_models(runs, case):
    meta, _ = _read(runs, case)
    kind = "seq-p2p" if "ring" in case else "seq-all-to-all"
    assert meta["parallel"][kind] > 0 and meta["extras"]["seq-grad-exchange"] > 0
    assert_bytes_equal_the_models(meta)


@pytest.mark.parametrize("case", list(SEQ_MESHES) + ["s2m2_ring_dropout_chunked"])
def test_every_rank_holding_a_block_holds_the_same_bits(runs, case):
    meta, _ = _read(runs, case)
    assert meta["replicas_equal"] and all(meta["replicas_equal"].values()), meta["replicas_equal"]
    assert all(np.isfinite(meta["losses"]))


def test_labels_cross_the_shard_edges():
    """Each ``seq`` rank's labels are the next tokens of the whole rows (its
    last one the next shard's first token); only the sequence's last
    position is masked, on the last rank; a given ``labels`` and
    ``attention_mask`` are cut as the positions."""
    tokens = torch.arange(2 * 8).reshape(2, 8)
    mask = torch.ones(2, 8)
    mask[1, 5] = 0.0
    got = [tgpt2._seq_labels({"input_ids": tokens, "attention_mask": mask}, tokens,
                             slice(r * 4, (r + 1) * 4)) for r in range(2)]
    labels = torch.cat([g[0] for g in got], 1)
    keep = torch.cat([g[1] for g in got], 1)
    assert torch.equal(labels[:, :7], tokens[:, 1:])
    want = torch.cat([mask[:, 1:], torch.zeros(2, 1)], 1)
    assert torch.equal(keep, want)
    given = torch.randint(0, 9, (2, 8))
    lab, m = tgpt2._seq_labels({"input_ids": tokens, "labels": given}, tokens, slice(4, 8))
    assert torch.equal(lab, given[:, 4:]) and torch.equal(m, torch.ones(2, 4))


def test_refusals_keep_the_jax_wording():
    """``T % seq`` and Ulysses' ``H % seq``, raised by the port at
    ``initialize`` in the JAX package's words (which raises them when it
    traces the attention); flash attention under a ``seq`` axis."""
    q = jnp.zeros((1, 4, 66, 16))
    with pytest.raises(ValueError, match="seq len 66 not divisible by seq axis size 4") as j:
        jseq.ring_attention(q, q, q, mesh=make_mesh(MeshConfig(seq=4, data=1),
                                                    devices=jax.devices()[:4]))
    with pytest.raises(ValueError, match=str(j.value)):
        _engine(dataclasses.replace(tgpt2.GPT2_TINY, n_positions=66, attention_mode="ring"),
                {"seq": 4})
    q = jnp.zeros((1, 6, 64, 16))
    with pytest.raises(ValueError, match=r"ulysses needs heads \(6\) divisible by seq axis \(4\)"):
        jseq.ulysses_attention(q, q, q, mesh=make_mesh(MeshConfig(seq=4, data=1),
                                                       devices=jax.devices()[:4]))
    with pytest.raises(ValueError, match=r"ulysses needs heads \(6\) divisible by seq axis \(4\)"):
        _engine(dataclasses.replace(tgpt2.GPT2_TINY, n_embd=96, n_head=6, n_positions=64,
                                    attention_mode="ulysses"), {"seq": 4})
    with pytest.raises(ValueError, match="needs attention_mode 'ring' or 'ulysses'"):
        _engine(tgpt2.GPT2_TINY, {"seq": 2})


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_ring_bf16_gradients_within_the_float64_bound(causal):
    """The ring's bf16 gradients (its plain body on CPU tensors: the
    blocks' plain versions in the schedule) against ``ring_bwd_float64``:
    within its bound, which is every block's bf16 contract
    (``flash_bwd_float64`` on that block) summed, with the f32 sum's and
    the last rounding's; its exact part is the whole sequence's float64
    gradient.  A dK missing one query block is far outside it."""
    from deepspeed_tpu_torch.ops.attention import flash_attention as fa

    P, scale = 4, D ** -0.5
    x = {k: torch.from_numpy(v).to(torch.bfloat16) for k, v in _inputs().items()}
    q, k, v = (x[n].clone().requires_grad_(True) for n in ("q", "k", "v"))
    out = tseq.ring_attention(q, k, v, causal=causal, ring=tseq.VirtualRing(P))
    out.backward(x["do"])
    ring = tseq.VirtualRing(P)
    _, lses = tseq.ring_forward(*(ring.lanes(x[n]) for n in ("q", "k", "v")), ring, causal, scale)
    lse = ring.join(lses)
    delta = (x["do"].float() * out.detach().float()).sum(-1)
    witness = tseq.ring_bwd_float64(x["q"], x["k"], x["v"], x["do"], lse, delta, P, causal, scale)
    grads = [q.grad, k.grad, v.grad]
    assert max(fa.float64_over_bound(grads, witness)) <= 1.0
    whole = fa.flash_bwd_float64(x["q"], x["k"], x["v"], x["do"], lse, delta, causal, scale)[0]
    for a, b in zip(witness[0], whole):
        torch.testing.assert_close(a, b, rtol=1e-12, atol=1e-12)
    # the last key block's dK without query block 3's share
    lane = slice(3 * AT // P, AT)
    (_, part, _), _ = fa.flash_bwd_float64(
        x["q"][:, :, lane], x["k"][:, :, lane], x["v"][:, :, lane], x["do"][:, :, lane],
        lse[:, :, lane], delta[:, :, lane], causal, scale)
    short = grads[1].double().clone()
    short[:, :, lane] -= part
    assert max(fa.float64_over_bound([grads[0], short, grads[2]], witness)) > 10.0
