"""The port's activation checkpointing and GPT-2's remat policies against
the JAX package's, on the CPU.

* ``checkpoint``, ``checkpoint_wrapper`` and ``checkpoint_sequential`` give
  the values and gradients of the uncheckpointed function, bit for bit
  (f32 on the CPU: the recompute runs the same ops), also under
  ``cpu_checkpointing`` and every save policy.
* GPT-2 at ``GPT2_TINY`` widths and T 256 (the attention takes its
  kernel's plain version, ``_FlashAttention``) under each accepted
  ``remat_policy`` and under ``remat_save_names=SAVE_FLASH`` gives the JAX
  package's loss and gradients within 1e-5 absolute (f32: the two sides
  sum in different orders), and the port's own within 0 of its
  ``nothing_saveable`` run.
* Under ``SAVE_FLASH`` the attention forward runs once a layer a step
  (the recompute takes the kept output and lse), twice under
  ``nothing_saveable`` and other names, each with the same values.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.models import gpt2 as jgpt2
from deepspeed_tpu.runtime.activation_checkpointing import checkpointing as jac
from deepspeed_tpu_torch.config.config import DeepSpeedConfig
from deepspeed_tpu_torch.models import gpt2 as tgpt2
from deepspeed_tpu_torch.ops.attention import flash_attention as tfa
from deepspeed_tpu_torch.runtime.activation_checkpointing import checkpointing as tac

GRAD_TOL = 1e-5
SAVE_FLASH = ("qkv", "ffn_pre", "attn_o", "attn_lse")
CFG = dataclasses.replace(tgpt2.GPT2_TINY, n_positions=256)
JCFG = dataclasses.replace(jgpt2.GPT2_TINY, n_positions=256)


@pytest.fixture(autouse=True)
def _default_config():
    tac.configure(deepspeed_config=DeepSpeedConfig({"train_batch_size": 1}))
    yield
    tac.configure(deepspeed_config=DeepSpeedConfig({"train_batch_size": 1}))


def _mlp(x, w1, w2):
    return torch.tanh(torch.tanh(x @ w1) @ w2).sum(dim=-1, keepdim=True) * x


def _inputs(seed=0):
    g = torch.Generator().manual_seed(seed)
    return [torch.randn(*s, generator=g, requires_grad=True)
            for s in ((4, 16), (16, 32), (32, 16))]


def _value_and_grads(fn):
    x, w1, w2 = _inputs()
    out = fn(x, w1, w2)
    out.square().sum().backward()
    return out.detach(), [t.grad for t in (x, w1, w2)]


@pytest.mark.parametrize("how", ["checkpoint", "wrapper", "cpu", "dots", "names"])
def test_checkpoint_equals_the_plain_function(how):
    ref_out, ref_g = _value_and_grads(_mlp)
    if how == "cpu":
        tac.configure(checkpoint_in_cpu=True)
    if how in ("checkpoint", "cpu"):
        fn = lambda *a: tac.checkpoint(_mlp, *a)  # noqa: E731
    elif how == "wrapper":
        fn = tac.checkpoint_wrapper(_mlp)
    else:
        pol = (tac.SavePolicy("dots_saveable") if how == "dots"
               else tac.SavePolicy(names=("qkv",)))
        fn = lambda *a: tac.remat(_mlp, *a, policy=pol)  # noqa: E731
    out, g = _value_and_grads(fn)
    assert torch.equal(out, ref_out)
    assert all(torch.equal(a, b) for a, b in zip(g, ref_g))


@pytest.mark.parametrize("every", [1, 2, 3])
def test_checkpoint_sequential_equals_the_loop(every):
    g = torch.Generator().manual_seed(1)
    stacked = {"w": torch.randn(6, 8, 8, generator=g) * 0.3, "b": torch.randn(6, 8, generator=g)}

    def block(p, h, gen):
        drop = (torch.rand(h.shape, generator=gen) > 0.1).float() / 0.9
        return torch.tanh(h @ p["w"] + p["b"]) * drop

    def run(ck):
        ps = {k: v.clone().requires_grad_() for k, v in stacked.items()}
        x = torch.randn(3, 8, generator=torch.Generator().manual_seed(2), requires_grad=True)
        gen = lambda j: torch.Generator().manual_seed(100 + j)  # noqa: E731
        if ck:
            y = tac.checkpoint_sequential(block, ps, x, generator_for=gen, every=every)
        else:
            y = x
            for j in range(6):
                y = block({k: v[j] for k, v in ps.items()}, y, gen(j))
        y.sum().backward()
        return y.detach(), x.grad, ps["w"].grad, ps["b"].grad

    for a, b in zip(run(True), run(False)):
        assert torch.equal(a, b)


def test_rng_tracker_api_matches_jax():
    t, j = tac.CudaRNGStatesTracker(), jac.CudaRNGStatesTracker()
    for tr in (t, j):
        tr.add("a", 1)
        with pytest.raises(Exception, match="already exists"):
            tr.add("a", 2)
        tr.add("b", 3)
    assert sorted(t.get_states()) == sorted(j.get_states()) == ["a", "b"]
    before = t.get_states()["a"].clone()
    with t.fork("a"):
        x = torch.rand(4)
    with t.fork("a"):
        y = torch.rand(4)
    assert not torch.equal(x, y) and not torch.equal(t.get_states()["a"], before)
    t.set_states({"a": before})
    with t.fork("a"):
        assert torch.equal(torch.rand(4), x)  # the stream replays from its state
    for tr in (t, j):
        tr.reset()
        assert tr.get_states() == {}
    tac.model_parallel_cuda_manual_seed(5)
    jac.model_parallel_cuda_manual_seed(5)
    assert (sorted(tac.get_cuda_rng_tracker().get_states())
            == sorted(jac.get_cuda_rng_tracker().get_states()) == ["model-parallel-rng"])


def test_configure_takes_the_block_then_the_arguments():
    d = {"train_batch_size": 1, "activation_checkpointing": {
        "partition_activations": True, "cpu_checkpointing": True, "number_checkpoints": 4}}
    tac.configure(deepspeed_config=DeepSpeedConfig(d))
    from deepspeed_tpu.config.config import DeepSpeedConfig as JConfig

    assert (dataclasses.asdict(tac.get_config())
            == dataclasses.asdict(JConfig(d, world_size=1).activation_checkpointing))
    assert tac.config_policy().offload
    tac.configure(checkpoint_in_cpu=False, num_checkpoints=2)
    assert not tac.get_config().cpu_checkpointing and tac.get_config().number_checkpoints == 2
    assert tac.is_configured()


def _jax_loss_grads(ids, **kw):
    cfg = dataclasses.replace(JCFG, **kw)
    p = jgpt2.init_params(cfg, 0)
    f = jax.jit(jax.value_and_grad(
        lambda q: jgpt2.loss_fn(q, {"input_ids": jnp.asarray(ids)}, cfg=cfg, deterministic=True)))
    loss, g = f(p)
    return float(loss), jax.tree.map(np.asarray, g)


def _port_loss_grads(ids, **kw):
    """The port's loss and gradients; deterministic algorithms, so the
    embedding's backward sums in one order (bit-equal runs)."""
    torch.use_deterministic_algorithms(True)
    try:
        return _port_loss_grads_once(ids, **kw)
    finally:
        torch.use_deterministic_algorithms(False)


def _port_loss_grads_once(ids, **kw):
    cfg = dataclasses.replace(CFG, **kw)
    p = tgpt2.params_from_jax(tgpt2.init_params(cfg, 0))
    leaves = [p["wte"], p["wpe"], p["lnf_g"], p["lnf_b"], *p["blocks"].values()]
    for t in leaves:
        t.requires_grad_(True)
    loss = tgpt2.loss_fn(p, {"input_ids": torch.from_numpy(ids)}, cfg=cfg, deterministic=True)
    loss.backward()
    grads = {k: v.grad.numpy() for k, v in p.items() if k != "blocks"}
    grads["blocks"] = {k: v.grad.numpy() for k, v in p["blocks"].items()}
    return float(loss), grads


_PORT_REF = {}


@pytest.mark.parametrize("policy", ["nothing_saveable", "everything_saveable", "dots_saveable",
                                    "dots_with_no_batch_dims_saveable", "SAVE_FLASH"])
def test_gpt2_policies_give_the_jax_packages_loss_and_gradients(policy):
    ids = np.random.default_rng(0).integers(0, CFG.vocab_size, (2, 256)).astype(np.int32)
    kw = ({"remat_save_names": SAVE_FLASH} if policy == "SAVE_FLASH"
          else {"remat_policy": policy})
    jl, jg = _jax_loss_grads(ids, **kw)
    tl, tg = _port_loss_grads(ids, **kw)
    assert abs(tl - jl) < GRAD_TOL
    flat_j = dict(jax.tree_util.tree_leaves_with_path(jg))
    for path, got in jax.tree_util.tree_leaves_with_path(tg):
        np.testing.assert_allclose(got, flat_j[path], atol=GRAD_TOL, rtol=0, err_msg=str(path))
    if "ref" not in _PORT_REF:
        _PORT_REF["ref"] = _port_loss_grads(ids)
    rl, rg = _PORT_REF["ref"]
    assert tl == rl  # the policy moves no value: the recompute runs the same ops
    for (path, got), (_, want) in zip(jax.tree_util.tree_leaves_with_path(tg),
                                      jax.tree_util.tree_leaves_with_path(rg)):
        np.testing.assert_array_equal(got, want, err_msg=str(path))


def test_unported_policies_and_unknown_names_raise():
    for pol in ("offload_dot_with_no_batch_dims", "save_and_offload_only_these_names"):
        with pytest.raises(NotImplementedError, match="A13"):
            dataclasses.replace(CFG, remat_policy=pol)
    with pytest.raises(ValueError, match="unknown remat names"):
        dataclasses.replace(CFG, remat_save_names=("qkv", "nope"))


@pytest.mark.parametrize("names,forwards", [((), 2), (SAVE_FLASH, 1), (("qkv", "attn_o"), 2),
                                           (("attn_ctx", "ffn_pre"), 2)],
                         ids=["nothing", "save_flash", "o_without_lse", "ctx_ffn"])
def test_attention_forwards_a_layer_under_save_flash(monkeypatch, names, forwards):
    calls = []
    ref = tfa.flash_fwd_reference

    def counted(*a, **k):
        calls.append(1)
        return ref(*a, **k)

    monkeypatch.setattr(tfa, "flash_fwd_reference", counted)
    ids = np.random.default_rng(1).integers(0, CFG.vocab_size, (2, 256)).astype(np.int32)
    loss, grads = _port_loss_grads(ids, remat_save_names=names)
    assert len(calls) == forwards * CFG.n_layer
    ref_loss, ref_grads = _port_loss_grads(ids)  # the values are nothing_saveable's
    assert loss == ref_loss
    for (path, got), (_, want) in zip(jax.tree_util.tree_leaves_with_path(grads),
                                      jax.tree_util.tree_leaves_with_path(ref_grads)):
        np.testing.assert_array_equal(got, want, err_msg=str(path))
