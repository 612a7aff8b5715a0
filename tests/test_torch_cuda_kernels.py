"""The port's CUDA kernels against their plain PyTorch versions, on the card.

These tests need an NVIDIA GPU and ``nvcc`` (the kernels are built from
``deepspeed_tpu_torch/csrc`` at first use and have no CPU mode), so they
carry the ``cuda`` marker and skip where ``torch.cuda.is_available()`` is
False.  They import neither JAX nor the JAX package, so they run on a
machine that has only PyTorch; there, without the JAX test harness:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda_kernels.py

They cover what ``chip_smoke.py`` does not drive: ragged and rectangular
prefill shapes, the lse output, every head dim the kernels take, scalar
and out-of-range decode positions, tiny caches, the backward's ragged and
rectangular shapes, the fused Adam's dtypes, ragged and unaligned leaves
and its overflow skip, autograd through the kernels, and the wrappers'
refusals.  Tolerances: float32 2e-5 (sums in other orders, TF32 off);
bfloat16 outputs 2e-2 (rounded to bf16, spacing 2**-8 relative); the
backward entry by entry, within that tolerance times |entry| plus half
the gradient's rms (dq's f32 sum is taken with atomics, in an order that
changes between runs); fused Adam's moments 1e-6 of their largest entry,
f32 p 1e-6 absolute (the kernel rounds each product and sum as the plain
version does)."""
import numpy as np
import pytest
import torch

from deepspeed_tpu_torch.ops import kernels
from deepspeed_tpu_torch.ops.attention import flash_attention as fa
from deepspeed_tpu_torch.ops.kernels import flash_decode as fd
from deepspeed_tpu_torch.ops.kernels import fused_update as fu
from deepspeed_tpu_torch.ops.transformer.inference import _kv_quant

pytestmark = pytest.mark.cuda

TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the port's kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _randn(dev, *shape, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    return torch.randn(*shape, generator=g, device=dev)


def _err(a, b):
    return float((a.float() - b.float()).abs().max())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("sq,sk,d,causal", [
    (200, 200, 64, True),    # ragged last tile
    (64, 64, 16, True),
    (100, 300, 32, True),    # end-aligned: queries are the last 100 positions
    (130, 257, 128, False),
    (1, 77, 64, False),
    (300, 300, 128, True),
])
def test_flash_fwd_kernel_matches_plain(dev, dtype, sq, sk, d, causal):
    q = _randn(dev, 2, 3, sq, d, seed=1).to(dtype)
    k = _randn(dev, 2, 3, sk, d, seed=2).to(dtype)
    v = _randn(dev, 2, 3, sk, d, seed=3).to(dtype)
    scale = d ** -0.5
    out, lse = fa.flash_fwd_cuda(q, k, v, causal, scale, want_lse=True)
    ref, ref_lse = fa.flash_fwd_reference(q, k, v, causal, scale)
    torch.cuda.synchronize()
    assert out.dtype == dtype and out.shape == q.shape
    assert _err(out, ref) <= TOL[dtype]
    assert _err(lse, ref_lse) <= 1e-4  # f32 log of sums up to sk terms


@pytest.mark.parametrize("B,H,S,d,kv,masked,pos", [
    (3, 2, 77, 16, torch.float32, False, 40),           # scalar pos, odd S
    (2, 4, 130, 128, torch.bfloat16, True, [0, 129]),   # per-slot edges, masked
    (5, 3, 1, 64, "int8", False, [0] * 5),              # one-row cache
    (2, 2, 96, 32, torch.float32, False, [200, 3]),     # pos past the end: all S keys
    (4, 12, 1024, 64, "int8", True, [1023, 0, 512, 7]),
])
def test_flash_decode_kernel_matches_plain(dev, B, H, S, d, kv, masked, pos):
    qdtype = torch.float32 if kv == torch.float32 else torch.bfloat16
    q = _randn(dev, B, H, 1, d, seed=4).to(qdtype)
    k, v = _randn(dev, B, H, S, d, seed=5), _randn(dev, B, H, S, d, seed=6)
    if kv == "int8":
        kc, vc = (dict(zip(("q", "s"), _kv_quant(t))) for t in (k, v))
    else:
        kc, vc = k.to(kv), v.to(kv)
    pos_t = pos if isinstance(pos, int) else torch.tensor(pos, dtype=torch.int32, device=dev)
    kpm = None
    if masked:
        kpm = torch.rand(B, S, generator=torch.Generator(device=dev).manual_seed(7), device=dev) > 0.5
        kpm[0, :] = False  # a slot with no attendable key: uniform over S, finite
    out = fd.flash_decode_cuda(q, kc, vc, pos_t, key_padding_mask=kpm)
    ref = fd.flash_decode_reference(q, kc, vc, pos_t, key_padding_mask=kpm)
    torch.cuda.synchronize()
    assert torch.isfinite(out).all()
    assert _err(out, ref) <= TOL[qdtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("sq,sk,d,causal", [
    (200, 200, 64, True),    # ragged last tiles
    (64, 64, 16, True),
    (100, 300, 32, True),    # end-aligned: queries are the last 100 positions
    (130, 257, 128, False),
    (300, 300, 128, True),
    (1000, 1000, 64, True),
])
def test_flash_bwd_kernel_matches_plain(dev, dtype, sq, sk, d, causal):
    q = _randn(dev, 2, 3, sq, d, seed=1).to(dtype)
    k = _randn(dev, 2, 3, sk, d, seed=2).to(dtype)
    v = _randn(dev, 2, 3, sk, d, seed=3).to(dtype)
    do = _randn(dev, 2, 3, sq, d, seed=4).to(dtype)
    scale = d ** -0.5
    out, lse = fa.flash_fwd_cuda(q, k, v, causal, scale, want_lse=True)
    delta = (do.float() * out.float()).sum(-1)
    got = fa.flash_bwd_cuda(q, k, v, do, lse, delta, causal, scale)
    ref = fa.flash_bwd_reference(q, k, v, do, lse, delta, causal, scale)
    torch.cuda.synchronize()
    for a, b in zip(got, ref):
        assert a.dtype == dtype and a.shape == b.shape
        a, b = a.float(), b.float()
        bound = TOL[dtype] * (b.abs() + 0.5 * b.square().mean().sqrt())
        assert bool(((a - b).abs() <= bound).all()), _err(a, b)


def test_autograd_through_the_kernels_matches_the_plain_path(dev):
    q, k, v = (_randn(dev, 2, 4, 256, 64, seed=s).requires_grad_() for s in (1, 2, 3))
    w = _randn(dev, 2, 4, 256, 64, seed=4)
    (fa.flash_attention(q, k, v, causal=True) * w).sum().backward()
    got = [t.grad.clone() for t in (q, k, v)]
    for t in (q, k, v):
        t.grad = None
    (fa.mha_reference(q, k, v, causal=True) * w).sum().backward()
    for a, t in zip(got, (q, k, v)):
        assert _err(a, t.grad) <= 1e-4  # f32 attention, sums in other orders


@pytest.mark.parametrize("n,pdtype,gdtype,offset", [
    (50257 * 768, torch.float32, torch.float32, 0),
    (768, torch.float32, torch.float32, 0),
    (1001, torch.bfloat16, torch.float32, 0),
    (4099, torch.float32, torch.bfloat16, 0),
    (4099, torch.float32, torch.float32, 1),   # not 16-byte aligned: the scalar path
])
@pytest.mark.parametrize("adam_w_mode", [True, False], ids=["adamw", "adam_l2"])
def test_fused_adam_kernel_matches_plain(dev, n, pdtype, gdtype, offset, adam_w_mode):
    def leaf(seed, scale=1.0):
        return (_randn(dev, n + offset, seed=seed) * scale)[offset:]

    p, g = leaf(1).to(pdtype), leaf(2).to(gdtype)
    m, v = leaf(3, 0.1), leaf(4, 0.1).square()
    hyper = dict(b1=0.9, b2=0.999, eps=1e-8, weight_decay=0.01, adam_w_mode=adam_w_mode)
    for keep in (1.0, 0.0):
        scal = torch.tensor([1e-3, keep, 0.19, 0.002], device=dev)
        pk, mk, vk = p.clone(), m.clone(), v.clone()
        fu.adam_leaf_cuda(pk, g, mk, vk, scal, **hyper)
        pr, mr, vr = fu._adam_keep_body(p.float(), g.float(), m, v, *scal.unbind(0), **hyper)
        torch.cuda.synchronize()
        assert _err(pk, pr.to(pdtype)) <= (1e-6 if pdtype == torch.float32 else 1e-2)
        for got, ref in ((mk, mr), (vk, vr)):
            assert _err(got, ref) <= 1e-6 * float(ref.abs().max())
        if keep == 0.0:  # the overflow skip writes back the old state
            assert torch.equal(pk, p) and torch.equal(mk, m) and torch.equal(vk, v)


def test_training_step_on_the_card_matches_the_cpu(dev):
    """Three f32 train_batch steps of a small GPT-2 on the card (flash
    forward, backward and fused Adam kernels) against the CPU's plain
    path, with the same init and batch."""
    import dataclasses

    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models import gpt2

    cfg = dataclasses.replace(gpt2.GPT2_TINY, n_positions=256)
    model_fn, init_fn, _ = gpt2.make_model(cfg)
    config = {"train_micro_batch_size_per_gpu": 2, "gradient_accumulation_steps": 2,
              "gradient_clipping": 1.0, "optimizer": {"type": "AdamW", "params": {"lr": 1e-3}}}
    batch = {"input_ids": np.random.default_rng(0).integers(0, 512, (4, 256), dtype=np.int32)}
    losses = {}
    kernels.reset_launches()
    for where in ("cpu", "cuda"):
        eng = deepspeed_tpu_torch.initialize(model=model_fn, model_parameters=init_fn(seed=3),
                                             config=config, device=where)[0]
        losses[where] = [float(eng.train_batch(batch)) for _ in range(3)]
    np.testing.assert_allclose(losses["cuda"], losses["cpu"], rtol=1e-4)
    got = kernels.launches()
    assert got["flash_fwd"] > 0 and got["flash_bwd"] > 0 and got["fused_adam"] > 0


def test_launch_counts_and_refusals(dev):
    q = _randn(dev, 1, 2, 128, 64).to(torch.bfloat16)
    kernels.reset_launches()
    fa.flash_fwd(q, q, q, causal=True)
    fd.flash_decode(q[:, :, :1].contiguous(), q, q, 5)
    fa.flash_fwd(q.cpu(), q.cpu(), q.cpu(), causal=True)  # the plain version: no launch
    want = {"flash_fwd": 1, "flash_decode": 1, "flash_bwd": 0, "fused_adam": 0}
    assert kernels.launches() == want
    with pytest.raises(ValueError, match="contiguous"):
        fa.flash_fwd_cuda(q.transpose(2, 3).contiguous().transpose(2, 3), q, q, True, 0.125)
    with pytest.raises(ValueError, match="dtype"):
        fa.flash_fwd_cuda(q.half(), q.half(), q.half(), True, 0.125)
    with pytest.raises(ValueError, match="head_dim"):
        w = _randn(dev, 1, 1, 16, 48)
        fa.flash_fwd_cuda(w, w, w, True, 0.125)
    with pytest.raises(ValueError, match="dtype"):
        fd.flash_decode_cuda(q[:, :, :1].float().contiguous(), q, q, 0)
    lse = torch.zeros(1, 2, 128, device=dev)
    with pytest.raises(ValueError, match="float32"):
        fa.flash_bwd_cuda(q, q, q, q, lse.half(), lse, True, 0.125)
    p = torch.zeros(300, device=dev)
    with pytest.raises(ValueError, match="scal"):
        fu.adam_leaf_cuda(p, p, p, p, torch.ones(3, device=dev), b1=0.9, b2=0.999, eps=1e-8,
                          weight_decay=0.0, adam_w_mode=True)
    assert kernels.launches() == want


def test_tiny_model_on_the_card_matches_the_cpu(dev):
    """Greedy generate() and served tokens of a small f32 GPT-2 on the
    card equal the CPU's plain path (T=130 takes the prefill kernel)."""
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models import gpt2
    from deepspeed_tpu_torch.serving import ServingEngine

    cfg = gpt2.GPT2Config(vocab_size=512, n_positions=256, n_embd=64, n_layer=2, n_head=4)
    params = gpt2.init_params(cfg, seed=3)
    ids = np.random.default_rng(0).integers(1, 512, (2, 130), dtype=np.int32)
    outs = {}
    for where in ("cpu", "cuda"):
        eng = deepspeed_tpu_torch.init_inference(model_config=cfg, params=params,
                                                 dtype=torch.float32, device=where)
        gen = eng.generate(ids, max_new_tokens=8)
        srv = ServingEngine(eng, num_slots=2, prefill_chunk=32)
        rid = srv.submit(ids[1], max_new_tokens=8)
        outs[where] = (gen, srv.drain()[rid].tokens())
    np.testing.assert_array_equal(outs["cpu"][0], outs["cuda"][0])
    np.testing.assert_array_equal(outs["cpu"][1], outs["cuda"][1])
    np.testing.assert_array_equal(outs["cuda"][1], outs["cuda"][0][1])
