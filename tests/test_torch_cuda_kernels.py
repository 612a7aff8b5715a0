"""The port's CUDA kernels against their plain PyTorch versions, on the card.

These tests need an NVIDIA GPU and ``nvcc`` (the kernels are built from
``deepspeed_tpu_torch/csrc`` at first use and have no CPU mode), so they
carry the ``cuda`` marker and skip where ``torch.cuda.is_available()`` is
False.  They import neither JAX nor the JAX package, so they run on a
machine that has only PyTorch; there, without the JAX test harness:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda_kernels.py

They cover what ``chip_smoke.py`` does not drive: ragged and rectangular
prefill shapes, the lse output, every head dim the kernels take, scalar
and out-of-range decode positions, tiny caches, the paged decode over
every page length it is checked at (with B4 on the gathered view as a
bit-for-bit oracle: the two share one body), the backward's ragged and
rectangular shapes, the key-row bias in the forward and backward (ragged,
causal with a bias, every head dim), the fused Adam's and fused LAMB's
dtypes, ragged and unaligned leaves, trust-ratio branches and overflow
skip, autograd through the kernels, attention dropout (in-kernel
Threefry bits against the host twin's) and the full bias in the forward
and both backwards (B2 and the two-pass B6a/B6b, whose dq must be the same
bits launch after launch), and the wrappers' refusals.  Tolerances: float32 2e-5 (sums in other orders, TF32 off);
bfloat16 outputs 2e-2 (rounded to bf16, spacing 2**-8 relative); the
backward entry by entry, within that tolerance times |entry| plus half
the gradient's rms (dq's f32 sum is taken with atomics, in an order that
changes between runs); fused Adam's moments 1e-6 of their largest entry,
f32 p 1e-6 absolute (the kernel rounds each product and sum as the plain
version does); fused LAMB the same, with its trust ratio 1e-5 relative
(its norms sum per block, in another order)."""
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


def _paged_inputs(dev, kv, page_len, d=64, H=3, S=1024):
    """Six slots over a permuted page pool: positions 0, 127, 128, 1023
    and a ragged one, plus an idle slot whose table is all garbage page
    and whose position (-1) leaves no attendable key: it attends
    uniformly over the whole gathered view, as the plain version does."""
    B, P = 6, S // page_len
    NP = 1 + (B - 1) * P
    qdtype = torch.float32 if kv == torch.float32 else torch.bfloat16
    q = _randn(dev, B, H, 1, d, seed=11).to(qdtype)
    k, v = _randn(dev, NP, H, page_len, d, seed=12), _randn(dev, NP, H, page_len, d, seed=13)
    if kv == "int8":
        kc, vc = (dict(zip(("q", "s"), _kv_quant(t))) for t in (k, v))
    else:
        kc, vc = k.to(kv), v.to(kv)
    perm = torch.randperm(NP - 1, generator=torch.Generator().manual_seed(page_len)) + 1
    table = torch.zeros(B, P, dtype=torch.int32)
    table[:B - 1] = perm.reshape(B - 1, P).to(torch.int32)
    pos = torch.tensor([0, 127, 128, S - 1, 555, -1], dtype=torch.int32)
    return q, kc, vc, table.to(dev), pos.to(dev)


@pytest.mark.parametrize("kv", [torch.float32, torch.bfloat16, "int8"], ids=["f32", "bf16", "int8"])
@pytest.mark.parametrize("page_len", [16, 64, 128])
def test_flash_decode_paged_kernel_matches_plain_and_b4(dev, kv, page_len):
    q, kc, vc, table, pos = _paged_inputs(dev, kv, page_len)
    out = fd.flash_decode_paged_cuda(q, kc, vc, table, pos)
    ref = fd.flash_decode_paged_reference(q, kc, vc, table, pos)
    # B4 over the gathered contiguous view: the same body and key order
    b4 = fd.flash_decode_cuda(q, fd.paged_gather(kc, table), fd.paged_gather(vc, table), pos)
    torch.cuda.synchronize()
    assert out.dtype == q.dtype and out.shape == q.shape and torch.isfinite(out).all()
    assert _err(out, ref) <= TOL[q.dtype]
    assert torch.equal(out, b4)


def test_flash_decode_paged_refusals_and_launch_count(dev):
    q, kc, vc, table, pos = _paged_inputs(dev, torch.bfloat16, 64)
    kernels.reset_launches()
    fd.flash_decode_paged(q, kc, vc, table, pos)
    fd.flash_decode_paged(q.cpu(), kc.cpu(), vc.cpu(), table.cpu(), pos.cpu())  # plain: no launch
    assert kernels.launches()["flash_decode_paged"] == 1
    with pytest.raises(ValueError, match="int32"):
        fd.flash_decode_paged_cuda(q, kc, vc, table.long(), pos)
    with pytest.raises(ValueError, match="CUDA"):
        fd.flash_decode_paged_cuda(q, kc, vc, table.cpu(), pos)
    with pytest.raises(ValueError, match="CUDA"):
        fd.flash_decode_paged_cuda(q.cpu(), kc.cpu(), vc.cpu(), table.cpu(), pos.cpu())
    wide = _randn(dev, 9, 3, 64, 192).to(torch.bfloat16)
    with pytest.raises(ValueError, match="cannot serve"):
        fd.flash_decode_paged_cuda(_randn(dev, 6, 3, 1, 192).to(torch.bfloat16), wide, wide,
                                   table, pos)
    assert kernels.launches()["flash_decode_paged"] == 1


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


def _padding_bias(dev, B, sk, keep):
    kb = torch.zeros(B, sk, device=dev)
    for b in range(B):
        kb[b, keep[b % len(keep)]:] = -1e9
    return kb


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("sq,sk,d,causal", [
    (512, 512, 64, False),   # BERT phase 2
    (500, 500, 64, False),   # ragged last tiles
    (256, 256, 32, True),    # causal with a bias
    (130, 257, 128, False),
    (300, 300, 128, True),
])
def test_flash_kbias_fwd_and_bwd_match_plain(dev, dtype, sq, sk, d, causal):
    q = _randn(dev, 3, 2, sq, d, seed=1).to(dtype)
    k = _randn(dev, 3, 2, sk, d, seed=2).to(dtype)
    v = _randn(dev, 3, 2, sk, d, seed=3).to(dtype)
    do = _randn(dev, 3, 2, sq, d, seed=4).to(dtype)
    kb = _padding_bias(dev, 3, sk, (sk, sk - 64, sk // 2 + 1))
    if causal:  # a smooth bias too, not only 0 / -1e9
        kb = kb + _randn(dev, 3, sk, seed=5)
    scale = d ** -0.5
    out, lse = fa.flash_fwd_cuda(q, k, v, causal, scale, want_lse=True, kbias=kb)
    ref, ref_lse = fa.flash_fwd_reference(q, k, v, causal, scale, kb)
    delta = (do.float() * out.float()).sum(-1)
    got = fa.flash_bwd_cuda(q, k, v, do, lse, delta, causal, scale, kbias=kb)
    refb = fa.flash_bwd_reference(q, k, v, do, lse, delta, causal, scale, kb)
    torch.cuda.synchronize()
    assert _err(out, ref) <= TOL[dtype] and _err(lse, ref_lse) <= 1e-4
    for a, b in zip(got, refb):
        a, b = a.float(), b.float()
        bound = TOL[dtype] * (b.abs() + 0.5 * b.square().mean().sqrt())
        assert bool(((a - b).abs() <= bound).all()), _err(a, b)
    if not causal:  # a padded key takes p == 0 exactly: its dk and dv are 0
        assert not got[1][2, :, sk // 2 + 1:].any() and not got[2][2, :, sk // 2 + 1:].any()


def test_autograd_with_a_padding_bias_matches_the_plain_path(dev):
    q, k, v = (_randn(dev, 2, 4, 512, 64, seed=s).requires_grad_() for s in (1, 2, 3))
    w = _randn(dev, 2, 4, 512, 64, seed=4)
    bias = _padding_bias(dev, 2, 512, (512, 300))[:, None, None, :]
    kernels.reset_launches()
    (fa.flash_attention(q, k, v, bias=bias) * w).sum().backward()
    assert kernels.launches()["flash_fwd"] == 1 and kernels.launches()["flash_bwd"] == 1
    got = [t.grad.clone() for t in (q, k, v)]
    for t in (q, k, v):
        t.grad = None
    (fa.mha_reference(q, k, v, bias=bias) * w).sum().backward()
    for a, t in zip(got, (q, k, v)):
        assert _err(a, t.grad) <= 1e-4  # f32 attention, sums in other orders


@pytest.mark.parametrize("n,pdtype,gdtype,offset,scale", [
    (30522 * 1024, torch.float32, torch.float32, 0, 1.0),   # tok_emb: trust at max_coeff
    (4096, torch.float32, torch.float32, 0, 0.002),          # trust inside the clamp
    (30522, torch.float32, torch.float32, 0, 0.0),           # zero leaf: trust 1
    (1001, torch.bfloat16, torch.float32, 0, 1.0),
    (4099, torch.float32, torch.bfloat16, 0, 1e-5),          # trust at min_coeff
    (4099, torch.float32, torch.float32, 1, 1.0),            # not 16-byte aligned
    (2, torch.float32, torch.float32, 0, 1.0),               # nsp_b
])
def test_fused_lamb_kernels_match_plain(dev, n, pdtype, gdtype, offset, scale):
    def leaf(seed, s=1.0):
        return (_randn(dev, n + offset, seed=seed) * s)[offset:]

    p, g = leaf(1, scale).to(pdtype), leaf(2, 1e-3).to(gdtype)
    # v bounded below, so |dir| <= ~0.02 per entry and the trust ratio's
    # branch follows from the leaf's scale
    m, v = leaf(3, 1e-4), leaf(4, 1e-3).square() + 1e-6
    hyper = dict(b1=0.9, b2=0.999, eps=1e-6, weight_decay=0.01, min_coeff=0.01, max_coeff=0.3)
    trusts = {}
    for keep in (1.0, 0.0):
        scal = torch.tensor([2e-3, keep, 0.271, 0.003], device=dev)
        pk, mk, vk = p.clone(), m.clone(), v.clone()
        trust = fu.lamb_leaf_cuda(pk, g, mk, vk, scal, **hyper)
        pr, mr, vr, tr = fu._lamb_math(p, g, m, v, *scal.unbind(0), **hyper)
        torch.cuda.synchronize()
        trusts[keep] = float(tr)
        assert abs(float(trust) - float(tr)) <= 1e-5 * float(tr)
        assert _err(pk, pr) <= (1e-6 * max(float(pr.float().abs().max()), 1e-30)
                                if pdtype == torch.float32 else 1e-2)
        for got, ref in ((mk, mr), (vk, vr)):
            assert _err(got, ref) <= 1e-6 * float(ref.abs().max())
        if keep == 0.0:  # the overflow skip writes back the old state
            assert torch.equal(pk, p) and torch.equal(mk, m) and torch.equal(vk, v)
    want = {1.0: 0.3, 0.0: 1.0, 1e-5: 0.01}.get(scale)
    if want is not None:
        assert trusts[1.0] == pytest.approx(want, rel=1e-6)


def test_lamb_engine_update_on_the_card_matches_the_cpu(dev):
    """One engine_update over several leaves sharing one direction
    scratch (a large leaf before small ones, so a stale tail would show)
    on the card against the CPU's plain version."""
    from deepspeed_tpu_torch.ops.lamb.fused_lamb import FusedLamb

    shapes = [(3000, 17), (5,), (64, 64), (2,)]
    params = {where: [_randn(dev, *s, seed=i).to(where) for i, s in enumerate(shapes)]
              for where in ("cpu", "cuda")}
    grads = [_randn(dev, *s, seed=10 + i) * 1e-3 for i, s in enumerate(shapes)]
    opt = FusedLamb(lr=2e-3, weight_decay=0.01, max_coeff=0.3, bias_correction=False)
    kernels.reset_launches()
    for where in ("cpu", "cuda"):
        st = opt.init(params[where])
        for _ in range(2):
            st = fu.engine_update(opt, [g.to(where) for g in grads], st, params[where], 2e-3,
                                  None)
    assert kernels.launches()["fused_lamb_dir"] == 8 == kernels.launches()["fused_lamb_apply"]
    for a, b in zip(params["cuda"], params["cpu"]):
        assert _err(a.cpu(), b) <= 1e-6 * float(b.abs().max())


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
    want = {"flash_fwd": 1, "flash_decode": 1, "flash_decode_paged": 0, "flash_bwd": 0,
            "fused_adam": 0, "fused_lamb_dir": 0, "fused_lamb_apply": 0, "flash_bwd_dq": 0,
            "flash_bwd_dkv": 0}
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
    """Greedy generate() and served tokens (slot pool and paged pool) of a
    small f32 GPT-2 on the card equal the CPU's plain path (T=130 takes
    the prefill kernel)."""
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
        paged = ServingEngine(eng, num_slots=2, prefill_chunk=32,
                              kvcache={"enabled": True, "page_len": 16})
        pids = [paged.submit(ids[1], max_new_tokens=8)]
        pres = paged.drain()  # learns ids[1] as a prefix: its repeat hits
        pids += [paged.submit(ids[i], max_new_tokens=8) for i in (1, 0)]
        pres.update(paged.drain())
        outs[where] = (gen, srv.drain()[rid].tokens(), [pres[i].tokens() for i in pids])
        if where == "cuda":
            assert paged.stats()["kvcache"]["prefix_hits"] >= 1
    np.testing.assert_array_equal(outs["cpu"][0], outs["cuda"][0])
    np.testing.assert_array_equal(outs["cpu"][1], outs["cuda"][1])
    np.testing.assert_array_equal(outs["cuda"][1], outs["cuda"][0][1])
    for got, want in zip(outs["cuda"][2], (outs["cuda"][0][1], outs["cuda"][0][1], outs["cuda"][0][0])):
        np.testing.assert_array_equal(got, want)


def _bwd_close(got, ref, dtype):
    for a, b in zip(got, ref):
        assert a.dtype == b.dtype and a.shape == b.shape
        a, b = a.float(), b.float()
        bound = TOL[dtype] * (b.abs() + 0.5 * b.square().mean().sqrt())
        assert bool(((a - b).abs() <= bound).all()), _err(a, b)


def _options(dev, kind, B, H, sq, sk, seed=7):
    """(kbias, fbias) of one bias form: none, the key-row form, a (B, 1, Tq,
    Tk) mask with a smooth part (read through a stride-0 head dim), or a
    (1, H, Tq, Tk) bias (stride 0 on the batch)."""
    if kind == "kbias":
        return _padding_bias(dev, B, sk, (sk, sk - 64, sk // 2 + 1)), None
    if kind == "fbias_mask":
        m = _randn(dev, B, 1, sq, sk, seed=seed) * 0.5
        m[0, :, :, sk - 40:] = -1e9
        return None, m.expand(B, H, sq, sk)
    if kind == "fbias_heads":
        return None, (_randn(dev, 1, H, sq, sk, seed=seed) * 0.5).expand(B, H, sq, sk)
    return None, None


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("kind", ["none", "kbias", "fbias_mask", "fbias_heads"])
@pytest.mark.parametrize("sq,sk,d,causal,rate", [
    (512, 512, 64, False, 0.1),   # BERT phase 2
    (300, 300, 128, True, 0.1),   # ragged, causal
    (130, 257, 32, False, 0.25),
    (200, 200, 16, True, 0.0),    # the full bias without dropout
])
def test_flash_dropout_and_fbias_fwd_bwd_match_plain(dev, dtype, kind, sq, sk, d, causal, rate):
    B, H = 3, 2
    q = _randn(dev, B, H, sq, d, seed=1).to(dtype)
    k = _randn(dev, B, H, sk, d, seed=2).to(dtype)
    v = _randn(dev, B, H, sk, d, seed=3).to(dtype)
    do = _randn(dev, B, H, sq, d, seed=4).to(dtype)
    kb, fb = _options(dev, kind, B, H, sq, sk)
    drop = fa.make_dropout(rate, (2**31 + 9, 77))
    scale = d ** -0.5
    out, lse = fa.flash_fwd_cuda(q, k, v, causal, scale, want_lse=True, kbias=kb, fbias=fb,
                                 drop=drop)
    ref, ref_lse = fa.flash_fwd_reference(q, k, v, causal, scale, kb, fb, drop)
    delta = (do.float() * out.float()).sum(-1)
    got = fa.flash_bwd_cuda(q, k, v, do, lse, delta, causal, scale, kb, fb, drop)
    two = fa.flash_bwd2_cuda(q, k, v, do, lse, delta, causal, scale, kb, fb, drop)
    refb = fa.flash_bwd_reference(q, k, v, do, lse, delta, causal, scale, kb, fb, drop)
    torch.cuda.synchronize()
    assert _err(out, ref) <= TOL[dtype] and _err(lse, ref_lse) <= 1e-4
    _bwd_close(got, refb, dtype)
    _bwd_close(two, refb, dtype)
    if kind == "kbias" and not causal:  # a padded key's dk and dv stay exactly 0
        for grads in (got, two):
            assert not grads[1][2, :, sk // 2 + 1:].any() and not grads[2][2, :, sk // 2 + 1:].any()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_two_pass_dq_is_the_same_bits_every_launch(dev, dtype):
    """B6a sums dq in registers and writes it once: two launches give the
    same bits (B2's atomic dq need not)."""
    q, k, v, do = (_randn(dev, 2, 4, 1000, 64, seed=s).to(dtype) for s in (1, 2, 3, 4))
    kb = _padding_bias(dev, 2, 1000, (1000, 700))
    drop = fa.make_dropout(0.1, (5, 6))
    out, lse = fa.flash_fwd_cuda(q, k, v, False, 0.125, want_lse=True, kbias=kb, drop=drop)
    delta = (do.float() * out.float()).sum(-1)
    a = fa.flash_bwd2_cuda(q, k, v, do, lse, delta, False, 0.125, kbias=kb, drop=drop)
    b = fa.flash_bwd2_cuda(q, k, v, do, lse, delta, False, 0.125, kbias=kb, drop=drop)
    torch.cuda.synchronize()
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def test_autograd_with_dropout_and_a_trainable_full_bias_matches_the_plain_path(dev, monkeypatch):
    """flash_attention with dropout and a trainable (1, H, T, T) bias through
    the kernels (B1, then B2; and B6 with the threshold patched down)
    against the plain path with the host twin's keep-mask: q, k, v and
    bias gradients."""
    q, k, v = (_randn(dev, 2, 4, 512, 64, seed=s).requires_grad_() for s in (1, 2, 3))
    w = _randn(dev, 2, 4, 512, 64, seed=4)
    bias = (_randn(dev, 1, 4, 512, 512, seed=5) * 0.5).requires_grad_()
    key = (123, 2**32 - 5)
    mask = fa.dropout_keep_mask_host(key, 2, 4, 512, 512, 0.9, dev).reshape(2, 4, 512, 512)
    (fa.mha_reference(q, k, v, bias=bias, dropout_mask=mask, keep_prob=0.9) * w).sum().backward()
    want = [t.grad.clone() for t in (q, k, v, bias)]
    for fused_max, route in ((1 << 21, "flash_bwd"), (64 * 64 * 4, "flash_bwd_dq")):
        monkeypatch.setattr(fa, "_FUSED_BWD_MAX_SQ_BYTES", fused_max)
        for t in (q, k, v, bias):
            t.grad = None
        kernels.reset_launches()
        (fa.flash_attention(q, k, v, bias=bias, dropout_rate=0.1, dropout_rng=key) * w
         ).sum().backward()
        got = kernels.launches()
        assert got["flash_fwd"] == 1 and got[route] == 1
        assert kernels.launch_variants()["flash_fwd"] == {"fbias+dropout": 1}
        for a, t in zip(want, (q, k, v, bias)):
            assert _err(t.grad, a) <= 1e-4 * max(1.0, float(a.abs().max()))


def test_dropout_and_fbias_refusals(dev):
    q = _randn(dev, 1, 2, 128, 64)
    kb = torch.zeros(1, 128, device=dev)
    fb = torch.zeros(1, 2, 128, 128, device=dev)
    with pytest.raises(ValueError, match="not both"):
        fa.flash_fwd_cuda(q, q, q, False, 0.125, kbias=kb, fbias=fb)
    with pytest.raises(ValueError, match="fbias"):
        fa.flash_fwd_cuda(q, q, q, False, 0.125, fbias=fb[:, :1])  # not expanded to (B, H, T, T)
    with pytest.raises(ValueError, match="fbias"):
        fa.flash_bwd2_cuda(q, q, q, q, q[..., 0].contiguous(), q[..., 0].contiguous(), False,
                           0.125, fbias=fb.half())
