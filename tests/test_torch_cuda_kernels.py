"""The port's CUDA kernels against their plain PyTorch versions, on the card.

These tests need an NVIDIA GPU and ``nvcc`` (the kernels are built from
``deepspeed_tpu_torch/csrc`` at first use and have no CPU mode), so they
carry the ``cuda`` marker and skip where ``torch.cuda.is_available()`` is
False.  They import neither JAX nor the JAX package, so they run on a
machine that has only PyTorch; there, without the JAX test harness:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda_kernels.py

They cover what ``chip_smoke.py`` does not drive: ragged and rectangular
prefill shapes, the lse output, every head dim the kernels take, scalar
and out-of-range decode positions, positions at the split decode's chunk
edges and lengths a chunk does not divide (the same bits launch after
launch, f32 within 1e-6 of the split plain version), tiny caches, 16-byte
alignment refusals, the paged decode over
every page length it is checked at (with B4 on the gathered view as a
bit-for-bit oracle: the two share one body), the backward's ragged and
rectangular shapes, the key-row bias in the forward and backward (ragged,
causal with a bias, every head dim), the fused Adam's and fused LAMB's
dtypes, ragged and unaligned leaves, trust-ratio branches and overflow
skip, autograd through the kernels, attention dropout (in-kernel
Threefry bits against the host twin's) and the full bias in the forward
and both backwards (B2 and the two-pass B6a/B6b, whose dq, dk and dv must
be the same bits launch after launch), the block-sparse kernels
B8/B9a/B9b (every layout form: BigBird, per-head, untouched key columns, a
row with no block, all ones, blocks of 16, 96, 128 and 256; out, lse and
dq/dk/dv the same bits launch after launch), the bf16 tensor-core bodies
of B1, B2, B6a, B6b, B8, B9a and B9b at every head dim with every option (ragged,
end-aligned and full; each launch counted as ``tc``, an f32 one as
``simt``), and the wrappers' refusals.  Tolerances: float32 2e-5 (sums
in other orders, TF32 off); bfloat16 outputs 2e-2 (rounded to bf16,
spacing 2**-8 relative); the backward entry by entry, within that
tolerance times |entry| plus half the gradient's rms (the bf16
tensor-core bodies of B2, B6, B9a and B9b, and their plain versions,
against the float64 function within the bf16 contract's bound,
``flash_attention.flash_bwd_float64`` / ``sparse.splash_bwd_float64``,
since a bf16 P or dS next to a rounding tie may round either way; for the
f32 block-sparse backward, the rms of the entry's own layout block, its
share grown as the square root of that block's sum past 1,024 terms); fused Adam's moments 1e-6 of their largest entry,
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
    # a chunk's edges (127, 128, 129) and S one below and one above a chunk
    (4, 3, 127, 64, torch.float32, False, [126, 0, 63, 500]),
    (4, 3, 129, 64, torch.float32, True, [127, 128, 5, 64]),
    (4, 3, 129, 32, torch.bfloat16, False, [127, 128, 129, -1]),
    (4, 2, 384, 16, "int8", True, [127, 128, 129, 383]),
    (3, 2, 300, 128, torch.float32, True, [255, 256, 257]),
])
def test_flash_decode_kernel_matches_plain(dev, B, H, S, d, kv, masked, pos):
    """The split kernel against the plain version (and, f32, within 1e-6 of
    its split plain version, the same chunks and combine), the same bits
    on a second launch."""
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
    again = fd.flash_decode_cuda(q, kc, vc, pos_t, key_padding_mask=kpm)
    ref = fd.flash_decode_reference(q, kc, vc, pos_t, key_padding_mask=kpm)
    split = fd.flash_decode_split_reference(q, kc, vc, pos_t, key_padding_mask=kpm)
    torch.cuda.synchronize()
    assert torch.isfinite(out).all()
    assert _err(out, ref) <= TOL[qdtype]
    assert torch.equal(out, again)
    if qdtype == torch.float32:
        assert _err(out, split) <= 1e-6


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
    again = fd.flash_decode_paged_cuda(q, kc, vc, table, pos)
    torch.cuda.synchronize()
    assert out.dtype == q.dtype and out.shape == q.shape and torch.isfinite(out).all()
    assert _err(out, ref) <= TOL[q.dtype]
    assert torch.equal(out, b4) and torch.equal(out, again)


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
    # 16-byte row loads: a pool or a cache off a 16-byte boundary is refused
    odd = torch.empty(kc.numel() + 1, dtype=kc.dtype, device=dev)[1:].view(kc.shape)
    with pytest.raises(ValueError, match="16-byte"):
        fd.flash_decode_paged_cuda(q, odd, vc, table, pos)
    slot = torch.empty(6 * 3 * 64 * 64 + 1, dtype=kc.dtype, device=dev)[1:].view(6, 3, 64, 64)
    with pytest.raises(ValueError, match="16-byte"):
        fd.flash_decode_cuda(q, slot, slot, pos)
    assert kernels.launches()["flash_decode_paged"] == 1
    assert kernels.launches()["flash_decode"] == 0


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
    _grads_close(got, ref, dtype, (q, k, v, do, lse, delta, causal, scale))


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
    _grads_close(got, refb, dtype, (q, k, v, do, lse, delta, causal, scale, kb))
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
            "flash_bwd_dkv": 0, "splash_fwd": 0, "splash_bwd_dq": 0, "splash_bwd_dkv": 0}
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


def _grads_close(got, ref, dtype, args):
    """B2's or B6's gradients against the plain version: f32 (the CUDA-core
    bodies) entry by entry; bf16 (the tensor-core bodies), and the plain
    version, against the float64 function of the same inputs ``args``
    within the bound of the bf16 contract (``flash_bwd_float64``)."""
    if dtype != torch.bfloat16:
        _bwd_close(got, ref, dtype)
        return
    for a, b in zip(got, ref):
        assert a.dtype == b.dtype and a.shape == b.shape and bool(a.isfinite().all())
    witness = fa.flash_bwd_float64(*args)
    kernel, plain = fa.float64_over_bound(got, witness), fa.float64_over_bound(ref, witness)
    assert max(kernel) <= 1.0 and max(plain) <= 1.0, (kernel, plain)


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
    _grads_close(got, refb, dtype, (q, k, v, do, lse, delta, causal, scale, kb, fb, drop))
    _grads_close(two, refb, dtype, (q, k, v, do, lse, delta, causal, scale, kb, fb, drop))
    if kind == "kbias" and not causal:  # a padded key's dk and dv stay exactly 0
        for grads in (got, two):
            assert not grads[1][2, :, sk // 2 + 1:].any() and not grads[2][2, :, sk // 2 + 1:].any()


@pytest.mark.parametrize("d", [16, 32, 64, 128])
@pytest.mark.parametrize("sq,sk,causal", [
    (200, 200, True),     # ragged last tiles
    (1000, 1000, True),   # ragged, many tiles
    (100, 300, True),     # end-aligned: queries are the last 100 positions
    (257, 257, False),    # full attention, one row past a tile
])
@pytest.mark.parametrize("kind", ["none", "kbias", "fbias_mask", "fbias_heads", "dropout",
                                  "kbias_dropout"])
def test_tensor_core_bodies_match_plain(dev, d, sq, sk, causal, kind):
    """B1 and B2 on bf16 tensors take the tensor-core bodies
    (flash_fwd_tc.cu, flash_bwd_tc.cu): out within 2e-2 and lse within
    1e-4 of the plain version, the gradients (and the plain version's)
    within the float64 bound of the bf16 contract, at every head dim with
    every option; each launch is counted as ``tc``."""
    B, H = 3, 2
    q = _randn(dev, B, H, sq, d, seed=1).to(torch.bfloat16)
    k = _randn(dev, B, H, sk, d, seed=2).to(torch.bfloat16)
    v = _randn(dev, B, H, sk, d, seed=3).to(torch.bfloat16)
    do = _randn(dev, B, H, sq, d, seed=4).to(torch.bfloat16)
    kb, fb = _options(dev, kind.replace("_dropout", "").replace("dropout", "none"), B, H, sq, sk)
    drop = fa.make_dropout(0.1, (2**31 + 9, 77)) if "dropout" in kind else None
    scale = d ** -0.5
    kernels.reset_launches()
    out, lse = fa.flash_fwd_cuda(q, k, v, causal, scale, want_lse=True, kbias=kb, fbias=fb,
                                 drop=drop)
    delta = (do.float() * out.float()).sum(-1)
    got = fa.flash_bwd_cuda(q, k, v, do, lse, delta, causal, scale, kb, fb, drop)
    torch.cuda.synchronize()
    ref, ref_lse = fa.flash_fwd_reference(q, k, v, causal, scale, kb, fb, drop)
    refb = fa.flash_bwd_reference(q, k, v, do, lse, delta, causal, scale, kb, fb, drop)
    assert out.dtype == torch.bfloat16 and torch.isfinite(out).all()
    assert _err(out, ref) <= TOL[torch.bfloat16]
    assert _err(lse, ref_lse) <= 1e-4
    _grads_close(got, refb, torch.bfloat16, (q, k, v, do, lse, delta, causal, scale, kb, fb, drop))
    form = fa._variant(kb, fb, drop)
    variants = kernels.launch_variants()
    assert variants["flash_fwd"] == {form + "/tc": 1} and variants["flash_bwd"] == {form + "/tc": 1}


def test_bf16_launches_count_as_tc_and_f32_as_simt(dev):
    """The wrapper picks the body by dtype and names it in the variant (B1,
    B2, and B6a/B6b); a bf16 view off a 16-byte boundary is refused, not
    sent to the f32 body."""
    q = _randn(dev, 1, 2, 128, 64)
    lse = torch.zeros(1, 2, 128, device=dev)
    kernels.reset_launches()
    for t in (q, q.to(torch.bfloat16)):
        out, lse = fa.flash_fwd_cuda(t, t, t, True, 0.125, want_lse=True)
        delta = (t.float() * out.float()).sum(-1)
        fa.flash_bwd_cuda(t, t, t, t, lse, delta, True, 0.125)
        fa.flash_bwd2_cuda(t, t, t, t, lse, delta, True, 0.125)
    torch.cuda.synchronize()
    want = {"none/simt": 1, "none/tc": 1}
    for name in ("flash_fwd", "flash_bwd", "flash_bwd_dq", "flash_bwd_dkv"):
        assert kernels.launches()[name] == 2
        assert kernels.launch_variants()[name] == want
    odd = torch.empty(2 * 128 * 64 + 1, dtype=torch.bfloat16, device=dev)[1:].view(1, 2, 128, 64)
    with pytest.raises(ValueError, match="16-byte"):
        fa.flash_fwd_cuda(odd, odd, odd, True, 0.125)
    for launch in (fa.flash_bwd_dq_cuda, fa.flash_bwd_dkv_cuda):
        with pytest.raises(ValueError, match="16-byte"):
            launch(odd, odd, odd, odd, lse, delta, True, 0.125)
    assert all(kernels.launches()[name] == 2 for name in ("flash_fwd", "flash_bwd_dq",
                                                          "flash_bwd_dkv"))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_two_pass_dq_is_the_same_bits_every_launch(dev, dtype):
    """B6a sums dq in registers and writes it once, on either body (bf16:
    the tensor cores'): two launches give the same bits."""
    q, k, v, do = (_randn(dev, 2, 4, 1000, 64, seed=s).to(dtype) for s in (1, 2, 3, 4))
    kb = _padding_bias(dev, 2, 1000, (1000, 700))
    drop = fa.make_dropout(0.1, (5, 6))
    out, lse = fa.flash_fwd_cuda(q, k, v, False, 0.125, want_lse=True, kbias=kb, drop=drop)
    delta = (do.float() * out.float()).sum(-1)
    kernels.reset_launches()
    a = fa.flash_bwd2_cuda(q, k, v, do, lse, delta, False, 0.125, kbias=kb, drop=drop)
    b = fa.flash_bwd2_cuda(q, k, v, do, lse, delta, False, 0.125, kbias=kb, drop=drop)
    torch.cuda.synchronize()
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    form = "kbias+dropout/" + ("tc" if dtype == torch.bfloat16 else "simt")
    assert kernels.launch_variants()["flash_bwd_dq"] == {form: 2}
    assert kernels.launch_variants()["flash_bwd_dkv"] == {form: 2}


@pytest.mark.parametrize("d", [16, 32, 64, 128])
@pytest.mark.parametrize("sq,sk,causal", [
    (200, 200, True),     # ragged last tiles
    (1000, 1000, True),   # ragged, many tiles
    (100, 300, True),     # end-aligned: queries are the last 100 positions
    (257, 257, False),    # full attention, one row past a tile
])
@pytest.mark.parametrize("kind", ["none", "kbias", "fbias_mask", "fbias_heads", "dropout",
                                  "kbias_dropout", "fbias_mask_dropout"])
def test_two_pass_tensor_core_bodies_lie_within_the_float64_bound(dev, d, sq, sk, causal, kind):
    """B6a and B6b on bf16 tensors take the tensor-core bodies
    (flash_bwd_2pass_tc.cu): their gradients and the plain version's within
    the float64 bound of the bf16 contract, at every head dim with every
    option; each launch counted as ``tc``; a padded key's dk and dv exactly
    0; dk and dv the same bits as B2's (the same key-tile walk)."""
    B, H = 3, 2
    q = _randn(dev, B, H, sq, d, seed=1).to(torch.bfloat16)
    k = _randn(dev, B, H, sk, d, seed=2).to(torch.bfloat16)
    v = _randn(dev, B, H, sk, d, seed=3).to(torch.bfloat16)
    do = _randn(dev, B, H, sq, d, seed=4).to(torch.bfloat16)
    kb, fb = _options(dev, kind.replace("_dropout", "").replace("dropout", "none"), B, H, sq, sk)
    drop = fa.make_dropout(0.1, (2**31 + 9, 77)) if "dropout" in kind else None
    scale = d ** -0.5
    out, lse = fa.flash_fwd_cuda(q, k, v, causal, scale, want_lse=True, kbias=kb, fbias=fb,
                                 drop=drop)
    delta = (do.float() * out.float()).sum(-1)
    args = (q, k, v, do, lse, delta, causal, scale, kb, fb, drop)
    kernels.reset_launches()
    got = fa.flash_bwd2_cuda(*args)
    single = fa.flash_bwd_cuda(*args)
    torch.cuda.synchronize()
    form = fa._variant(kb, fb, drop) + "/tc"
    variants = kernels.launch_variants()
    assert variants["flash_bwd_dq"] == {form: 1} and variants["flash_bwd_dkv"] == {form: 1}
    _grads_close(got, fa.flash_bwd2_reference(*args), torch.bfloat16, args)
    assert torch.equal(got[1], single[1]) and torch.equal(got[2], single[2])
    if kb is not None and not causal:  # batch row 2 keeps sk // 2 + 1 keys
        assert not got[1][2, :, sk // 2 + 1:].any() and not got[2][2, :, sk // 2 + 1:].any()


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
        assert kernels.launch_variants()["flash_fwd"] == {"fbias+dropout/simt": 1}
        assert kernels.launch_variants()[route] == {"fbias+dropout/simt": 1}
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


# ---------------------------------------------------------------------------
# block-sparse attention: B8 (splash_fwd), B9a (splash_bwd_dq), B9b
# (splash_bwd_dkv) against their plain versions
# ---------------------------------------------------------------------------


def _splash_layout(kind, H, nb, block):
    from deepspeed_tpu_torch.ops.attention import sparse as sp

    if kind in ("bigbird-uni", "bigbird-bi"):
        att = "unidirectional" if kind == "bigbird-uni" else "bidirectional"
        return sp.BigBirdSparsityConfig(num_heads=H, block=block, attention=att).make_layout(
            nb * block)
    if kind == "all-ones":
        return sp.DenseSparsityConfig(num_heads=H, block=block).make_layout(nb * block)
    return sp.check_layouts(nb)[kind]  # per-head, untouched-columns, zero-degree-row (H = 2)


def _splash_bwd_close(got, ref, dtype, args):
    """The splash backward against its plain version: f32 (the CUDA-core
    bodies) entry by entry, within the bound chip_smoke.py holds it to
    (``sparse.splash_grad_bound``); bf16 (the tensor-core bodies), and the
    plain version, against the float64 function of the same inputs
    ``args`` within the bound of the bf16 contract
    (``sparse.splash_bwd_float64``)."""
    from deepspeed_tpu_torch.ops.attention import sparse as sp

    layout, block = args[6], args[7]
    for a, b in zip(got, ref):
        assert a.dtype == b.dtype and a.shape == b.shape and bool(a.isfinite().all())
    if dtype == torch.bfloat16:
        witness = sp.splash_bwd_float64(*args)
        kernel, plain = fa.float64_over_bound(got, witness), fa.float64_over_bound(ref, witness)
        assert max(kernel) <= 1.0 and max(plain) <= 1.0, (kernel, plain)
        return
    for name, a, b in zip(("dq", "dk", "dv"), got, ref):
        bound, _ = sp.splash_grad_bound(name, b, layout, block, TOL[dtype])
        assert bool(((a.float() - b.float()).abs() <= bound).all()), _err(a, b)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("kind,causal,T,d,block", [
    ("bigbird-uni", True, 4096, 64, 256),     # the main path's layout, shorter
    ("bigbird-bi", False, 1024, 32, 128),     # global rows: 0 here, the dense bucket's
    ("per-head", True, 512, 128, 64),         # the (H, E) index form
    ("untouched-columns", True, 256, 16, 64),
    ("zero-degree-row", False, 256, 64, 64),
    ("all-ones", True, 512, 64, 128),         # exempt from the dense bucket
    ("bigbird-uni", True, 384, 64, 96),       # a block that is no multiple of 64
    ("bigbird-bi", False, 128, 16, 16),       # a block below one tile
])
def test_splash_kernels_match_plain(dev, dtype, kind, causal, T, d, block):
    from deepspeed_tpu_torch.ops.attention import sparse as sp

    B, H = 2, 2
    layout = _splash_layout(kind, H, T // block, block)
    q, k, v, do = (_randn(dev, B, H, T, d, seed=s).to(dtype) for s in (1, 2, 3, 4))
    scale = d ** -0.5
    kernels.reset_launches()
    out, lse = sp.splash_fwd_cuda(q, k, v, layout, block, causal, scale, want_lse=True)
    out2, lse2 = sp.splash_fwd_cuda(q, k, v, layout, block, causal, scale, want_lse=True)
    ref, ref_lse = sp.splash_fwd_reference(q, k, v, layout, block, causal, scale)
    torch.cuda.synchronize()
    assert out.dtype == dtype and _err(out, ref) <= TOL[dtype]
    assert torch.equal(out, out2) and torch.equal(lse, lse2)  # no atomics: the same bits
    inf = torch.isinf(ref_lse)
    assert torch.equal(torch.isinf(lse), inf)
    assert _err(lse[~inf], ref_lse[~inf]) <= 1e-4
    assert not out[inf].any()
    delta = (do.float() * out.float()).sum(-1)
    args = (q, k, v, do, lse, delta, layout, block, causal, scale)
    got = (sp.splash_bwd_dq_cuda(*args), *sp.splash_bwd_dkv_cuda(*args))
    again = (sp.splash_bwd_dq_cuda(*args), *sp.splash_bwd_dkv_cuda(*args))
    ref = (sp.splash_bwd_dq_reference(*args), *sp.splash_bwd_dkv_reference(*args))
    torch.cuda.synchronize()
    form = "none/" + ("tc" if dtype == torch.bfloat16 else "simt")
    variants = kernels.launch_variants()
    assert variants["splash_fwd"] == {form: 2}
    assert variants["splash_bwd_dq"] == {form: 2} and variants["splash_bwd_dkv"] == {form: 2}
    _splash_bwd_close(got, ref, dtype, args)
    for a, b in zip(got, again):  # no atomics: the same bits every launch
        assert torch.equal(a, b)
    if kind == "untouched-columns":
        nb = T // block
        for h, col in sp.UNTOUCHED_COLUMNS:
            for g in got[1:]:
                assert not g.reshape(B, H, nb, block, d)[:, h, col].any(), (h, col)
    if kind == "zero-degree-row":
        assert not out.reshape(B, H, T // block, block, d)[:, 0, 1].any()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", ["gpt2-causal", "bert-kbias"])
@pytest.mark.parametrize("rate", [0.0, 0.1], ids=["nodrop", "dropout"])
def test_flash_bwd_is_the_same_bits_every_launch(dev, dtype, shape, rate):
    """B2 adds each key tile's dq share into its f32 buffer in the q tile's
    turn, in ascending key tile (both bodies): dq, dk and dv are the same
    bits over launches, at GPT-2's causal training shape and at BERT's
    shape with its key-padding bias, with and without dropout."""
    if shape == "gpt2-causal":
        B, H, T, causal, kb = 8, 12, 1024, True, None
    else:
        B, H, T, causal = 8, 16, 512, False
        kb = _padding_bias(dev, B, T, (512, 448, 300, 129))
    q, k, v, do = (_randn(dev, B, H, T, 64, seed=s).to(dtype) for s in (1, 2, 3, 4))
    drop = fa.make_dropout(rate, (0x9E3779B9, 0xBB67AE85))
    out, lse = fa.flash_fwd_cuda(q, k, v, causal, 0.125, want_lse=True, kbias=kb, drop=drop)
    delta = (do.float() * out.float()).sum(-1)
    args = (q, k, v, do, lse, delta, causal, 0.125, kb, None, drop)
    first = fa.flash_bwd_cuda(*args)
    for _ in range(2):
        again = fa.flash_bwd_cuda(*args)
        torch.cuda.synchronize()
        for a, b in zip(first, again):
            assert torch.equal(a, b)


def test_splash_autograd_on_the_card_matches_the_gather_path(dev):
    """block_sparse_attention's auto route on the card (B8, then B9a and
    B9b, with BigBird's dense global rows outside the kernels) against the
    gather path, f32: output and q, k, v gradients."""
    from deepspeed_tpu_torch.ops.attention import sparse as sp

    T, block = 1024, 128
    layout = _splash_layout("bigbird-bi", 4, T // block, block)
    q, k, v = (_randn(dev, 2, 4, T, 64, seed=s).requires_grad_() for s in (1, 2, 3))
    w = _randn(dev, 2, 4, T, 64, seed=4)
    (sp.block_sparse_attention(q, k, v, layout, block, backend="gather") * w).sum().backward()
    want = [t.grad.clone() for t in (q, k, v)]
    for t in (q, k, v):
        t.grad = None
    kernels.reset_launches()
    (sp.block_sparse_attention(q, k, v, layout, block) * w).sum().backward()
    got = kernels.launches()
    assert (got["splash_fwd"], got["splash_bwd_dq"], got["splash_bwd_dkv"]) == (1, 1, 1)
    for a, t in zip(want, (q, k, v)):
        assert _err(t.grad, a) <= 1e-4 * max(1.0, float(a.abs().max()))


def test_splash_refusals(dev):
    from deepspeed_tpu_torch.ops.attention import sparse as sp

    layout = _splash_layout("bigbird-uni", 2, 4, 64)
    q = _randn(dev, 1, 2, 256, 64)
    with pytest.raises(ValueError, match="layout"):
        sp.splash_fwd_cuda(q, q, q, layout[:, :2, :2], 64, True, 0.125)
    with pytest.raises(ValueError, match="multiple"):
        sp.splash_fwd_cuda(q, q, q, layout, 100, True, 0.125)
    with pytest.raises(ValueError, match="head_dim"):
        sp.splash_fwd_cuda(q[..., :48].contiguous(), q[..., :48].contiguous(),
                           q[..., :48].contiguous(), layout, 64, True, 0.125)
    with pytest.raises(ValueError, match="contiguous"):
        sp.splash_fwd_cuda(q.transpose(2, 3).contiguous().transpose(2, 3), q, q, layout, 64,
                           True, 0.125)
    lse = q[..., 0].contiguous()
    with pytest.raises(ValueError, match="float32"):
        sp.splash_bwd_dkv_cuda(q, q, q, q, lse.double(), lse, layout, 64, True, 0.125)
    # the bf16 bodies load 16-byte rows by TMA and cp.async: a view off a
    # 16-byte boundary is refused, not sent to the f32 body
    odd = torch.empty(2 * 256 * 64 + 1, dtype=torch.bfloat16, device=dev)[1:].view(1, 2, 256, 64)
    kernels.reset_launches()
    with pytest.raises(ValueError, match="16-byte"):
        sp.splash_fwd_cuda(odd, odd, odd, layout, 64, True, 0.125)
    for launch in (sp.splash_bwd_dq_cuda, sp.splash_bwd_dkv_cuda):
        with pytest.raises(ValueError, match="16-byte"):
            launch(odd, odd, odd, odd, lse, lse, layout, 64, True, 0.125)
    assert sum(kernels.launches()[n] for n in ("splash_fwd", "splash_bwd_dq",
                                               "splash_bwd_dkv")) == 0


def test_nccl_collectives_at_world_1(dev, tmp_path):
    """The collectives layer on CUDA tensors through NCCL, world size 1,
    under the launcher environment: all-reduce, reduce-scatter, all-gather
    and the stage-3 autograd gather, f32 and bf16, odd sizes, each equal
    to its plain expectation (``tools/zero_worker.py``'s check, in a child
    process so the group does not outlive the test)."""
    import json
    import os
    import socket
    import subprocess
    import sys

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    spec = tmp_path / "spec.json"
    spec.write_text(json.dumps({"device": "cuda", "deterministic": False, "out": str(tmp_path),
                                "collectives_check": True, "cases": []}))
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, WORLD_SIZE="1", RANK="0", LOCAL_RANK="0", MASTER_ADDR="127.0.0.1",
               MASTER_PORT=str(port), PYTHONPATH=repo)
    proc = subprocess.run([sys.executable, "-m", "deepspeed_tpu_torch.tools.zero_worker",
                           str(spec)], env=env, cwd=repo, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-2000:]
    out = json.loads((tmp_path / "collectives.json").read_text())
    assert out["backend"] == "nccl" and out["world_size"] == 1
    assert {r["dtype"] for r in out["rows"]} == {"float32", "bfloat16"}
    bad = [r for r in out["rows"] if not r["ok"]]
    assert not bad, bad


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_virtual_ring_matches_dense_flash(dev, dtype, causal):
    """Ring attention's schedule over 4 virtual ranks on one card
    (``parallel.sequence.VirtualRing``): its blocks are B1 with its lse and
    B2 with the merged lse (a causal ring of 4 runs 10 blocks each way, a
    full one 16), against dense B1/B2 over the whole sequence.  The
    output within the dtype's tolerance; f32 gradients entry by entry
    within 2e-5 times |entry| plus half the rms; bf16 gradients against
    the float64 function within the ring's bound (``ring_bwd_float64``:
    every block's bf16 contract, its f32 sum and last rounding; the ring's
    lse and delta given); a second backward the same bits."""
    from deepspeed_tpu_torch.parallel import sequence as sq

    B, H, T, d, P = 1, 4, 1024, 64, 4
    q, k, v, do = (_randn(dev, B, H, T, d, seed=s).to(dtype) for s in range(4))
    scale = d ** -0.5
    kernels.reset_launches()
    grads = []
    for _ in range(2):
        leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
        out = sq.ring_attention(*leaves, causal=causal, ring=sq.VirtualRing(P))
        out.backward(do)
        grads.append([t.grad for t in leaves])
    torch.cuda.synchronize()
    blocks = P * (P + 1) // 2 if causal else P * P
    assert kernels.launches()["flash_fwd"] == 2 * blocks
    assert kernels.launches()["flash_bwd"] == 2 * blocks
    body = "tc" if dtype == torch.bfloat16 else "simt"
    assert all(v.endswith("/" + body) for v in kernels.launch_variants()["flash_fwd"])
    assert all(torch.equal(a, b) for a, b in zip(*grads))
    ref, lse = fa.flash_fwd_cuda(q, k, v, causal, scale, want_lse=True)
    assert _err(out, ref) <= TOL[dtype]
    qs, ks, vs = (list(t.chunk(P, dim=2)) for t in (q, k, v))
    ring = sq.VirtualRing(P)
    outs, lses = sq.ring_forward([t.contiguous() for t in qs], [t.contiguous() for t in ks],
                                 [t.contiguous() for t in vs], ring, causal, scale)
    ring_lse = torch.cat(lses, dim=2)
    assert _err(ring_lse, lse) <= 1e-4
    delta = (do.float() * out.detach().float()).sum(-1)
    if dtype == torch.float32:
        want = fa.flash_bwd_cuda(q, k, v, do, lse, delta, causal, scale)
        for g, w in zip(grads[0], want):
            bound = 2e-5 * (w.abs() + 0.5 * w.square().mean().sqrt())
            assert bool(((g - w).abs() <= bound).all())
    else:
        witness = sq.ring_bwd_float64(q, k, v, do, ring_lse, delta, P, causal, scale)
        assert max(fa.float64_over_bound(grads[0], witness)) <= 1.0


@pytest.mark.parametrize("shape", [(2, 2560, 7680), (2, 10240, 2560)], ids=["qkv", "fc_proj"])
def test_int8_pack_on_the_card_equals_the_host(dev, shape):
    """Packing a weight on the card gives the host's int8 codes and f32
    scales bit for bit (the counterpart of the JAX package's
    test_int8_pack_device_equals_host), in f32 and from bf16."""
    from deepspeed_tpu_torch.runtime.weight_quantizer import pack_one

    w = _randn(dev, *shape, seed=3) * 0.02
    for t in (w, w.to(torch.bfloat16)):
        card, host = pack_one(t), pack_one(t.cpu())
        assert card["q"].dtype == torch.int8 and card["s"].dtype == torch.float32
        assert torch.equal(card["q"].cpu(), host["q"]) and torch.equal(card["s"].cpu(), host["s"])
