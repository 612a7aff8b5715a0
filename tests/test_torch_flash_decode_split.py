"""The split decode's plain version (``flash_decode_split_reference``: the
CUDA kernel's chunked arithmetic, per-chunk softmax states combined in
chunk order) against the JAX package's decode, on the CPU.

The JAX side is the Pallas kernel run as ``tests/test_kernels.py`` runs
it (``interpret=True``; its grid needs ``S % 128 == 0``, and the paged
one ``page_len % 128 == 0``) and, where its grid cannot serve the shape,
the lax ground truth it is tested against (``cache_attention`` /
``paged_cache_attention`` with ``use_kernel=False``).  Inputs come from
one numpy seed and go through both.

Covered: f32, bf16 and int8 caches; masked and unmasked; a row with no
attendable key (uniform over all S keys); positions at chunk boundaries
(chunk - 1, chunk, chunk + 1) and past the end; S not a multiple of the
chunk; page lengths 16 and 128.

Tolerances: float32 and int8 caches 2e-5, the JAX kernel tests' own
bound (f32 arithmetic in other summation orders); bfloat16 caches 2e-2
(the output rounded to bf16, spacing 2**-8 relative).  Against the port's
unsplit plain version (``flash_decode_reference``) in f32: 1e-6, the
rounding of a few f32 sums and exponents."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.ops.kernels import flash_decode as jfd
from deepspeed_tpu.ops.transformer import inference as jinf
from deepspeed_tpu_torch.ops.kernels import flash_decode as tfd
from deepspeed_tpu_torch.ops.transformer import inference as tinf

F32_TOL = 2e-5
BF16_TOL = 2e-2
SPLIT_TOL = 1e-6


def _rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _err(j, t):
    return float(np.max(np.abs(np.asarray(j, np.float32) - t.float().numpy())))


def _caches(kv, k, v):
    """(jax k, jax v, torch k, torch v) for one cache kind; int8 caches are
    quantized on each side by its own _kv_quant."""
    if kv == "int8":
        jk, jv = (dict(zip(("q", "s"), jinf._kv_quant(jnp.asarray(a)))) for a in (k, v))
        tk, tv = (dict(zip(("q", "s"), tinf._kv_quant(torch.from_numpy(a)))) for a in (k, v))
        return jk, jv, tk, tv
    jd, td = (jnp.float32, torch.float32) if kv == "f32" else (jnp.bfloat16, torch.bfloat16)
    return (jnp.asarray(k, jd), jnp.asarray(v, jd),
            torch.from_numpy(k).to(td), torch.from_numpy(v).to(td))


def _q(kv, q):
    if kv == "bf16":
        return jnp.asarray(q, jnp.bfloat16), torch.from_numpy(q).to(torch.bfloat16)
    return jnp.asarray(q), torch.from_numpy(q)


def _mask(B, S, pos, seed):
    """A key-padding mask keeping ~60 % of the keys, key 0 of every row,
    and none of row 3's attendable keys (a row with no attendable key)."""
    mask = np.random.default_rng(seed).random((B, S)) < 0.6
    mask[:, 0] = True
    mask[3, : max(pos[3], 0) + 1] = False
    return mask


@pytest.mark.parametrize("kv", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("masked", [False, True], ids=["unmasked", "masked"])
def test_split_reference_matches_the_jax_kernel(kv, masked):
    """The Pallas kernel (interpreted) at S 256 against the split at the
    kernel's chunk (positions 127, 128, 129: the chunk's edges) and at a
    chunk of 48 that does not divide S (positions 47, 48, 49)."""
    B, H, S, d = 5, 2, 256, 16
    q, k, v = _rand((B, H, 1, d), 1), _rand((B, H, S, d), 2), _rand((B, H, S, d), 3)
    jk, jv, tk, tv = _caches(kv, k, v)
    jq, tq = _q(kv, q)
    tol = BF16_TOL if kv == "bf16" else F32_TOL
    for chunk in (tfd.DECODE_CHUNK, 48):
        pos = np.asarray([chunk - 1, chunk, chunk + 1, S - 1, 0], np.int32)
        mask = _mask(B, S, pos, 4) if masked else None
        ref = jfd.flash_decode(jq, jk, jv, jnp.asarray(pos),
                               key_padding_mask=None if mask is None else jnp.asarray(mask),
                               interpret=True)
        got = tfd.flash_decode_split_reference(
            tq, tk, tv, torch.from_numpy(pos),
            key_padding_mask=None if mask is None else torch.from_numpy(mask), chunk=chunk)
        assert got.dtype == tq.dtype and tuple(got.shape) == ref.shape
        assert _err(ref, got) < tol, (kv, masked, chunk)


@pytest.mark.parametrize("kv", ["f32", "int8"])
@pytest.mark.parametrize("S,chunk", [(130, 128), (200, 48), (96, 7), (64, 128)])
def test_split_reference_equals_the_unsplit_plain_version(kv, S, chunk):
    """Against ``flash_decode_reference`` within 1e-6 and JAX's lax ground
    truth within 2e-5, at lengths the chunk does not divide (or exceeds),
    masked and unmasked, with a row whose position lies past the end and
    a row with no attendable key (pos -1)."""
    B, H, d = 6, 2, 32
    q, k, v = _rand((B, H, 1, d), 5), _rand((B, H, S, d), 6), _rand((B, H, S, d), 7)
    jk, jv, tk, tv = _caches(kv, k, v)
    pos = np.asarray([chunk - 1, min(chunk, S - 1), min(chunk + 1, S - 1), S + 40, -1, S // 2],
                     np.int32)
    tq = torch.from_numpy(q)
    for mask in (None, _mask(B, S, pos, 8)):
        tmask = None if mask is None else torch.from_numpy(mask)
        got = tfd.flash_decode_split_reference(tq, tk, tv, torch.from_numpy(pos),
                                               key_padding_mask=tmask, chunk=chunk)
        plain = tfd.flash_decode_reference(tq, tk, tv, torch.from_numpy(pos),
                                           key_padding_mask=tmask)
        assert torch.isfinite(got).all()
        assert _err(plain.numpy(), got) <= SPLIT_TOL, (kv, S, chunk, mask is None)
        lax = jinf.cache_attention(jnp.asarray(q), jk, jv, jnp.asarray(pos),
                                   key_padding_mask=None if mask is None else jnp.asarray(mask),
                                   use_kernel=False)
        assert _err(lax, got) < F32_TOL


def test_a_row_with_no_attendable_key_is_uniform_over_every_key():
    """Every score masked: the softmax is uniform over all S keys (the
    chunks past the position included), so out is the mean of v."""
    B, H, S, d = 2, 1, 300, 16
    q, k, v = (torch.from_numpy(_rand(s, i)) for i, s in
               enumerate(((B, H, 1, d), (B, H, S, d), (B, H, S, d))))
    mask = torch.ones(B, S, dtype=torch.bool)
    mask[0, :11] = False
    got = tfd.flash_decode_split_reference(q, k, v, torch.tensor([10, -1]),
                                           key_padding_mask=mask)
    want = v.mean(2, keepdim=True)
    assert float((got - want).abs().max()) <= SPLIT_TOL


def _pools(kv, k, v):
    if kv == "int8":
        jk, jv = (dict(zip(("q", "s"), jinf._kv_quant(jnp.asarray(a)))) for a in (k, v))
        tk, tv = (dict(zip(("q", "s"), tinf._kv_quant(torch.from_numpy(a)))) for a in (k, v))
        return jk, jv, tk, tv
    return _caches(kv, k, v)


@pytest.mark.parametrize("kv", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("page_len", [16, 128])
def test_split_reference_over_pages_matches_jax(kv, page_len):
    """The split over the gathered view of a page pool (a permuted table,
    one slot all garbage page with no attendable key) against JAX's paged
    decode: the Pallas kernel (interpreted) at page_len 128, the lax
    gather where its grid cannot serve page_len 16."""
    B, H, d = 4, 2, 16
    P = 256 // page_len
    NP = 1 + (B - 1) * P
    q = _rand((B, H, 1, d), 9)
    jk, jv, tk, tv = _pools(kv, _rand((NP, H, page_len, d), 10), _rand((NP, H, page_len, d), 11))
    table = np.zeros((B, P), np.int32)
    table[: B - 1] = np.random.default_rng(12).permutation(np.arange(1, NP, dtype=np.int32)
                                                           ).reshape(B - 1, P)
    chunk = tfd.DECODE_CHUNK
    pos = np.asarray([chunk - 1, chunk, chunk + 1, -1], np.int32)
    jq, tq = _q(kv, q)
    jt, jp = jnp.asarray(table), jnp.asarray(pos)
    if page_len % 128 == 0:
        ref = jfd.flash_decode_paged(jq, jk, jv, jt, jp, interpret=True)
    else:
        ref = jinf.paged_cache_attention(jq, jk, jv, jt, jp, use_kernel=False)
    tt = torch.from_numpy(table)
    got = tfd.flash_decode_split_reference(tq, tfd.paged_gather(tk, tt), tfd.paged_gather(tv, tt),
                                           torch.from_numpy(pos))
    assert _err(ref, got) < (BF16_TOL if kv == "bf16" else F32_TOL), (kv, page_len)


def test_decode_shapes_the_kernel_serves():
    """16-byte row loads: head dims 16, 32, 64 and 128; any cache length
    and page length; at most 65535 slot-heads (the grid's y)."""
    for d in (16, 32, 64, 128):
        assert tfd.decode_supported(8, 12, 1000, d)
        assert tfd.decode_paged_supported(8, 12, 9000, 16, d)
    for d in (8, 48, 96, 256):
        assert not tfd.decode_supported(8, 12, 1024, d)
    assert not tfd.decode_supported(4096, 16, 1024, 64)
    assert not tfd.decode_paged_supported(1, 1, 2 ** 20, 2 ** 11, 64)
