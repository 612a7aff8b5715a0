"""The port's quantizer (``ops/quantizer/quantizer.py``) and weight
quantizer (``runtime/weight_quantizer.py``) against the JAX package's, on
the CPU, on the same numpy inputs from a seed.

* ``quantize``, symmetric and asymmetric, over several ``groups`` and
  ``bits``: within 1e-6 of the JAX values relative to each tensor's range
  (the same f32 operations; a code that rounds the other way would move a
  value by a whole step, 1/127 of the range at 8 bits).
* ``quantize_int8`` / ``dequantize_int8``: the codes equal, the scales and
  zeros within 1e-6 relative.
* ``quantize_per_channel`` codes equal, scales within 1e-6 relative, and
  ``int8_matmul`` within 1e-5 of JAX's.
* ``WeightQuantization``'s trees and ``pack_int8_tree`` on GPT2_TINY's and
  BERT_TINY's parameters: the same leaf set, the same codes, dequantized
  values within 1e-6 relative.
* Stochastic rounding (another generator than JAX's PRNG key, ROADMAP C4)
  held statistically: every value on the quantization grid, each a
  neighbour of the input, and the mean of 2,000 draws within 4 standard
  errors of the input (unbiased).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.models import bert as jbert
from deepspeed_tpu.models import gpt2 as jgpt2
from deepspeed_tpu.ops.quantizer import quantizer as jq
from deepspeed_tpu.runtime import weight_quantizer as jwq
from deepspeed_tpu_torch.ops.quantizer import quantizer as tq
from deepspeed_tpu_torch.runtime import weight_quantizer as twq

REL = 1e-6


def _x(shape, seed=0, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def _rel_close(got, want, rel=REL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    span = max(float(np.abs(want).max()), 1e-30)
    assert got.shape == want.shape
    assert float(np.abs(got - want).max()) <= rel * span, float(np.abs(got - want).max()) / span


@pytest.mark.parametrize("symmetric", [True, False], ids=["sym", "asym"])
@pytest.mark.parametrize("groups,bits", [(1, 8), (4, 8), (8, 4), (16, 2)])
def test_quantize_matches_jax(symmetric, groups, bits):
    x = _x((16, 48), seed=groups + bits)
    x[3] = 0.0  # an all-zero group
    want = np.asarray(jq.quantize(jnp.asarray(x), groups=groups, bits=bits, symmetric=symmetric))
    got = tq.quantize(torch.from_numpy(x), groups=groups, bits=bits, symmetric=symmetric)
    assert got.dtype == torch.float32
    _rel_close(got.numpy(), want)
    np.testing.assert_allclose(
        tq.ds_quantizer(torch.from_numpy(x), groups=groups, bit_num=bits, asym=not symmetric)
        .numpy(), got.numpy(), rtol=0, atol=0)


def test_quantize_keeps_dtype_and_refuses_bad_groups():
    x = torch.from_numpy(_x((4, 8))).to(torch.bfloat16)
    assert tq.quantize(x, groups=2).dtype == torch.bfloat16
    with pytest.raises(ValueError, match="divisible by groups"):
        tq.quantize(x, groups=3)
    with pytest.raises(ValueError, match="torch.Generator"):
        tq.quantize(x, stochastic=True)


@pytest.mark.parametrize("symmetric", [True, False], ids=["sym", "asym"])
@pytest.mark.parametrize("groups", [1, 6])
def test_quantize_int8_and_dequantize_match_jax(symmetric, groups):
    x = _x((12, 32), seed=groups, scale=3.0)
    want = jq.quantize_int8(jnp.asarray(x), groups=groups, symmetric=symmetric)
    got = tq.quantize_int8(torch.from_numpy(x), groups=groups, symmetric=symmetric)
    assert len(got) == len(want) == (2 if symmetric else 3)
    assert got[0].dtype == (torch.int8 if symmetric else torch.uint8)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    for g, w in zip(got[1:], want[1:]):
        _rel_close(g.numpy(), np.asarray(w))
    zero = (got[2], want[2]) if not symmetric else (None, None)
    deq = tq.dequantize_int8(got[0], got[1], zero[0], groups=groups)
    jdeq = jq.dequantize_int8(want[0], want[1], zero[1], groups=groups)
    _rel_close(deq.numpy(), np.asarray(jdeq))
    _rel_close(deq.numpy(), x, rel=1.0 / 120)  # within half a step of the input


def test_quantize_per_channel_and_int8_matmul_match_jax():
    w = _x((3, 64, 48), seed=11)
    w[1, :, 5] = 0.0  # an all-zero output channel: scale 1
    q, s = tq.quantize_per_channel(torch.from_numpy(w))
    jqq, js = jq.quantize_per_channel(jnp.asarray(w))
    assert q.dtype == torch.int8 and s.dtype == torch.float32 and s.shape == (3, 48)
    np.testing.assert_array_equal(q.numpy(), np.asarray(jqq))
    _rel_close(s.numpy(), np.asarray(js))
    assert float(s[1, 5]) == 1.0
    x = _x((3, 5, 64), seed=12)  # (B, T, in) against layer 1's (in, out) pair
    got = tq.int8_matmul(torch.from_numpy(x), q[1], s[1])
    want = np.asarray(jq.int8_matmul(jnp.asarray(x), jqq[1], js[1]))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        elif isinstance(v, tuple):
            for i, a in enumerate(v):
                out[f"{prefix}{k}/{i}"] = np.asarray(a)
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def _torch_tree(tree):
    return {k: (_torch_tree(v) if isinstance(v, dict) else torch.from_numpy(np.asarray(v)))
            for k, v in tree.items()}


def _compare_trees(got, want):
    got, want = _flat(got), _flat(want)
    assert set(got) == set(want)
    for k in want:
        g = got[k].numpy() if isinstance(got[k], torch.Tensor) else np.asarray(got[k])
        if want[k].dtype == np.int8:
            assert g.dtype == np.int8, k
            np.testing.assert_array_equal(g, want[k], err_msg=k)
        else:
            _rel_close(g, want[k])


@pytest.mark.parametrize("family", ["gpt2", "bert"])
@pytest.mark.parametrize("bits,groups,extra", [(8, 1, False), (8, 4, True), (4, 2, False)])
def test_weight_quantization_trees_match_jax(family, bits, groups, extra):
    params = (jgpt2.init_params(jgpt2.GPT2_TINY, seed=3) if family == "gpt2"
              else jbert.init_params(jbert.BERT_TINY, seed=3))
    jw = jwq.WeightQuantization(bits=bits, groups=groups, mlp_extra_grouping=extra)
    tw = twq.WeightQuantization(bits=bits, groups=groups, mlp_extra_grouping=extra)
    _compare_trees(tw.quantize_dequantize_tree(_torch_tree(params)),
                   jw.quantize_dequantize_tree(params))
    got, want = tw.quantize_tree_packed(_torch_tree(params)), jw.quantize_tree_packed(params)
    assert set(got) == set(want) and got
    for k in want:
        np.testing.assert_array_equal(got[k][0].numpy(), want[k][0], err_msg=k)
        _rel_close(got[k][1].numpy(), want[k][1])
    # the shim
    _compare_trees(twq.quantize_transformer_layer(_torch_tree(params), bits=bits, groups=groups),
                   jwq.quantize_transformer_layer(params, bits=bits, groups=groups))


def test_weight_quantization_refuses_bits():
    with pytest.raises(ValueError, match="bits must be 4 or 8"):
        twq.WeightQuantization(bits=3)


@pytest.mark.parametrize("family", ["gpt2", "bert"])
def test_pack_int8_tree_matches_jax(family):
    params = (jgpt2.init_params(jgpt2.GPT2_TINY, seed=5) if family == "gpt2"
              else jbert.init_params(jbert.BERT_TINY, seed=5))
    want = jwq.pack_int8_tree(params)
    got = twq.pack_int8_tree(_torch_tree(params))
    _compare_trees(got, want)
    packed = [k for k, v in _flat(want).items() if v.dtype == np.int8]
    assert packed and all(k.split("/")[-2].endswith("_w") for k in packed)
    # jax arrays on the JAX side pack alike (its jitted device path)
    dev = jwq.pack_int8_tree(jax.tree.map(jnp.asarray, params))
    _compare_trees(got, dev)


def test_stochastic_rounding_is_on_the_grid_and_unbiased():
    x = torch.from_numpy(_x((1, 256), seed=21))
    levels = 2.0 ** 7
    scale = float(x.abs().max()) / (levels - 1)
    gen = torch.Generator().manual_seed(0)
    draws = torch.stack([tq.quantize(x, bits=8, stochastic=True, generator=gen)
                         for _ in range(2000)])
    codes = draws / scale
    assert torch.allclose(codes, torch.round(codes), atol=1e-3)  # on the grid
    lo, hi = torch.floor(x / scale - 1e-4), torch.ceil(x / scale + 1e-4)
    assert bool(((codes >= lo - 1e-3) & (codes <= hi + 1e-3)).all())  # a neighbour of x
    # unbiased: the mean of the draws within 4 standard errors of x
    # (each draw's error has variance at most scale**2 / 4)
    se = scale / 2 / np.sqrt(draws.shape[0])
    assert float((draws.mean(0) - x).abs().max()) < 4 * se
    # the same generator state gives the same draws; another seed others
    a = tq.quantize(x, stochastic=True, generator=torch.Generator().manual_seed(3))
    b = tq.quantize(x, stochastic=True, generator=torch.Generator().manual_seed(3))
    c = tq.quantize(x, stochastic=True, generator=torch.Generator().manual_seed(4))
    assert torch.equal(a, b) and not torch.equal(a, c)
