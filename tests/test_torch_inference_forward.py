"""``InferenceEngine.forward`` / ``__call__`` of the port against the JAX
engine's, on the CPU, in float32, and the BERT family in
``init_inference``.

Both engines take the same numpy parameters (``init_params`` from one
seed): ``GPT2_TINY`` gives logits (B, T, V), ``BERT_TINY`` encoder states
(B, T, d) with ``token_type_ids`` and a padding ``attention_mask``.
Tolerance 1e-5 absolute: two layers of f32 sums in other orders.  The BERT
engine refuses the generation surface as the JAX engine does, and the GPT
engine refuses BERT's keyword arguments and sequences past
``n_positions``."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.models import bert as jbert
from deepspeed_tpu.models import gpt2 as jgpt2
from deepspeed_tpu_torch.models import bert as tbert
from deepspeed_tpu_torch.models import gpt2 as tgpt2

TOL = 1e-5


def _engines(jcfg=None, tcfg=None, **kw):
    """The two engines on the same parameters: ``model_config=jcfg`` /
    ``tcfg`` each side's config class, or a preset name in ``kw``."""
    jeng = deepspeed_tpu.init_inference(dtype=jnp.float32, model_config=jcfg, **kw)
    teng = deepspeed_tpu_torch.init_inference(dtype=torch.float32, device="cpu",
                                              model_config=tcfg, **kw)
    return jeng, teng


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=TOL)


@pytest.mark.parametrize("T", [16, 128], ids=["dense-branch", "flash-branch"])
def test_gpt_forward_matches_jax(T):
    params = jgpt2.init_params(jgpt2.GPT2_TINY, seed=2)
    jeng, teng = _engines(jgpt2.GPT2_TINY, tgpt2.GPT2_TINY, params=params)
    ids = np.random.default_rng(3).integers(0, 512, (2, T), dtype=np.int32)
    want = jeng.forward(ids)
    got = teng(ids)  # __call__ is forward
    assert tuple(got.shape) == (2, T, 512)
    _close(got, want)
    # the port's own tensors as parameters give the same logits
    own = deepspeed_tpu_torch.init_inference(model_config=tgpt2.GPT2_TINY,
                                             params=tgpt2.params_from_jax(params),
                                             dtype=torch.float32, device="cpu")
    _close(own.forward(ids), want)
    assert not teng.model_config.remat  # no backward to save memory for


def test_gpt_forward_refusals_match_jax():
    jeng, teng = _engines(model="tiny")
    ids = np.zeros((1, 8), np.int32)
    for eng in (jeng, teng):
        with pytest.raises(TypeError, match="BERT-only"):
            eng.forward(ids, attention_mask=np.ones((1, 8), np.int32))
        with pytest.raises(ValueError, match="n_positions"):
            eng.forward(np.zeros((1, 129), np.int32))


def test_bert_forward_with_a_mask_matches_jax():
    params = jbert.init_params(jbert.BERT_TINY, seed=4)
    jeng, teng = _engines(jbert.BERT_TINY, tbert.BERT_TINY, params=params)
    rng = np.random.default_rng(5)
    ids = rng.integers(0, 512, (2, 24), dtype=np.int32)
    types = (np.arange(24)[None] >= 12).astype(np.int32).repeat(2, 0)
    mask = np.ones((2, 24), np.int32)
    mask[1, 17:] = 0
    want = jeng(ids, token_type_ids=types, attention_mask=mask)
    got = teng(ids, token_type_ids=types, attention_mask=mask)
    assert tuple(got.shape) == (2, 24, 64)
    _close(got, want)
    _close(teng.forward(ids), jeng.forward(ids))  # no segments, no mask


@pytest.mark.parametrize("preset", ["bert-tiny", "bert-base", "bert-large"])
def test_bert_presets_resolve_as_in_the_jax_package(preset):
    jeng, teng = _engines(model=preset) if preset == "bert-tiny" else (None, None)
    want = (jbert.PRESETS.get(preset) or jbert.PRESETS[preset.replace("bert-", "")])
    if teng is None:  # the large presets: resolve only, no engine built
        got = tbert.PRESETS.get(preset) or tbert.PRESETS[preset.replace("bert-", "")]
    else:
        got = teng.model_config
        assert isinstance(got, tbert.BertConfig) and jeng.model_config.hidden_size == 64
    for f in ("vocab_size", "hidden_size", "num_hidden_layers", "num_attention_heads",
              "intermediate_size", "max_position_embeddings"):
        assert getattr(got, f) == getattr(want, f)
    # a GPT-2 preset wins a shared name, as in the JAX package
    assert isinstance(deepspeed_tpu_torch.init_inference(model="tiny", device="cpu").model_config,
                      tgpt2.GPT2Config)


def test_bert_engine_refuses_generation_as_the_jax_engine_does():
    jeng, teng = _engines(model="bert-tiny")
    ids = np.zeros((1, 8), np.int32)
    for eng in (jeng, teng):
        with pytest.raises(ValueError, match="causal-LM"):
            eng.generate(ids, max_new_tokens=2)
        with pytest.raises(ValueError, match="causal-LM"):
            eng.init_cache(1, 16)
    with pytest.raises(ValueError, match="causal-LM"):
        teng.prefill(ids, None, None)
    with pytest.raises(ValueError, match="causal-LM"):
        teng.decode_step(ids, None, None, 0)
    assert teng.generation_capacity == jeng.generation_capacity == 1024
    with pytest.raises(ValueError, match="unknown model preset"):
        deepspeed_tpu_torch.init_inference(model="bert-huge", device="cpu")
    with pytest.raises(ValueError, match="GPT2Config or a BertConfig"):
        deepspeed_tpu_torch.init_inference(model_config=object(), device="cpu")
