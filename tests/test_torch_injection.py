"""Models from outside the repo, on the CPU, against the JAX package:
kernel injection (``inference/injection.py``), the Megatron checkpoint
loader (``inference/checkpoint.py``) and int8 weights at rest
(``init_inference(quantize_bits=8)``).

* Each policy on the same state dict gives the JAX policy's tree, leaf for
  leaf and bit for bit (float32): HF GPT-2, GPT-Neo with its folded
  sqrt(head_dim) query scale, BERT, and Megatron's per-head qkv
  de-interleave.  The injected engines' logits (encoder states for BERT)
  within 2e-5 of the JAX engines' on the same module (two layers of f32
  sums in other orders) and within 2e-3 of the HF module's own forward
  (the JAX tests' bound); greedy tokens equal JAX ``generate``'s.
* ``MegatronSDLoader`` merges 2 and 4 shards written with ``torch.save``
  back to the whole state dict, bit for bit and equal to the JAX loader's
  merge of the same files; version <= 1.0's contiguous [q|k|v] shards
  re-interleave by head; ``ckpt_list``'s order is the rank order;
  ``get_sd_loader_json``'s validation; ``find_megatron_checkpoints``
  follows ``latest``; the merged dict serves through ``init_inference``.
* ``quantize_bits=8`` on GPT2_TINY: int8 codes equal the JAX engine's and
  f32 scales within 1e-6 relative, on the device; logits within 2e-5 and
  greedy tokens equal JAX ``generate``'s, also through ``init_on_device``
  and ``checkpoint=`` (the pack applies to every source); the int8 slot
  and paged pools serve solo int8 ``generate()``'s tokens.  Other bits
  (and BERT) quantize and dequantize, as the JAX engine does, within
  2e-5.
"""
import dataclasses
import os
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.inference import checkpoint as jck
from deepspeed_tpu.inference import injection as jinj
from deepspeed_tpu.models import bert as jbert
from deepspeed_tpu.models import gpt2 as jgpt2
from deepspeed_tpu_torch.inference import checkpoint as tck
from deepspeed_tpu_torch.inference import injection as tinj
from deepspeed_tpu_torch.models import bert as tbert
from deepspeed_tpu_torch.models import gpt2 as tgpt2
from deepspeed_tpu_torch.serving import ServingEngine

ENGINE_TOL = 2e-5
HF_TOL = 2e-3
JTINY = dataclasses.replace(jgpt2.GPT2_TINY, remat=False)
CAP = 128


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v.detach().cpu().numpy() if isinstance(v, torch.Tensor) \
                else np.asarray(v)
    return out


def _same_tree(got, want):
    got, want = _flat(got), _flat(want)
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def _same_config(tcfg, jcfg):
    for f in dataclasses.fields(tcfg):
        if hasattr(jcfg, f.name) and f.name not in ("sparsity_config",):
            assert getattr(tcfg, f.name) == getattr(jcfg, f.name), f.name


# ---------------------------------------------------------------------------
# HF modules (tiny configs, random init, no download)
# ---------------------------------------------------------------------------

def _hf(kind):
    transformers = pytest.importorskip("transformers")
    torch.manual_seed(0)
    if kind == "gpt2":
        cfg = transformers.GPT2Config(vocab_size=128, n_positions=64, n_embd=32, n_layer=2,
                                      n_head=4, resid_pdrop=0.0, embd_pdrop=0.0, attn_pdrop=0.0)
        return transformers.GPT2LMHeadModel(cfg).eval()
    if kind == "gpt-neo":
        cfg = transformers.GPTNeoConfig(
            vocab_size=128, max_position_embeddings=64, hidden_size=32, num_layers=2,
            num_heads=4, attention_types=[[["global"], 2]], intermediate_size=128,
            resid_dropout=0.0, embed_dropout=0.0, attention_dropout=0.0)
        return transformers.GPTNeoForCausalLM(cfg).eval()
    cfg = transformers.BertConfig(vocab_size=100, hidden_size=32, num_hidden_layers=2,
                                  num_attention_heads=4, intermediate_size=64,
                                  max_position_embeddings=32, hidden_dropout_prob=0.0,
                                  attention_probs_dropout_prob=0.0)
    return transformers.BertForMaskedLM(cfg).eval()


@pytest.mark.parametrize("kind,policy", [("gpt2", "HFGPT2LayerPolicy"),
                                         ("gpt-neo", "HFGPTNEOLayerPolicy"),
                                         ("bert", "HFBertLayerPolicy")])
def test_hf_policy_gives_the_jax_policys_tree(kind, policy):
    model = _hf(kind)
    tcfg, tparams = tinj.replace_transformer_layer(model)
    jcfg, jparams = jinj.replace_transformer_layer(model)
    _same_config(tcfg, jcfg)
    _same_tree(tparams, jparams)
    # an explicit policy, and the module's state dict with its config
    tcfg2, tparams2 = tinj.replace_transformer_layer(
        SimpleNamespace(state_dict=model.state_dict, config=model.config),
        policy=getattr(tinj, policy))
    assert tcfg2 == tcfg
    _same_tree(tparams2, jparams)
    assert [p.__name__ for p in tinj.ALL_POLICIES] == [p.__name__ for p in jinj.ALL_POLICIES]
    assert getattr(tinj, policy).architectures == getattr(jinj, policy).architectures


def test_gpt_neo_folds_sqrt_head_dim_into_the_query():
    model = _hf("gpt-neo")
    _, params = tinj.HFGPTNEOLayerPolicy.convert(model)
    w = model.state_dict()["transformer.h.1.attn.attention.q_proj.weight"]
    np.testing.assert_array_equal(params["blocks"]["qkv_w"][1][:, :32].numpy(),
                                  (w.t() * float(np.sqrt(8))).numpy())
    k = model.state_dict()["transformer.h.1.attn.attention.k_proj.weight"]
    np.testing.assert_array_equal(params["blocks"]["qkv_w"][1][:, 32:64].numpy(), k.t().numpy())
    assert float(params["blocks"]["qkv_b"].abs().max()) == 0.0  # no q/k/v biases


@pytest.mark.parametrize("kind", ["gpt2", "gpt-neo"])
def test_injected_gpt_engines_match_jax_and_hf(kind):
    model = _hf(kind)
    toks = np.random.default_rng(0).integers(0, 128, (2, 10))
    with torch.no_grad():
        hf_logits = model(torch.tensor(toks)).logits.numpy()
    teng = deepspeed_tpu_torch.init_inference(model=model, dtype=torch.float32, device="cpu")
    jeng = deepspeed_tpu.init_inference(model=model, dtype=jnp.float32)
    got = teng.forward(toks).numpy()
    np.testing.assert_allclose(got, np.asarray(jeng.forward(toks.astype(np.int32))),
                               rtol=0, atol=ENGINE_TOL)
    np.testing.assert_allclose(got, hf_logits, rtol=HF_TOL, atol=HF_TOL)
    np.testing.assert_array_equal(teng.generate(toks, max_new_tokens=5),
                                  np.asarray(jeng.generate(toks.astype(np.int32),
                                                           max_new_tokens=5)))
    # the caller's module is untouched (the engine holds its own stacks)
    assert all(p.dtype == torch.float32 for p in model.parameters())


def test_injected_bert_engine_matches_jax_and_hf():
    model = _hf("bert")
    toks = np.random.default_rng(1).integers(0, 100, (2, 12))
    with torch.no_grad():
        hf_hidden = model.bert(torch.tensor(toks)).last_hidden_state.numpy()
    teng = deepspeed_tpu_torch.init_inference(model=model, dtype=torch.float32, device="cpu")
    jeng = deepspeed_tpu.init_inference(model=model, dtype=jnp.float32)
    got = teng.forward(toks).numpy()
    np.testing.assert_allclose(got, np.asarray(jeng.forward(toks.astype(np.int32))),
                               rtol=0, atol=ENGINE_TOL)
    np.testing.assert_allclose(got, hf_hidden, rtol=HF_TOL, atol=HF_TOL)
    assert isinstance(teng.model_config, tbert.BertConfig)


def test_injection_refusals_match_jax():
    model = _hf("gpt2")
    for init, kw in ((deepspeed_tpu_torch.init_inference, {"device": "cpu"}),
                     (deepspeed_tpu.init_inference, {})):
        with pytest.raises(ValueError, match="require kernel injection"):
            init(model=model, replace_with_kernel_inject=False, **kw)
    with pytest.raises(ValueError, match="No injection policy"):
        tinj.replace_transformer_layer(torch.nn.Linear(2, 2))
    with pytest.raises(ValueError, match="not a Megatron GPT state dict"):
        tinj.MegatronLayerPolicy.convert({"x": torch.zeros(1)})
    # a policy given explicitly serves even without kernel injection
    eng = deepspeed_tpu_torch.init_inference(model=model, injection_policy=tinj.HFGPT2LayerPolicy,
                                             replace_with_kernel_inject=False,
                                             dtype=torch.float32, device="cpu")
    assert eng.model_config.n_layer == 2


# ---------------------------------------------------------------------------
# Megatron: the policy and the loader
# ---------------------------------------------------------------------------

def _megatron_sd(d=16, heads=4, layers=2, vocab=64, seq=32, seed=0):
    rng = np.random.default_rng(seed)
    r = lambda *shape: rng.standard_normal(shape).astype(np.float32)  # noqa: E731
    sd = {"language_model.embedding.word_embeddings.weight": r(vocab, d),
          "language_model.embedding.position_embeddings.weight": r(seq, d) * 0.1,
          "language_model.transformer.final_layernorm.weight": 1 + r(d) * 0.1,
          "language_model.transformer.final_layernorm.bias": r(d) * 0.1}
    for i in range(layers):
        L = f"language_model.transformer.layers.{i}."
        sd.update({
            L + "input_layernorm.weight": 1 + r(d) * 0.1, L + "input_layernorm.bias": r(d) * 0.1,
            L + "attention.query_key_value.weight": r(3 * d, d) * 0.2,
            L + "attention.query_key_value.bias": r(3 * d) * 0.1,
            L + "attention.dense.weight": r(d, d) * 0.2, L + "attention.dense.bias": r(d) * 0.1,
            L + "post_attention_layernorm.weight": 1 + r(d) * 0.1,
            L + "post_attention_layernorm.bias": r(d) * 0.1,
            L + "mlp.dense_h_to_4h.weight": r(4 * d, d) * 0.2,
            L + "mlp.dense_h_to_4h.bias": r(4 * d) * 0.1,
            L + "mlp.dense_4h_to_h.weight": r(d, 4 * d) * 0.2,
            L + "mlp.dense_4h_to_h.bias": r(d) * 0.1})
    return sd


def _shards(full, tp):
    """Megatron's tensor-parallel cut of a whole state dict (the newer
    layout: each rank's rows of the per-head interleaved QKV)."""
    col = ("query_key_value.weight", "query_key_value.bias", "dense_h_to_4h.weight",
           "dense_h_to_4h.bias", "word_embeddings.weight")
    row = ("attention.dense.weight", "mlp.dense_4h_to_h.weight")
    out = []
    for r in range(tp):
        sd = {}
        for k, v in full.items():
            if k.endswith(col):
                sd[k] = np.array_split(v, tp, axis=0)[r]
            elif k.endswith(row):
                sd[k] = np.array_split(v, tp, axis=1)[r]
            else:
                sd[k] = v
        out.append(sd)
    return out


def _write(tmp, shards, tag="iter_0000100"):
    os.makedirs(tmp / tag, exist_ok=True)
    (tmp / "latest").write_text(tag)
    for r, sd in enumerate(shards):
        torch.save({"model": {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()},
                    "iteration": 100}, str(tmp / tag / f"mp_rank_{r:02d}_model_states.pt"))


def test_megatron_policy_deinterleaves_qkv_as_jax():
    full = _megatron_sd()
    d, heads, hd = 16, 4, 4
    src = SimpleNamespace(num_attention_heads=heads)
    tcfg, tparams = tinj.MegatronLayerPolicy.convert(
        {k: torch.from_numpy(v) for k, v in full.items()}, hf_config=src)
    jcfg, jparams = jinj.MegatronLayerPolicy.convert(full, hf_config=src)
    _same_config(tcfg, jcfg)
    _same_tree(tparams, jparams)
    assert tinj.MegatronLayerPolicy.matches(full)
    # the columns are contiguous q|k|v: head h's q rows of the fused weight
    fused = full["language_model.transformer.layers.1.attention.query_key_value.weight"]
    for h in range(heads):
        q_rows = fused[h * 3 * hd:h * 3 * hd + hd]
        np.testing.assert_array_equal(tparams["blocks"]["qkv_w"][1][:, h * hd:(h + 1) * hd].numpy(),
                                      q_rows.T)


@pytest.mark.parametrize("tp", [2, 4])
def test_megatron_loader_round_trips_and_matches_jax(tmp_path, tp):
    full = _megatron_sd(seed=tp)
    _write(tmp_path, _shards(full, tp))
    paths = tck.find_megatron_checkpoints(str(tmp_path))
    assert paths == [str(tmp_path / "iter_0000100" / f"mp_rank_{r:02d}_model_states.pt")
                     for r in range(tp)]
    merged = tck.SDLoaderFactory.get_sd_loader(paths).load()
    jmerged = jck.SDLoaderFactory.get_sd_loader(paths).load()
    assert set(merged) == set(full) == set(jmerged)
    for k, v in full.items():
        assert isinstance(merged[k], torch.Tensor)
        np.testing.assert_array_equal(merged[k].numpy(), v, err_msg=k)
        np.testing.assert_array_equal(merged[k].numpy(), jmerged[k], err_msg=k)


def test_megatron_version_1_qkv_reinterleaves():
    d, heads, tp = 16, 4, 2
    hd, hpr = d // heads, heads // tp
    rng = np.random.default_rng(0)
    q, k, v = (torch.from_numpy(rng.standard_normal((d, d)).astype(np.float32)) for _ in range(3))
    old, new = [], []
    for r in range(tp):
        rows = slice(r * hpr * hd, (r + 1) * hpr * hd)
        old.append(torch.cat([q[rows], k[rows], v[rows]]))
        new.append(torch.cat([torch.cat([q[h * hd:(h + 1) * hd], k[h * hd:(h + 1) * hd],
                                         v[h * hd:(h + 1) * hd]])
                              for h in range(r * hpr, (r + 1) * hpr)]))
    key = "language_model.transformer.layers.0.attention.query_key_value.weight"
    merged_new = tck.MegatronSDLoader.merge_state_dicts([{key: s} for s in new], version=2.0)
    merged_old = tck.MegatronSDLoader.merge_state_dicts([{key: s} for s in old], version=1.0,
                                                        num_heads=heads)
    assert torch.equal(merged_old[key], merged_new[key])
    jold = jck.MegatronSDLoader.merge_state_dicts([{key: s.numpy()} for s in old], version=1.0,
                                                  num_heads=heads)
    np.testing.assert_array_equal(merged_old[key].numpy(), jold[key])
    bias = "language_model.transformer.layers.0.attention.query_key_value.bias"
    b_old = tck.MegatronSDLoader.merge_state_dicts(
        [{bias: s[:, 0].contiguous()} for s in old], version="0.9", num_heads=heads)
    assert torch.equal(b_old[bias], merged_new[key][:, 0])
    with pytest.raises(ValueError, match="num_heads"):
        tck.MegatronSDLoader.merge_state_dicts([{key: s} for s in old], version=1.0)


def test_megatron_ckpt_list_order_is_the_rank_order(tmp_path):
    key = "language_model.transformer.layers.0.mlp.dense_h_to_4h.weight"
    paths = []
    for tag, val in [("mp_rank_2", 0.0), ("mp_rank_10", 1.0)]:
        p = tmp_path / f"{tag}.pt"
        torch.save({"model": {key: torch.full((4, 2), val)}}, str(p))
        paths.append(str(p))
    merged = tck.SDLoaderFactory.get_sd_loader(paths).load()
    assert float(merged[key][:4].abs().max()) == 0.0 and float(merged[key][4:].min()) == 1.0
    merged = tck.SDLoaderFactory.get_sd_loader(paths[::-1]).load()
    assert float(merged[key][:4].min()) == 1.0


def test_sd_loader_json_and_validation(tmp_path):
    with pytest.raises(ValueError, match="empty checkpoint list"):
        tck.SDLoaderFactory.get_sd_loader([], "Megatron")
    with pytest.raises(ValueError, match="Megatron only"):
        tck.SDLoaderFactory.get_sd_loader(["x.pt"], "HF")
    loader = tck.SDLoaderFactory.get_sd_loader_json(
        {"type": "Megatron", "checkpoints": ["a.pt"], "version": 1.0})
    assert loader.ckpt_list == ["a.pt"] and loader.version == 1.0
    path = tmp_path / "ckpt.json"
    path.write_text('{"type": "megatron", "checkpoints": ["b.pt", "a.pt"]}')
    loader = tck.SDLoaderFactory.get_sd_loader_json(str(path))
    assert loader.ckpt_list == ["b.pt", "a.pt"] and loader.version is None
    with pytest.raises(KeyError):
        tck.SDLoaderFactory.get_sd_loader_json({"type": "Megatron"})
    (tmp_path / "step5").mkdir()
    (tmp_path / "step5" / "mp_rank_00_model_states.pt").write_bytes(b"")
    (tmp_path / "step5" / "other.pt").write_bytes(b"")
    (tmp_path / "latest").write_text("step5\n")
    assert tck.find_megatron_checkpoints(str(tmp_path)) == \
        jck.find_megatron_checkpoints(str(tmp_path)) == \
        [str(tmp_path / "step5" / "mp_rank_00_model_states.pt")]


def test_merged_megatron_checkpoint_serves_as_the_whole_weights(tmp_path):
    full = _megatron_sd(seed=9)
    _write(tmp_path, _shards(full, 2))
    merged = tck.SDLoaderFactory.get_sd_loader(tck.find_megatron_checkpoints(str(tmp_path))).load()
    whole = {k: torch.from_numpy(v) for k, v in full.items()}
    toks = np.random.default_rng(2).integers(0, 64, (2, 12))
    a = deepspeed_tpu_torch.init_inference(model=merged, dtype=torch.float32, device="cpu")
    b = deepspeed_tpu_torch.init_inference(model=whole, dtype=torch.float32, device="cpu")
    assert torch.equal(a.forward(toks), b.forward(toks))
    jeng = deepspeed_tpu.init_inference(model=full, dtype=jnp.float32)
    np.testing.assert_allclose(a.forward(toks).numpy(), np.asarray(jeng.forward(
        toks.astype(np.int32))), rtol=0, atol=ENGINE_TOL)
    srv = deepspeed_tpu_torch.init_serving(model=merged, dtype=torch.float32, device="cpu",
                                           serving={"num_slots": 2, "prefill_chunk": 8})
    rid = srv.submit(toks[0].astype(np.int32), max_new_tokens=4)
    np.testing.assert_array_equal(srv.drain()[rid].tokens(), a.generate(toks[:1],
                                                                        max_new_tokens=4)[0])


# ---------------------------------------------------------------------------
# int8 weights at rest
# ---------------------------------------------------------------------------

def _gpt_params():
    p = jgpt2.init_params(JTINY, seed=7)
    p["wpe"] = p["wpe"] * 40.0  # positions that matter, as tests/test_torch_serving.py has it
    return p


@pytest.fixture(scope="module")
def int8_engines():
    params = _gpt_params()
    jeng = deepspeed_tpu.init_inference(model_config=JTINY, params=params, dtype=jnp.float32,
                                        quantize_bits=8, max_out_tokens=CAP)
    teng = deepspeed_tpu_torch.init_inference(model_config=tgpt2.GPT2_TINY, params=params,
                                              dtype=torch.float32, quantize_bits=8,
                                              device="cpu", max_out_tokens=CAP)
    return params, jeng, teng


def test_int8_leaves_are_packed_as_the_jax_engines(int8_engines):
    _, jeng, teng = int8_engines
    got, want = _flat(teng.params), _flat(jeng.params)
    assert set(got) == set(want)
    packed = sorted(k for k, v in got.items() if v.dtype == np.int8)
    assert packed == [f"blocks/{n}/q" for n in ("fc_proj_w", "fc_w", "proj_w", "qkv_w")]
    for k in want:
        if k.endswith("/q"):
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        elif k.endswith("/s"):
            assert got[k].dtype == np.float32
            np.testing.assert_allclose(got[k], want[k], rtol=1e-6, atol=0, err_msg=k)
    assert teng.params["blocks"]["qkv_w"]["q"].device.type == "cpu"
    fp = deepspeed_tpu_torch.init_inference(model_config=tgpt2.GPT2_TINY, params=_gpt_params(),
                                            dtype=torch.float32, device="cpu", max_out_tokens=CAP)
    assert teng.weight_bytes() < 0.6 * fp.weight_bytes()


def test_int8_logits_and_greedy_tokens_match_jax_generate(int8_engines):
    _, jeng, teng = int8_engines
    rng = np.random.default_rng(3)
    ids = rng.integers(1, 512, (2, 24))
    np.testing.assert_allclose(teng.forward(ids).numpy(), np.asarray(jeng.forward(ids)),
                               rtol=0, atol=ENGINE_TOL)
    for T, n in ((8, 8), (20, 6)):
        x = rng.integers(1, 512, (2, T))
        np.testing.assert_array_equal(teng.generate(x, max_new_tokens=n),
                                      np.asarray(jeng.generate(x, max_new_tokens=n)))
    mask = np.ones((2, 8), np.int64)
    mask[0, :3] = 0
    x = rng.integers(1, 512, (2, 8))
    np.testing.assert_array_equal(
        teng.generate(x, max_new_tokens=5, attention_mask=mask),
        np.asarray(jeng.generate(x, max_new_tokens=5, attention_mask=mask)))


def test_int8_pack_applies_to_device_init_and_checkpoints(int8_engines, tmp_path):
    params, _, teng = int8_engines
    dev = deepspeed_tpu_torch.init_inference(model="tiny", init_on_device=True, seed=2,
                                             quantize_bits=8, dtype=torch.float32, device="cpu")
    whole = deepspeed_tpu_torch.init_inference(model="tiny", init_on_device=True, seed=2,
                                               dtype=torch.float32, device="cpu")
    w = whole.params["blocks"]["fc_w"]
    q, s = dev.params["blocks"]["fc_w"]["q"], dev.params["blocks"]["fc_w"]["s"]
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    # each code within half a step of the weight drawn from the same seed
    assert float(((q.float() * s[:, None, :] - w).abs() / s[:, None, :]).max()) <= 0.5 + 1e-5
    # a tag of the port's training, read through checkpoint=, packs alike
    model_fn, init_fn, _ = tgpt2.make_model(tgpt2.GPT2_TINY)
    trainer, *_ = deepspeed_tpu_torch.initialize(
        model=model_fn, model_parameters=init_fn(seed=4), device="cpu",
        config={"train_micro_batch_size_per_gpu": 2, "steps_per_print": 1000,
                "optimizer": {"type": "SGD", "params": {"lr": 1e-3}}})
    trainer.save_checkpoint(str(tmp_path), tag="t0")
    from_tag = deepspeed_tpu_torch.init_inference(model="tiny", checkpoint=str(tmp_path),
                                                  quantize_bits=8, dtype=torch.float32,
                                                  device="cpu")
    from_params = deepspeed_tpu_torch.init_inference(model="tiny", params=init_fn(seed=4),
                                                     quantize_bits=8, dtype=torch.float32,
                                                     device="cpu")
    _same_tree(from_tag.params, from_params.params)


SLOT = {"num_slots": 2, "prefill_chunk": 8, "max_len": 64}
PAGED = {**SLOT, "kvcache": {"enabled": True, "page_len": 16}}


@pytest.mark.parametrize("serving", [SLOT, PAGED], ids=["slot", "paged"])
def test_int8_pools_serve_solo_generate_tokens(int8_engines, serving):
    _, _, teng = int8_engines
    rng = np.random.default_rng(5)
    shared = rng.integers(1, 512, 20)
    prompts = [np.concatenate([shared, rng.integers(1, 512, n)]).astype(np.int32)
               for n in (3, 7, 2)] + [rng.integers(1, 512, 11).astype(np.int32)]
    srv = ServingEngine(teng, config=serving)
    ids = [srv.submit(p, max_new_tokens=n) for p, n in zip(prompts, (6, 4, 5, 7))]
    res = srv.drain()
    for rid, p, n in zip(ids, prompts, (6, 4, 5, 7)):
        np.testing.assert_array_equal(res[rid].tokens(), teng.generate(p[None], max_new_tokens=n)[0])
    if "kvcache" in serving:
        assert srv.stats()["kvcache"]["prefix_hits"] >= 1


def test_other_bits_quantize_and_dequantize_as_jax():
    params = _gpt_params()
    ids = np.random.default_rng(6).integers(1, 512, (2, 16))
    for bits, groups in ((4, 1), (8, 4)):
        kw = dict(quantize_bits=bits, quantize_groups=groups, max_out_tokens=CAP)
        if bits == 8:  # GPT at 8 bits packs; a BERT model quantizes and dequantizes
            bp = jbert.init_params(jbert.BERT_TINY, seed=2)
            t = deepspeed_tpu_torch.init_inference(model_config=tbert.BERT_TINY, params=bp,
                                                   dtype=torch.float32, device="cpu", **kw)
            j = deepspeed_tpu.init_inference(model_config=jbert.BERT_TINY, params=bp,
                                             dtype=jnp.float32, **kw)
        else:
            t = deepspeed_tpu_torch.init_inference(model_config=tgpt2.GPT2_TINY, params=params,
                                                   dtype=torch.float32, device="cpu", **kw)
            j = deepspeed_tpu.init_inference(model_config=JTINY, params=params,
                                             dtype=jnp.float32, **kw)
        assert all(v.dtype == torch.float32 for v in _flat_t(t.params))
        np.testing.assert_allclose(t.forward(ids).numpy(), np.asarray(j.forward(ids)),
                                   rtol=0, atol=ENGINE_TOL)


def _flat_t(tree):
    return [v for x in tree.values() for v in (_flat_t(x) if isinstance(x, dict) else [x])]
