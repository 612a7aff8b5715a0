"""ZeRO-Offload and ZeRO-Infinity across ranks in the port against the JAX
package, on the CPU.

* The in-memory offload engine with its masters cut into flat slices:
  ``DS_OFFLOAD_SHARDS=4`` in one process against the JAX engine with the
  same variable (``tests/test_offload.py``'s pattern), and two gloo ranks
  (``tools/zero_worker.py``) against the JAX engine at ``mesh {data: 2}``
  with ``DS_OFFLOAD_SHARDS=2``: losses within ``LOSS_RTOL``, masters within
  ``PARAM_ATOL`` (``tests/test_torch_offload.py``'s f32 bounds).  The
  sliced port against the unsliced port: bit for bit (the host Adam is
  elementwise; the same gradients reach every slice).
* The per-shard checkpoint files (``host_optimizer_shard<i>.pt``), a resume
  (bit for bit), and restores under another slice count, which rebuild the
  masters from the tag's parameters and reset the moments with a warning,
  as the JAX engine does (losses after it within ``LOSS_RTOL`` of the JAX
  engine's doing the same).
* The streaming engine at ``fsdp: 2`` over two gloo ranks against the JAX
  ``ZeroInfinityEngine`` at ``fsdp: 2``: losses within ``LOSS_RTOL``,
  masters within ``PARAM_ATOL``; each rank holds half of every cut block
  leaf; a tag written at two ranks restores at one rank and a one-rank tag
  at two, the masters bit for bit.

f32, dropout off, GPT2_TINY-sized models.
"""
import dataclasses
import json
import os

import jax
import numpy as np
import pytest
import torch

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.comm.mesh import make_mesh
from deepspeed_tpu.config.config import MeshConfig
from deepspeed_tpu.models import gpt2 as jgpt2
from deepspeed_tpu_torch.models import gpt2 as tgpt2
from deepspeed_tpu_torch.runtime.engine import tree_items

from tests.test_torch_zero import _launch

LOSS_RTOL, PARAM_ATOL = 2e-5, 1e-5
T = 64
STREAM_CFG = dict(n_layer=4, vocab_size=256, n_positions=T)


def _config(zero, mesh=None, optimizer="AdamW"):
    c = {"train_micro_batch_size_per_gpu": 2, "gradient_accumulation_steps": 2,
         "gradient_clipping": 1.0,
         "optimizer": {"type": optimizer, "params": {"lr": 1e-3, "weight_decay": 0.01}},
         "scheduler": {"type": "WarmupDecayLR", "params": {
             "total_num_steps": 10, "warmup_num_steps": 2, "warmup_min_lr": 1e-4,
             "warmup_max_lr": 1e-3}},
         "zero_optimization": zero, "steps_per_print": 1000}
    if mesh is not None:
        c["mesh"] = mesh
    return c


def _off(device="cpu", path=None):
    return {"offload_optimizer": {"device": device, **({"nvme_path": path} if path else {})}}


def _stream():
    return {"stage": 3, "offload_param": {"device": "cpu", "buffer_count": 1}}


def _batches(steps, rows, vocab=512, seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(0, vocab, (steps, rows, T), dtype=np.int32)


def _port(config, shards=None, monkeypatch=None, cfg=None):
    torch.use_deterministic_algorithms(True)
    if monkeypatch is not None:
        if shards:
            monkeypatch.setenv("DS_OFFLOAD_SHARDS", str(shards))
        else:
            monkeypatch.delenv("DS_OFFLOAD_SHARDS", raising=False)
    cfg = cfg or dataclasses.replace(tgpt2.GPT2_TINY, n_positions=T)
    model_fn, init_fn, _ = tgpt2.make_model(cfg)
    eng, *_ = deepspeed_tpu_torch.initialize(model=model_fn, model_parameters=init_fn(seed=3),
                                             config=config, device="cpu")
    return eng


def _jax(config, mesh_sizes, shards=None, monkeypatch=None, cfg=None):
    if monkeypatch is not None:
        if shards:
            monkeypatch.setenv("DS_OFFLOAD_SHARDS", str(shards))
        else:
            monkeypatch.delenv("DS_OFFLOAD_SHARDS", raising=False)
    cfg = cfg or dataclasses.replace(jgpt2.GPT2_TINY, n_positions=T)
    model_fn, init_fn, tp_fn = jgpt2.make_model(cfg)
    world = int(np.prod(list(mesh_sizes.values())))
    mesh = make_mesh(MeshConfig(**mesh_sizes), devices=jax.devices()[:world])
    eng, *_ = deepspeed_tpu.initialize(model=model_fn, model_parameters=init_fn(seed=3),
                                       config=config, mesh=mesh, tp_spec_fn=tp_fn)
    return eng


def _jax_masters(eng):
    """The JAX engine's f32 masters by path (offload: its host masters,
    reassembled from the slices)."""
    from deepspeed_tpu.runtime.fp16.onebit.adam import unpack_flat

    if getattr(eng, "_offload_shards", 1) > 1:
        flat = np.concatenate([o.masters[0] for o in eng._host_opts])
        tree = unpack_flat(flat, jax.tree.map(np.asarray, eng.state["params"]))
    elif hasattr(eng, "_host_opt") and hasattr(eng._host_opt, "masters_tree"):
        tree = eng._host_opt.masters_tree()
    else:
        tree = eng.state["params"]
    out = {}

    def walk(t, path):
        if isinstance(t, dict):
            for k in sorted(t):
                walk(t[k], path + (k,))
        else:
            out["/".join(path)] = np.asarray(t, np.float32)

    walk(tree, ())
    return out


def _port_masters(eng):
    return {k: t.detach().float().numpy() for k, t in tree_items(eng.params)}


def _close(got, want, atol=PARAM_ATOL):
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=atol, rtol=0, err_msg=k)


# ---------------------------------------------------------------------------
# the in-memory engine's slices in one process (DS_OFFLOAD_SHARDS)
# ---------------------------------------------------------------------------

def test_sliced_offload_matches_jax_and_the_unsliced_port(monkeypatch):
    ids = _batches(3, 4)
    t4 = _port(_config(_off()), 4, monkeypatch)
    assert t4._offload_shards == 4 and len(t4._host_opts) == 4
    tl4 = [float(t4.train_batch({"input_ids": b})) for b in ids]
    t1 = _port(_config(_off()), None, monkeypatch)
    tl1 = [float(t1.train_batch({"input_ids": b})) for b in ids]
    assert tl1 == tl4
    j4 = _jax(_config(_off()), {"data": 1}, 4, monkeypatch)
    assert j4._offload_shards == 4
    jl4 = [float(j4.train_batch({"input_ids": b})) for b in ids]
    np.testing.assert_allclose(tl4, jl4, rtol=LOSS_RTOL)
    _close(_port_masters(t4), _jax_masters(j4))
    for a, b in zip(tree_items(t1.params), tree_items(t4.params)):
        assert torch.equal(a[1], b[1]), a[0]
    # each slice owns a quarter of the padded masters (and of the moments)
    n = sum(m.numel() for m in t1._host_opt.masters)
    assert t4.host_master_bytes() == 4 * (n + (-n) % 4)
    assert all(o.masters[0].numel() == (n + (-n) % 4) // 4 for o in t4._host_opts)


def _warnings(monkeypatch):
    from deepspeed_tpu_torch.runtime import checkpointing

    seen = []
    monkeypatch.setattr(checkpointing.logger, "warning", lambda msg, *a, **k: seen.append(msg))
    return seen


def test_sliced_offload_checkpoint_files_and_restore_under_another_count(monkeypatch, tmp_path):
    ids = _batches(5, 4, seed=1)
    ck = str(tmp_path / "ck")
    t4 = _port(_config(_off()), 4, monkeypatch)
    for b in ids[:2]:
        t4.train_batch({"input_ids": b})
    t4.save_checkpoint(ck, tag="s4")
    files = sorted(os.listdir(os.path.join(ck, "s4", "state")))
    assert files == [f"host_optimizer_shard{i}.pt" for i in range(4)] + ["state.pt"]
    with open(os.path.join(ck, "s4", "meta.json")) as f:
        assert json.load(f)["offload_shards"] == 4
    ref = [float(t4.train_batch({"input_ids": b})) for b in ids[2:]]
    # the same slice layout: a resume, bit for bit
    r4 = _port(_config(_off()), 4, monkeypatch)
    r4.load_checkpoint(ck, tag="s4")
    assert [float(r4.train_batch({"input_ids": b})) for b in ids[2:]] == ref
    # the JAX engine through the same save and restores
    jck = str(tmp_path / "jck")
    j4 = _jax(_config(_off()), {"data": 1}, 4, monkeypatch)
    for b in ids[:2]:
        j4.train_batch({"input_ids": b})
    j4.save_checkpoint(jck, tag="s4")
    seen = _warnings(monkeypatch)
    runs = {}
    for shards in (2, None):
        seen.clear()
        t = _port(_config(_off()), shards, monkeypatch)
        t.load_checkpoint(ck, tag="s4")
        assert any("RESET" in m for m in seen), seen
        runs[shards] = [float(t.train_batch({"input_ids": b})) for b in ids[2:]]
    # two slices and one take the same rebuilt masters and reset moments
    assert runs[2] == runs[None]
    # the JAX engine at one slice (its files of another count are named
    # alike and refused by shape, so only the one-slice restore rebuilds)
    j = _jax(_config(_off()), {"data": 1}, None, monkeypatch)
    j.load_checkpoint(jck, tag="s4")
    jl = [float(j.train_batch({"input_ids": b})) for b in ids[2:]]
    np.testing.assert_allclose(runs[None], jl, rtol=LOSS_RTOL)
    _close(_port_masters(t), _jax_masters(j))


# ---------------------------------------------------------------------------
# two gloo ranks: one spawn for every case
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("offload_ranks")
    ids = _batches(4, 2 * 2 * 2)  # gas 2 x micro 2 x 2 ranks
    np.savez(tmp / "b.npz", input_ids=ids)
    sids = _batches(4, 2 * 2 * 2, vocab=256, seed=4)
    np.savez(tmp / "s.npz", input_ids=sids)
    ck = str(tmp / "ck")
    # a one-rank stream tag for the two ranks to load (1 -> 2)
    one = _port(_config(_stream()), cfg=dataclasses.replace(tgpt2.GPT2_TINY, **STREAM_CFG))
    for s in range(2):
        one.train_batch({"input_ids": sids[s][:4]})
    one.save_checkpoint(ck, tag="inf1")
    one_masters = _port_masters(one)

    def case(name, zero, mesh, batches="b.npz", steps=3, model_cfg=None, **kw):
        return {"name": name, "preset": "tiny",
                "model_cfg": model_cfg or {"n_positions": T}, "init_seed": 3,
                "config": _config(zero, mesh), "batches": str(tmp / batches), "steps": steps,
                **kw}

    stream_cfg = dict(STREAM_CFG)
    cases = [
        case("off", _off(), {"data": 2}, save={"dir": ck, "tag": "off", "after": 2}),
        case("off_nvme", _off("nvme", str(tmp / "nvme")), {"data": 2}, record="digest"),
        case("off_resume", _off(), {"data": 2}, load={"dir": ck, "tag": "off"}, first_batch=2,
             steps=1),
        case("inf", _stream(), {"fsdp": 2}, batches="s.npz", model_cfg=stream_cfg,
             save={"dir": ck, "tag": "inf2", "after": 2}),
        case("inf_tag", _stream(), {"fsdp": 2}, batches="s.npz", model_cfg=stream_cfg,
             load={"dir": ck, "tag": "inf2"}, steps=0),
        case("inf_resume", _stream(), {"fsdp": 2}, batches="s.npz", model_cfg=stream_cfg,
             load={"dir": ck, "tag": "inf2"}, first_batch=2, steps=1),
        case("inf_from_one", _stream(), {"fsdp": 2}, batches="s.npz", model_cfg=stream_cfg,
             load={"dir": ck, "tag": "inf1"}, steps=0),
    ]
    _launch(2, cases, tmp)
    return {"tmp": tmp, "ids": ids, "sids": sids, "ck": ck, "one_masters": one_masters}


def _read(ranks, name):
    with open(ranks["tmp"] / f"{name}.json") as f:
        meta = json.load(f)
    state = None
    if os.path.exists(ranks["tmp"] / f"{name}.npz"):
        with np.load(ranks["tmp"] / f"{name}.npz") as z:
            state = {k: z[k] for k in z.files}
    return meta, state


def _params_of(state):
    return {k[len("params/"):]: v for k, v in state.items() if k.startswith("params/")}


def test_offload_at_data_2_matches_jax(ranks, monkeypatch):
    meta, state = _read(ranks, "off")
    assert meta["backend"] == "gloo" and meta["world_size"] == 2
    j = _jax(_config(_off()), {"data": 2}, 2, monkeypatch)
    assert j._offload_shards == 2
    jl = [float(j.train_batch({"input_ids": b})) for b in ranks["ids"][:3]]
    np.testing.assert_allclose(meta["losses"], jl, rtol=LOSS_RTOL)
    _close(_params_of(state), _jax_masters(j))
    # each rank steps half of the padded masters
    n = sum(int(np.prod(v.shape)) for v in _params_of(state).values())
    assert [h["masters"] for h in meta["host_bytes_by_rank"]] == [2 * (n + n % 2)] * 2
    # the masters gather rides a gloo all-gather of the f32 slices
    assert all(c["offload-masters-allgather"] == 4 * (n + n % 2) for c in meta["comm"])
    assert meta["table"]["offload-masters-allgather"][0] == "dense"


def test_offload_nvme_at_data_2_is_the_cpu_run(ranks):
    meta, _ = _read(ranks, "off")
    nvme, _ = _read(ranks, "off_nvme")
    assert nvme["losses"] == meta["losses"]
    _, state = _read(ranks, "off")
    import hashlib

    for k, v in state.items():
        if k.startswith("params/"):
            t = torch.from_numpy(np.ascontiguousarray(v)).reshape(-1)
            assert hashlib.sha256(t.view(torch.uint8).numpy().tobytes()).hexdigest() == \
                nvme["digests"][k], k


def test_offload_resume_at_data_2_and_the_tag_in_one_process(ranks, monkeypatch):
    meta, state = _read(ranks, "off")
    res, rstate = _read(ranks, "off_resume")
    assert res["losses"] == meta["losses"][2:3]
    for k, v in state.items():
        np.testing.assert_array_equal(rstate[k], v, err_msg=k)
    files = sorted(os.listdir(os.path.join(ranks["ck"], "off", "state")))
    assert files == ["host_optimizer_shard0.pt", "host_optimizer_shard1.pt", "state.pt"]
    # in one process under another slice layout: masters from the tag's
    # parameters, moments reset (the JAX warning)
    seen = _warnings(monkeypatch)
    for shards in (None, 4):
        seen.clear()
        t = _port(_config(_off()), shards, monkeypatch)
        t.load_checkpoint(ranks["ck"], tag="off")
        assert any("RESET" in m for m in seen), seen
        assert t.global_steps == 2


def _jax_stream(ranks, monkeypatch):
    cfg = dataclasses.replace(jgpt2.GPT2_TINY, use_flash_attention=False, **STREAM_CFG)
    j = _jax(_config(_stream(), {"fsdp": 2}), {"fsdp": 2}, None, monkeypatch, cfg=cfg)
    assert type(j).__name__ == "ZeroInfinityEngine"
    return j


def test_stream_at_fsdp_2_matches_jax(ranks, monkeypatch):
    meta, state = _read(ranks, "inf")
    j = _jax_stream(ranks, monkeypatch)
    jl = [float(j.train_batch({"input_ids": b})) for b in ranks["sids"][:3]]
    np.testing.assert_allclose(meta["losses"], jl, rtol=LOSS_RTOL)
    _close(_params_of(state), _jax_masters(j))
    # each rank holds half of every cut block leaf's masters
    one = _port(_config(_stream()), cfg=dataclasses.replace(tgpt2.GPT2_TINY, **STREAM_CFG))
    whole = sum(one._host_opt.masters[i].numel() * 4 for i in one._block_idx)
    assert [h["block_masters"] for h in meta["host_bytes_by_rank"]] == [whole // 2] * 2
    assert meta["comm"][0]["group-all-gather"] > 0 and meta["comm"][0]["group-grad-reduce"] > 0


def test_stream_resharding_restore_both_ways(ranks):
    # 2 -> 2: a resume
    meta, _ = _read(ranks, "inf")
    res, _ = _read(ranks, "inf_resume")
    assert res["losses"] == meta["losses"][2:3]
    files = sorted(os.listdir(os.path.join(ranks["ck"], "inf2", "state")))
    assert files == ["host_optimizer_rank0.pt", "host_optimizer_rank1.pt", "state.pt"]
    with open(os.path.join(ranks["ck"], "inf2", "meta.json")) as f:
        m = json.load(f)
    assert m["masters_sharded"] and m["process_count"] == 2 and m["fsdp"] == 2
    # 2 -> 1: one process reassembles the two ranks' files
    _, tag = _read(ranks, "inf_tag")
    one = _port(_config(_stream()), cfg=dataclasses.replace(tgpt2.GPT2_TINY, **STREAM_CFG))
    one.load_checkpoint(ranks["ck"], tag="inf2")
    got = _port_masters(one)
    for k, v in _params_of(tag).items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)
    assert one.global_steps == 2
    assert np.isfinite(float(one.train_batch({"input_ids": ranks["sids"][2][:4]})))
    # 1 -> 2: the one-rank tag cut into the two ranks' parts
    _, from_one = _read(ranks, "inf_from_one")
    for k, v in _params_of(from_one).items():
        np.testing.assert_array_equal(v, ranks["one_masters"][k], err_msg=k)
