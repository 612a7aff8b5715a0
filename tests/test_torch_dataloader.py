"""The port's data loading (deepspeed_tpu_torch.runtime.dataloader) against
the JAX package's (deepspeed_tpu.runtime.dataloader) on the same datasets:
the same batches bit for bit (shuffled across epochs, columnar and
per-example with or without ``collate_fn``), the same resume cursor, and
wrappers whose cursor counts the batches they handed out, not the ones
they pulled ahead."""
import dataclasses

import numpy as np
import pytest
import torch

import deepspeed_tpu_torch
from deepspeed_tpu.runtime import dataloader as jdl
from deepspeed_tpu_torch.models import gpt2
from deepspeed_tpu_torch.runtime import dataloader as tdl
from deepspeed_tpu_torch.runtime.engine import tree_flatten
from deepspeed_tpu_torch.runtime.overlap import DevicePrefetcher

N = 23


def columnar():
    rng = np.random.default_rng(0)
    return {"input_ids": rng.integers(0, 100, (N, 8), dtype=np.int32),
            "labels": rng.integers(0, 2, (N,), dtype=np.int64)}


def examples():
    rng = np.random.default_rng(1)
    return [{"x": rng.standard_normal(3).astype(np.float32), "y": np.int32(i)} for i in range(N)]


def pad_collate(batch):
    return {"x": np.stack([e["x"] * 2 for e in batch]),
            "y": np.array([int(e["y"]) for e in batch])}


def leaves(b):
    return [np.asarray(x) for x in tree_flatten(b)[0]]


def assert_same_batches(got, want):
    got, want = list(got), list(want)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert (sorted(g) if isinstance(g, dict) else None) == \
            (sorted(w) if isinstance(w, dict) else None)
        for a, b in zip(leaves(g), leaves(w)):
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_array_equal(a, b)


CASES = {
    "columnar": (columnar, {}),
    "columnar_tuple": (lambda: tuple(columnar().values()), {}),
    "examples_stacked": (examples, {}),
    "examples_collate": (examples, {"collate_fn": pad_collate}),
}


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("drop_last", [True, False])
def test_batches_equal_the_jax_loaders_across_shuffled_epochs(case, drop_last):
    make, kw = CASES[case]
    opts = dict(batch_size=4, shuffle=True, seed=9, drop_last=drop_last, **kw)
    t = tdl.DeepSpeedDataLoader(make(), **opts)
    j = jdl.DeepSpeedDataLoader(make(), process_index=0, process_count=1, **opts)
    assert len(t) == len(j) == (5 if drop_last else 6)
    for epoch in range(3):
        t.set_epoch(epoch)
        j.set_epoch(epoch)
        assert_same_batches(t, j)
    unshuffled = dict(opts, shuffle=False)
    assert_same_batches(tdl.DeepSpeedDataLoader(make(), **unshuffled),
                        jdl.DeepSpeedDataLoader(make(), process_index=0, process_count=1,
                                                **unshuffled))


@pytest.mark.parametrize("cut", [0, 2, 5])
def test_mid_epoch_cursor_resumes_with_the_jax_loaders_remaining_batches(cut):
    t = tdl.DeepSpeedDataLoader(columnar(), batch_size=4, shuffle=True, seed=3)
    j = jdl.DeepSpeedDataLoader(columnar(), batch_size=4, shuffle=True, seed=3,
                                process_index=0, process_count=1)
    t.set_epoch(1)
    j.set_epoch(1)
    it_t, it_j = iter(t), iter(j)
    for _ in range(cut):
        next(it_t)
        next(it_j)
    sd = t.state_dict()
    assert sd == j.state_dict() == {"epoch": 1, "cursor": cut, "seed": 3}
    fresh_t = tdl.DeepSpeedDataLoader(columnar(), batch_size=4, shuffle=True, seed=0)
    fresh_t.load_state_dict(sd)
    assert_same_batches(fresh_t, it_j)
    assert_same_batches(fresh_t, j)  # the skip applies to one iteration only


def test_unequal_columns_refused():
    with pytest.raises(ValueError, match="unequal"):
        tdl.DeepSpeedDataLoader({"a": np.zeros(3), "b": np.zeros(4)}, batch_size=2)


def test_repeating_loader():
    r = tdl.RepeatingLoader([1, 2, 3])
    assert [next(r) for _ in range(7)] == [1, 2, 3, 1, 2, 3, 1]
    assert len(r) == 3


@pytest.mark.parametrize("wrapper", ["DevicePrefetchLoader", "DevicePrefetcher"])
def test_wrapper_cursor_counts_served_not_pulled_batches(wrapper):
    """Pulled ahead by the prefetch depth, a wrapper's cursor still says
    how many batches training got: a checkpoint after the k-th step
    resumes at batch k, as the JAX package's wrappers do."""
    base = tdl.DeepSpeedDataLoader(columnar(), batch_size=4, shuffle=True, seed=5)
    wrap = (tdl.DevicePrefetchLoader(base, prefetch_depth=3, device="cpu")
            if wrapper == "DevicePrefetchLoader" else DevicePrefetcher(base, depth=3, device="cpu"))
    it = iter(wrap)
    got = [next(it) for _ in range(2)]
    assert base.state_dict()["cursor"] > 2  # the inner loader ran ahead
    sd = wrap.state_dict()
    assert sd == {"epoch": 0, "cursor": 2, "seed": 5}
    jbase = jdl.DeepSpeedDataLoader(columnar(), batch_size=4, shuffle=True, seed=5,
                                    process_index=0, process_count=1)
    want = list(jbase)
    assert_same_batches([{k: v.numpy() for k, v in b.items()} for b in got], want[:2])
    resumed = tdl.DevicePrefetchLoader(tdl.DeepSpeedDataLoader(columnar(), batch_size=4,
                                                               shuffle=True, seed=0),
                                       device="cpu")
    resumed.load_state_dict(sd)
    assert_same_batches([{k: v.numpy() for k, v in b.items()} for b in resumed], want[2:])
    assert all(isinstance(v, torch.Tensor) for b in got for v in b.values())
    if wrapper == "DevicePrefetcher":
        wrap.close()


def test_initialize_returns_the_loader():
    """``initialize(training_data=)`` gives the JAX package's loader: batches
    of ``train_micro_batch_size_per_gpu``, shuffled from the config's seed,
    ``dataloader_drop_last`` from the config."""
    model_fn, init_fn, _ = gpt2.make_model(dataclasses.replace(gpt2.GPT2_TINY, remat=False))
    config = {"train_micro_batch_size_per_gpu": 4, "seed": 11, "dataloader_drop_last": True,
              "optimizer": {"type": "Adam", "params": {"lr": 1e-3}}}
    data = {"input_ids": np.random.default_rng(2).integers(0, 512, (N, 16), dtype=np.int32)}
    engine, _, loader, _ = deepspeed_tpu_torch.initialize(
        model=model_fn, model_parameters=init_fn(seed=0), config=config, training_data=data,
        device="cpu")
    assert isinstance(loader, tdl.DeepSpeedDataLoader)
    assert (loader.batch_size, loader.seed, loader.drop_last, loader.shuffle) == (4, 11, True, True)
    want = jdl.DeepSpeedDataLoader(data, batch_size=4, shuffle=True, seed=11, drop_last=True,
                                   process_index=0, process_count=1)
    assert_same_batches(loader, want)
    losses = [float(engine.train_batch(b)) for b in engine.prefetch_loader(loader)]
    assert len(losses) == N // 4 and engine.global_steps == N // 4
    assert engine._train_loader.state_dict()["cursor"] == N // 4
    assert deepspeed_tpu_torch.initialize(model=model_fn, model_parameters=init_fn(seed=0),
                                          config=config, device="cpu")[2] is None
