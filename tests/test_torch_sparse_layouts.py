"""The port's block-sparse layouts and layout prep
(deepspeed_tpu_torch/ops/attention/sparse.py) against the JAX package's
(deepspeed_tpu/ops/attention/sparse.py), on the CPU.

Layouts are numpy on both sides, and the random blocks of Variable and
BigBird come from ``random.Random(0)`` drawn in the same order, so every
array must be equal bit for bit: the layouts of every config class and
option, the row-bucketed gather indices (both ``exempt_uniform_full``
values) and the column-sorted dk/dv edge list.  The constructors refuse
the same arguments with the same errors."""
import numpy as np
import pytest

from deepspeed_tpu.ops.attention import sparse as js
from deepspeed_tpu_torch.ops.attention import sparse as ts

# (name, class name, constructor kwargs, seq_len)
CONFIGS = [
    # tests/test_sparse_attention.py's LAYOUT_CASES
    ("dense", "DenseSparsityConfig", dict(num_heads=4, block=16), 64),
    ("fixed-bi", "FixedSparsityConfig",
     dict(num_heads=4, block=16, num_local_blocks=2, num_global_blocks=1), 64),
    ("fixed-uni", "FixedSparsityConfig",
     dict(num_heads=4, block=16, num_local_blocks=2, attention="unidirectional"), 64),
    ("bigbird", "BigBirdSparsityConfig",
     dict(num_heads=4, block=16, num_random_blocks=1, num_sliding_window_blocks=3,
          num_global_blocks=1), 64),
    ("longformer", "BSLongformerSparsityConfig",
     dict(num_heads=4, block=16, num_sliding_window_blocks=3, global_block_indices=[0, 2]), 64),
    ("variable", "VariableSparsityConfig",
     dict(num_heads=4, block=16, num_random_blocks=1, local_window_blocks=[1, 2],
          global_block_indices=[0]), 64),
    # the options the cases above leave out
    ("bigbird-perhead", "BigBirdSparsityConfig",
     dict(num_heads=4, block=16, num_random_blocks=2, different_layout_per_head=True), 256),
    ("bigbird-uni-default", "BigBirdSparsityConfig",
     dict(num_heads=12, block=256, attention="unidirectional"), 8192),
    ("bigbird-bi-long", "BigBirdSparsityConfig", dict(num_heads=2, block=64), 4096),
    ("fixed-2patterns", "FixedSparsityConfig",
     dict(num_heads=4, block=16, num_local_blocks=4, num_global_blocks=1,
          different_layout_per_head=True, num_different_global_patterns=2), 256),
    ("fixed-horizontal", "FixedSparsityConfig",
     dict(num_heads=2, block=16, num_local_blocks=4, horizontal_global_attention=True), 256),
    ("variable-uni-ends", "VariableSparsityConfig",
     dict(num_heads=3, block=16, num_random_blocks=2, local_window_blocks=[2, 3, 1],
          global_block_indices=[0, 5], global_block_end_indices=[2, 7],
          attention="unidirectional", horizontal_global_attention=True,
          different_layout_per_head=True), 256),
    ("variable-bi", "VariableSparsityConfig",
     dict(num_heads=2, block=32, num_random_blocks=1, global_block_indices=[3],
          horizontal_global_attention=True), 512),
    ("longformer-uni-ends", "BSLongformerSparsityConfig",
     dict(num_heads=2, block=16, num_sliding_window_blocks=5, global_block_indices=[1, 9],
          global_block_end_indices=[3, 10], attention="unidirectional"), 256),
]
IDS = [c[0] for c in CONFIGS]


def _both(cls, kw):
    return getattr(js, cls)(**kw), getattr(ts, cls)(**kw)


@pytest.mark.parametrize("name,cls,kw,T", CONFIGS, ids=IDS)
def test_layouts_equal_the_jax_packages_bit_for_bit(name, cls, kw, T):
    jc, tc = _both(cls, kw)
    a, b = jc.make_layout(T), tc.make_layout(T)
    assert b.dtype == a.dtype == np.uint8 and b.shape == a.shape
    np.testing.assert_array_equal(b, a)
    assert ts._head_uniform(b) == js._head_uniform(a)


@pytest.mark.parametrize("name,cls,kw,T", CONFIGS, ids=IDS)
def test_gather_indices_and_dkv_edges_equal_the_jax_packages(name, cls, kw, T):
    layout = getattr(js, cls)(**kw).make_layout(T)
    for exempt in (False, True):
        want = js._layout_gather_indices(layout, exempt_uniform_full=exempt)
        got = ts._layout_gather_indices(layout, exempt_uniform_full=exempt)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and g.shape == w.shape
            np.testing.assert_array_equal(g, w)
    for g, w in zip(ts._layout_dkv_edges(layout), js._layout_dkv_edges(layout)):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("name,cls,kw,T", CONFIGS, ids=IDS)
def test_kernel_work_items_cover_each_column_run_of_the_edge_list(name, cls, kw, T):
    """B9b reads the edge list through work items derived from it: each
    column's items, in order, must cover exactly its run, first flag to
    last, with at most ``per_item`` valid edges an item."""
    layout = ts._splash_layout(getattr(ts, cls)(**kw).make_layout(T))
    nb = layout.shape[1]
    qidx, kcol, flags = ts._layout_dkv_edges(layout)
    off = ts._column_offsets(kcol, nb)
    assert off.shape == (layout.shape[0], nb + 1) and off.dtype == np.int32
    per_item = 2
    item_col, item_off, col_items = ts._dkv_items(kcol, flags, nb, per_item)
    for h in range(layout.shape[0]):
        assert off[h, 0] == 0 and off[h, nb] == kcol.shape[1]
        for c in range(nb):
            run = slice(off[h, c], off[h, c + 1])
            assert (kcol[h, run] == c).all() and off[h, c + 1] > off[h, c]
            assert flags[h, off[h, c]] & 2  # the run's first edge
            real = flags[h, run] & 1 == 1
            assert sorted(qidx[h, run][real]) == list(np.nonzero(
                layout[h, :, c] & ~ts._dense_row_mask(layout, True)[h])[0])
            items = range(col_items[h, c], col_items[h, c + 1])
            assert len(items) == max(1, -(-int(real.sum()) // per_item))
            assert (item_col[h, list(items)] == c).all()
            assert item_off[h, items[0]] == off[h, c] and item_off[h, items[-1] + 1] == off[h, c + 1]
            for w in items:
                assert (flags[h, item_off[h, w]:item_off[h, w + 1]] & 1).sum() <= per_item
        n = col_items[h, nb]
        assert (item_col[h, n:] == -1).all() and (item_col[h, :n] >= 0).all()


@pytest.mark.parametrize("cls,kw", [
    ("FixedSparsityConfig", dict(num_heads=2, num_local_blocks=3, num_global_blocks=2)),
    ("FixedSparsityConfig", dict(num_heads=2, attention="sideways")),
    ("FixedSparsityConfig", dict(num_heads=2, attention="unidirectional",
                                 horizontal_global_attention=True)),
    ("FixedSparsityConfig", dict(num_heads=2, num_different_global_patterns=2)),
    ("FixedSparsityConfig", dict(num_heads=2, different_layout_per_head=True,
                                 num_local_blocks=4, num_global_blocks=2,
                                 num_different_global_patterns=3)),
    ("VariableSparsityConfig", dict(num_heads=2, global_block_indices=[0, 3],
                                    global_block_end_indices=[1])),
], ids=["local-not-divisible", "attention", "horizontal-uni", "patterns-shared",
        "patterns-too-many", "ends-unpaired"])
def test_constructors_refuse_what_the_jax_package_refuses(cls, kw):
    with pytest.raises(ValueError) as want:
        getattr(js, cls)(**kw)
    with pytest.raises(ValueError) as got:
        getattr(ts, cls)(**kw)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("cls,kw,T", [
    ("DenseSparsityConfig", dict(num_heads=2, block=16), 100),
    ("BigBirdSparsityConfig", dict(num_heads=2, block=16), 32),
], ids=["seq-not-divisible", "bigbird-short"])
def test_make_layout_refuses_what_the_jax_package_refuses(cls, kw, T):
    with pytest.raises(ValueError) as want:
        getattr(js, cls)(**kw).make_layout(T)
    with pytest.raises(ValueError) as got:
        getattr(ts, cls)(**kw).make_layout(T)
    assert str(got.value) == str(want.value)
    with pytest.raises(NotImplementedError):
        ts.SparsityConfig(num_heads=2).make_layout(64)
