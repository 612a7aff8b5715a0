"""The port's ZeRO rules, spec algebra, mesh shapes, topology, comm models,
memory estimators and config parsing against the JAX package's, on the
same inputs, in-process (``deepspeed_tpu_torch/runtime/zero/stages.py``,
``sharding/``, ``comm/topology.py``, ``comm/strategy.py``,
``runtime/zero/api.py`` and ``utils.py``, ``config/config.py``).
Specs compare as full-length tuples of per-dimension entries."""
import dataclasses
import itertools

import numpy as np
import pytest

from deepspeed_tpu.comm import strategy as jstrategy
from deepspeed_tpu.comm import topology as jtopo
from deepspeed_tpu.config import config as jconfig
from deepspeed_tpu.models import bert as jbert
from deepspeed_tpu.models import gpt2 as jgpt2
from deepspeed_tpu.runtime.zero import api as japi
from deepspeed_tpu.runtime.zero import stages as jstages
from deepspeed_tpu.runtime.zero import utils as jutils
from deepspeed_tpu.sharding import mesh as jmesh
from deepspeed_tpu.sharding import rules as jrules
from deepspeed_tpu.sharding import update as jupdate
from deepspeed_tpu.sharding.layout import DEFAULT_LAYOUT as JLAYOUT
from deepspeed_tpu_torch.comm import strategy as tstrategy
from deepspeed_tpu_torch.comm import topology as ttopo
from deepspeed_tpu_torch.config import config as tconfig
from deepspeed_tpu_torch.runtime.engine import tree_flatten, tree_paths
from deepspeed_tpu_torch.runtime.zero import api as tapi
from deepspeed_tpu_torch.runtime.zero import stages as tstages
from deepspeed_tpu_torch.runtime.zero import utils as tutils
from deepspeed_tpu_torch.sharding import mesh as tmesh
from deepspeed_tpu_torch.sharding import rules as trules
from deepspeed_tpu_torch.sharding import update as tupdate
from deepspeed_tpu_torch.sharding.layout import DEFAULT_LAYOUT as TLAYOUT
from deepspeed_tpu_torch.sharding.spec import PartitionSpec


def _t(spec, nd):
    """A spec as a full-length tuple of entries (tuples for multi-axis)."""
    out = tuple(spec) if spec is not None else ()
    out = out + (None,) * (nd - len(out))
    return tuple(tuple(e) if isinstance(e, (list, tuple)) else e for e in out)


def _flat_tree():
    """``tests/test_zero_flat.py``'s prime shapes: nothing divides by 2."""
    r = np.random.default_rng(0)
    return {"w1": r.standard_normal((131, 257)).astype(np.float32),
            "b1": np.zeros((257,), np.float32),
            "w2": r.standard_normal((257, 127)).astype(np.float32),
            "b2": np.zeros((127,), np.float32)}


TREES = {
    "gpt2": (lambda: jgpt2.init_params(jgpt2.GPT2_TINY, seed=0), "gpt2"),
    "bert": (lambda: jbert.init_params(jbert.BERT_TINY, seed=0), "bert"),
    "flat": (_flat_tree, None),
}


def _leaves(tree):
    leaves, _ = tree_flatten(tree)
    return list(zip(tree_paths(tree), [tuple(np.shape(x)) for x in leaves]))


@pytest.mark.parametrize("tp", [False, True], ids=["no_tp", "family_rules"])
@pytest.mark.parametrize("stage", [0, 1, 2, 3])
@pytest.mark.parametrize("tree", list(TREES))
def test_sharding_rules_match_jax(tree, stage, tp):
    """param/grad/opt specs and ``plan_flat`` over fsdp 1/2/4/8, data 1/2,
    ``reduce_scatter`` on and off, cross-replica on and off and three
    persistence thresholds."""
    make, family = TREES[tree]
    params = make()
    leaves = _leaves(params)
    use_tp = tp and family is not None
    for fsdp, data, rs, cross, thr in itertools.product(
            (1, 2, 4, 8), (1, 2), (True, False), (True, False), (0, 64, 100_000)):
        kw = dict(stage=stage, reduce_scatter=rs, cross_replica_weight_update=cross,
                  param_persistence_threshold=thr)
        jr = jstages.ZeroShardingRules(
            jconfig.ZeroConfig(**kw), fsdp, data_size=data,
            tp_spec_fn=jrules.rules_for_family(family).tp_spec_fn() if use_tp else None)
        tr = tstages.ZeroShardingRules(
            tconfig.ZeroConfig(**kw), fsdp, data_size=data,
            tp_spec_fn=trules.rules_for_family(family).tp_spec_fn() if use_tp else None)
        assert jr.plan_flat(params) == tr.plan_flat(params)
        assert jr.cross_replica_active == tr.cross_replica_active
        for path, shape in leaves:
            for fn in ("param_spec", "grad_spec", "opt_spec"):
                want = _t(getattr(jr, fn)(path, shape), len(shape))
                got = _t(getattr(tr, fn)(path, shape), len(shape))
                assert got == want, (fn, path, shape, fsdp, data, kw)
                assert isinstance(getattr(tr, fn)(path, shape), PartitionSpec)


SHAPES = [(), (7,), (8,), (16, 3), (3, 16), (12, 8), (2, 64, 192), (24, 1024, 4096),
          (131, 257), (6, 10, 15)]
BASES = [None, ("model",), (None, "model"), (None, None, "model"), ("pipe", None)]


@pytest.mark.parametrize("size", [1, 2, 3, 4, 8])
def test_add_mesh_axis_and_add_update_axis_match_jax(size):
    from jax.sharding import PartitionSpec as P

    for shape, base, min_size in itertools.product(SHAPES, BASES, (0, 100, 10_000)):
        if base is not None and len(base) > len(shape):
            continue
        jb = None if base is None else P(*base)
        tb = None if base is None else PartitionSpec(*base)
        want = jupdate.add_mesh_axis(shape, jb, "fsdp", size, min_size=min_size)
        got = tupdate.add_mesh_axis(shape, tb, "fsdp", size, min_size=min_size)
        assert _t(got, len(shape)) == _t(want, len(shape)), (shape, base, min_size)
        for data in (1, 2, 3):
            w2 = jupdate.add_update_axis(shape, want, "data", data, fsdp_size=size)
            g2 = tupdate.add_update_axis(shape, got, "data", data, fsdp_size=size)
            assert _t(g2, len(shape)) == _t(w2, len(shape)), (shape, base, data)
        assert tupdate.spec_tuple(tb, len(shape)) == tuple(jupdate.spec_tuple(jb, len(shape)))
        if len(shape) >= 1:
            assert (_t(TLAYOUT.fsdp_trailing(shape, size), len(shape))
                    == _t(JLAYOUT.fsdp_trailing(shape, size), len(shape)))
    for n, dp, sharded in itertools.product((1, 1000, 124_439_808), (1, 2, 8), (True, False)):
        assert (tupdate.weight_update_model(n, dp * size, sharded)
                == jupdate.weight_update_model(n, dp * size, sharded))


MESH_CASES = [dict(), dict(data=2), dict(data=-1, fsdp=2), dict(fsdp=4), dict(data=2, fsdp=2),
              dict(data=-1, fsdp=-1), dict(data=3), dict(fsdp=0), dict(data=-1, fsdp=3),
              dict(data=2, fsdp=4, model=1)]


@pytest.mark.parametrize("n", [1, 2, 4, 8])
def test_resolve_mesh_shape_matches_jax(n):
    for kw in MESH_CASES:
        def run(mod, cfg_cls):
            try:
                return mod.resolve_mesh_shape(cfg_cls(**kw), n)
            except ValueError as e:
                return ("error", type(e))
        assert run(tmesh, tconfig.MeshConfig) == run(jmesh, jconfig.MeshConfig), kw
    sizes = {"pipe": 1, "data": n, "fsdp": 1, "seq": 1, "model": 1, "expert": 1}
    from deepspeed_tpu.comm.mesh import MeshInfo as JInfo
    from deepspeed_tpu_torch.comm.mesh import MeshInfo as TInfo

    for info_sizes in (sizes, {**sizes, "data": 1, "fsdp": n}, {**sizes, "fsdp": 2}):
        t_info, j_info = TInfo(info_sizes), JInfo(info_sizes)
        for prop in ("dp_world_size", "fsdp_world_size", "model_parallel_world_size",
                     "pipe_parallel_world_size", "seq_parallel_world_size",
                     "expert_parallel_world_size", "world_size"):
            assert getattr(t_info, prop) == getattr(j_info, prop), prop
    for granules in (1, 2, 3, 4):
        assert tmesh.split_dcn_ici(sizes, granules) == jmesh.split_dcn_ici(sizes, granules)
    t, j = tmesh.MeshTopology.single_slice(sizes), jmesh.MeshTopology.single_slice(sizes)
    assert (t.num_slices, t.slice_devices, t.describe(), t.link("data"), t.dcn_ranks(("data",))) \
        == (j.num_slices, j.slice_devices, j.describe(), j.link("data"), j.dcn_ranks(("data",)))


TOPOLOGIES = [
    lambda m: m.ProcessTopology(axes=["pipe", "data"], dims=[2, 3]),
    lambda m: m.ProcessTopology(axes=["a", "b", "c"], dims=[2, 1, 2]),
    lambda m: m.PipeModelDataParallelTopology(num_pp=2, num_mp=2, num_dp=2),
    lambda m: m.PipeDataParallelTopology(num_pp=2, num_dp=4),
    lambda m: m.PipeModelDataParallelTopology(num_pp=2, num_mp=2, num_dp=1),
]


@pytest.mark.parametrize("k", range(len(TOPOLOGIES)))
def test_process_topology_matches_jax(k):
    """``tests/test_topology.py``'s grids: coordinates, comm lists,
    filters, reprs and the refusals, equal to the JAX package's."""
    t, j = TOPOLOGIES[k](ttopo), TOPOLOGIES[k](jtopo)
    assert (t.world_size, t.get_axis_names(), str(t)) == (j.world_size, j.get_axis_names(), str(j))
    for r in range(t.world_size):
        assert tuple(t.get_coord(r)) == tuple(j.get_coord(r))
        assert t.get_rank(**t.get_coord(r)._asdict()) == r
        assert t.get_rank_repr(r) == j.get_rank_repr(r)
        assert t.get_rank_repr(r, omit_axes=()) == j.get_rank_repr(r, omit_axes=())
    for axis in t.get_axis_names() + ["expert", "bogus"]:
        assert t.get_axis_comm_lists(axis) == j.get_axis_comm_lists(axis)
        assert t.get_dim(axis) == j.get_dim(axis)
    first = t.get_axis_names()[0]
    assert t.filter_match(**{first: 0}) == j.filter_match(**{first: 0})
    assert t.get_axis_list(first, 1) == j.get_axis_list(first, 1)
    for mod in (ttopo, jtopo):
        with pytest.raises(ValueError):
            mod.ProcessTopology(axes=["a"], dims=[2, 3])
        topo = mod.ProcessTopology(axes=["a", "b"], dims=[2, 2])
        with pytest.raises(ValueError):
            topo.get_rank(a=0)
        with pytest.raises(ValueError):
            topo.get_rank(a=5, b=0)


@pytest.mark.parametrize("stage", [0, 1, 2, 3])
def test_comm_models_match_jax(stage):
    """``zero_step_comm_model`` and ``step_comm_bytes`` (dense, int8,
    onebit, with and without a topology) over a grid."""
    for n, fsdp, data, gas, rs, pb in itertools.product(
            (1000, 124_439_808), (1, 2, 4, 8), (1, 2, 4), (1, 2, 4), (True, False), (2, 4)):
        assert (tstages.zero_step_comm_model(n, fsdp, stage, gas=gas, param_bytes=pb,
                                             reduce_scatter=rs)
                == jstages.zero_step_comm_model(n, fsdp, stage, gas=gas, param_bytes=pb,
                                                reduce_scatter=rs))
        sizes = {"pipe": 1, "data": data, "fsdp": fsdp, "seq": 1, "model": 1, "expert": 1}
        for strat, topo in itertools.product(("dense", "int8", "onebit"), (False, True)):
            tt = tmesh.MeshTopology.single_slice(sizes) if topo else None
            jt = jmesh.MeshTopology.single_slice(sizes) if topo else None
            assert (tstrategy.step_comm_bytes(n, sizes, stage, gas=gas, strategy=strat,
                                              param_bytes=pb, reduce_scatter=rs, topology=tt)
                    == jstrategy.step_comm_bytes(n, sizes, stage, gas=gas, strategy=strat,
                                                 param_bytes=pb, reduce_scatter=rs, topology=jt))
        split = jmesh.MeshTopology(sizes=sizes, dcn={**{a: 1 for a in sizes}, "data": data},
                                   ici={**sizes, "data": 1})
        tsplit = tmesh.MeshTopology(sizes=sizes, dcn=dict(split.dcn), ici=dict(split.ici))
        assert (tstrategy.step_comm_bytes(n, sizes, stage, gas=gas, topology=tsplit)
                == jstrategy.step_comm_bytes(n, sizes, stage, gas=gas, topology=split))


def test_strategy_policy_matches_jax():
    import jax.numpy as jnp
    import torch

    dtypes = [(torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16),
              (torch.int32, jnp.int32), (torch.bool, jnp.bool_)]
    for strat, nbytes, ranks, link, (td, jd) in itertools.product(
            ("auto", "dense", "int8", "onebit"), (0, 4096, 65536, 10**8), (1, 2, 8),
            ("ici", "dcn", "ici+dcn"), dtypes):
        tc = tconfig.CommConfig(strategy=strat)
        jc = jconfig.CommConfig(strategy=strat)
        t = tstrategy.select_strategy(tc, nbytes, td, ranks, link=link)
        j = jstrategy.select_strategy(jc, nbytes, jd, ranks, link=link)
        assert (t.strategy, t.reason) == (j.strategy, j.reason)
    for s, g in itertools.product(("dense", "int8", "onebit"), (2, 4)):
        assert (tstrategy.strategy_wire_bytes_per_param(s, g)
                == jstrategy.strategy_wire_bytes_per_param(s, g))


@pytest.mark.parametrize("n", [10**6, 124_439_808, 1_557_611_200])
def test_memory_estimators_match_jax(n):
    for gpus, nodes, off in itertools.product((1, 4, 8), (1, 2), (True, False)):
        assert (tapi.estimate_zero2_model_states_mem_needs(n, gpus, nodes, cpu_offload=off)
                == japi.estimate_zero2_model_states_mem_needs(n, gpus, nodes, cpu_offload=off))
        assert (tutils.estimate_zero2_model_states_mem_needs(n, gpus, nodes, cpu_offload=off)
                == jutils.estimate_zero2_model_states_mem_needs(n, gpus, nodes, cpu_offload=off))
        for off_p, init in itertools.product((True, False), (True, False)):
            kw = dict(largest_layer_params=n // 50, num_gpus_per_node=gpus, num_nodes=nodes,
                      cpu_offload=off, cpu_offload_params=off_p, zero_init=init)
            assert (tapi.estimate_zero3_model_states_mem_needs(n, **kw)
                    == japi.estimate_zero3_model_states_mem_needs(n, **kw))
            assert (tutils.estimate_zero3_model_states_mem_needs(n, **kw)
                    == jutils.estimate_zero3_model_states_mem_needs(n, **kw))
    tree = jgpt2.init_params(jgpt2.GPT2_TINY, seed=0)
    assert tutils._count(tree) == jutils._count(tree)


ZERO_BLOCKS = [
    None, {}, {"stage": 2}, {"stage": 3, "reduce_scatter": False},
    {"stage": 1, "reduce_bucket_size": 1000, "allgather_bucket_size": 7, "overlap_comm": False},
    {"stage": 3, "stage3_param_persistence_threshold": 0, "stage3_max_live_parameters": 9},
    {"stage": 3, "param_persistence_threshold": 10, "prefetch_bucket_size": 3},
    {"stage": 2, "cross_replica_weight_update": False, "contiguous_gradients": False},
    {"stage": 1, "elastic_checkpoint": False, "load_from_fp32_weights": False,
     "stage3_gather_fp16_weights_on_model_save": True, "round_robin_gradients": True},
]
FIELDS = [f.name for f in dataclasses.fields(tconfig.ZeroConfig)]


@pytest.mark.parametrize("k", range(len(ZERO_BLOCKS)))
def test_zero_and_mesh_blocks_parse_as_in_jax(k):
    d = ZERO_BLOCKS[k]
    t, j = tconfig.ZeroConfig.from_dict(d), jconfig.ZeroConfig.from_dict(d)
    plain = lambda v: dataclasses.asdict(v) if dataclasses.is_dataclass(v) else v  # noqa: E731
    assert ({f: plain(getattr(t, f)) for f in FIELDS}
            == {f: plain(getattr(j, f)) for f in FIELDS})
    mesh = [None, {}, {"data": 2}, {"fsdp": 4}, {"data": -1, "fsdp": 2}][k % 5]
    tm, jm = tconfig.MeshConfig.from_dict(mesh), jconfig.MeshConfig.from_dict(mesh)
    assert dataclasses.asdict(tm) == dataclasses.asdict(jm)
    comm = [None, {"strategy": "dense"}, {"strategy": "AUTO", "threshold_bytes": 5}][k % 3]
    tc, jc = tconfig.CommConfig.from_dict(comm), jconfig.CommConfig.from_dict(comm)
    assert dataclasses.asdict(tc) == dataclasses.asdict(jc)


@pytest.mark.parametrize("d,exc,match", [
    ({"zero_optimization": {"stage": 4}}, "error", None),
    ({"zero_optimization": {"stage": 1, "bucket": 5}}, "error", None),
    ({"zero_optimization": {"param_persistence_threshold": 1,
                            "stage3_param_persistence_threshold": 2}}, "error", None),
    ({"zero_optimization": {"stage": 2, "cpu_offload": True}}, "offload", "pipe axis"),
    ({"zero_optimization": {"offload_optimizer": {"device": "cpu"}}}, "offload",
     "pipe axis"),
    ({"mesh": {"model": 2}}, "parse", None),
    ({"mesh": {"seq": 2}}, "parse", None),
    ({"mesh": {"pipe": 2}}, "parse", None),
    ({"mesh": {"expert": 2}}, "parse", None),
    ({"mesh": {"dat": 2}}, "error", None),
    ({"comm": {"strategy": "fast"}}, "error", None),
    ({"comm": {"quantize_bits": 4}}, "error", None),
], ids=["stage4", "unknown", "alias_twice", "cpu_offload", "offload", "model", "seq", "pipe",
        "expert", "mesh_typo", "strategy", "bits"])
def test_config_refusals(d, exc, match):
    """Invalid blocks raise in both packages; blocks the JAX package takes
    but the port does not honour yet raise NotImplementedError naming their
    ROADMAP item.  A ``model``, ``seq``, ``pipe`` or ``expert`` axis
    parses in both, alike (each runs since it was ported); so do the
    offload blocks (``cpu_offload`` as ``offload_optimizer: {device:
    cpu}``), which the engine runs across the data-parallel grid and under
    a model, seq or expert axis, and refuses under a pipe axis only (the
    pipeline engine refuses offload, as the JAX package's does)."""
    d = {"train_batch_size": 8, **d}
    if exc == "offload":
        from deepspeed_tpu_torch.comm.mesh import Mesh
        from deepspeed_tpu_torch.runtime.engine import DeepSpeedEngine

        t, j = tconfig.DeepSpeedConfig(d), jconfig.DeepSpeedConfig(d, world_size=1)
        assert (dataclasses.asdict(t.zero_config.offload_optimizer)
                == dataclasses.asdict(j.zero_config.offload_optimizer))
        assert t.zero_config.offload_optimizer.device == "cpu"
        assert t.zero_config.cpu_offload == j.zero_config.cpu_offload
        model = lambda p, b, g: p["w"].sum()  # noqa: E731
        params = {"w": np.ones(4, np.float32)}
        one = DeepSpeedEngine(model=model, params=params, config=t, device="cpu")  # one rank: runs
        assert one._host_opt is not None and one._offload_shards == 1
        with pytest.raises(NotImplementedError, match=match):
            DeepSpeedEngine(model=model, params=params, config=t, device="cpu",
                            mesh=Mesh({"pipe": 2}))
        return
    if exc == "parse":
        j = jconfig.DeepSpeedConfig(d, world_size=1).mesh
        t = tconfig.DeepSpeedConfig(d).mesh
        assert dataclasses.asdict(t) == dataclasses.asdict(j)
        return
    if exc == "error":
        with pytest.raises(jconfig.DeepSpeedConfigError):
            jconfig.DeepSpeedConfig(d, world_size=1)
        with pytest.raises(tconfig.DeepSpeedConfigError):
            tconfig.DeepSpeedConfig(d)
        return
    jconfig.DeepSpeedConfig(d, world_size=1)
    with pytest.raises(NotImplementedError, match=match):
        tconfig.DeepSpeedConfig(d)


def test_world_size_counts_the_data_parallel_grid():
    d = {"train_micro_batch_size_per_gpu": 2, "gradient_accumulation_steps": 3,
         "mesh": {"data": 2, "fsdp": 2}}
    t, j = tconfig.DeepSpeedConfig(d, world_size=4), jconfig.DeepSpeedConfig(d, world_size=4)
    assert (t.train_batch_size, t.world_size) == (j.train_batch_size, 4) == (24, 4)
    # without a process group the mesh covers one rank: the engine refuses
    # it; the triad counts one
    assert tconfig.DeepSpeedConfig(d).train_batch_size == 6


@pytest.mark.parametrize("sizes", [{"data": 2, "fsdp": 2}, {"data": 1, "fsdp": 4},
                                   {"data": 4, "fsdp": 1}, {"data": 2, "fsdp": 4}],
                         ids=["d2f2", "f4", "d4", "d2f4"])
def test_rank_blocks_match_jax_named_sharding(sizes):
    """Rank ``r``'s block of a leaf under a spec (``comm/mesh.py``
    ``Mesh.region``, fsdp-major for ``("fsdp", "data")``) is the block
    JAX places on device ``r`` of the same mesh; ``Init.shard`` cuts it."""
    import jax
    from jax.sharding import NamedSharding
    from jax.sharding import PartitionSpec as P

    from deepspeed_tpu.comm.mesh import make_mesh as jmake_mesh
    from deepspeed_tpu_torch.comm.mesh import Mesh

    world = sizes["data"] * sizes["fsdp"]
    jm = jmake_mesh(jconfig.MeshConfig(**sizes), devices=jax.devices()[:world])
    shape = (8, 16, 24)
    specs = [(), (None, "fsdp"), ("data", None, "fsdp"), (None, ("fsdp", "data")),
             (("data", "fsdp"),), (None, None, ("fsdp", "data"))]
    for spec in specs:
        want = NamedSharding(jm, P(*spec)).devices_indices_map(shape)
        for r, d in enumerate(jm.devices.flat):
            got = Mesh(sizes, rank=r).region(shape, spec)
            norm = tuple(slice(s.start or 0, s.stop if s.stop is not None else n)
                         for s, n in zip(want[d], shape))
            assert got == norm, (spec, r)
    params = jgpt2.init_params(jgpt2.GPT2_TINY, seed=0)
    cfg = tconfig.ZeroConfig(stage=3, param_persistence_threshold=0)
    rules = tstages.ZeroShardingRules(cfg, sizes["fsdp"])
    shards = [tapi.Init(mesh=Mesh(sizes, rank=r), config=cfg).shard(params) for r in range(world)]
    for path, shape in _leaves(params):
        spec = tstages._spec_tuple(rules.param_spec(path, shape), len(shape))
        leaf = np.asarray(tree_flatten(params)[0][tree_paths(params).index(path)])
        for r in range(world):
            block = tree_flatten(shards[r])[0][tree_paths(params).index(path)]
            np.testing.assert_array_equal(block.numpy(), leaf[Mesh(sizes, rank=r).region(shape, spec)])
    with tapi.GatheredParameters(shards[0]) as whole:
        assert all(isinstance(x, np.ndarray) for x in tree_flatten(whole)[0])


@pytest.mark.parametrize("strategy", ["int8", "onebit", "auto"])
def test_a_compressed_exchange_raises_naming_a13(strategy, monkeypatch):
    """Across ranks the comm layer records its decision as the JAX one
    does, and a compressed pick now runs (``exchange_rows``), under ZeRO
    stage 3 and ``model`` / ``seq`` axes too; what still raises naming A13
    is a compressed exchange under an ``expert`` (or ``pipe``) axis, which
    the JAX package composes under GSPMD.  Dense and one rank stay
    dense."""
    import jax.numpy as jnp
    import torch

    from deepspeed_tpu.comm import strategy as jstrategy
    from deepspeed_tpu.config import config as jconf
    from deepspeed_tpu_torch.comm.mesh import Mesh, MeshInfo
    from deepspeed_tpu_torch.runtime.engine import DeepSpeedEngine

    two = MeshInfo({"data": 2, "fsdp": 1})
    layer = tstrategy.CommLayer(None, two, tconfig.CommConfig(strategy=strategy))
    want = layer.select(4 * 10**8, torch.float32, ("data", "fsdp"), site="grad-exchange")
    jd = jstrategy.select_strategy(jconf.CommConfig(strategy=strategy), 4 * 10**8, jnp.float32, 2)
    assert want == jd.strategy and want in ("int8", "onebit")
    assert layer.table()["grad-exchange"] == (jd.strategy, jd.reason)
    one = tstrategy.CommLayer(None, MeshInfo({"data": 1}), tconfig.CommConfig(strategy=strategy))
    assert one.select(4 * 10**8, torch.float32, ("data", "fsdp"), site="grad-exchange") == "dense"
    dense = tstrategy.CommLayer(None, two, tconfig.CommConfig(strategy="dense"))
    assert dense.select(4 * 10**8, torch.float32, ("data", "fsdp"), site="g") == "dense"
    assert dense.table() == {"g": ("dense", "comm.strategy = dense")}
    # an engine of rank 0 of {data 2, expert 2}, its groups not built (no
    # process group here): the refusal comes before any collective
    monkeypatch.setattr(Mesh, "ensure_groups", lambda self, axis_sets: None)
    cfg = tconfig.DeepSpeedConfig({"train_batch_size": 4, "mesh": {"data": 2, "expert": 2},
                                   "comm": {"strategy": strategy, "threshold_bytes": 0}})
    with pytest.raises(NotImplementedError, match="A13"):
        DeepSpeedEngine(model=lambda p, b, g: p["w"].sum(), params={"w": np.ones(8, np.float32)},
                        config=cfg, device="cpu", mesh=Mesh({"data": 2, "expert": 2}))
