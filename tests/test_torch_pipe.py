"""The port's pipeline (deepspeed_tpu_torch.runtime.pipe and the partition
helpers of runtime/utils.py) against the JAX package's, on the CPU.

* The partition helpers and every schedule's instruction stream equal the
  JAX package's, instruction for instruction.
* ``PipelineModule``: body detection, stacking, tied layers, the
  refusals (no homogeneous body; a body the stages do not divide).
* ``PipelineEngine`` over gloo, stages as OS processes
  (``deepspeed_tpu_torch/tools/pipe_worker.py``): the JAX package's
  4 x Linear + head, f32, Adam, micro 2 x gas 4, 3 steps, at 2 and 4
  stages with ``1f1b`` and ``gpipe``: losses within 1e-5 relative and
  parameters within 2e-6 absolute of the same module at one stage in one
  process (the same f32 math, gradients summed over micro-batches in the
  same order), and losses within 1e-5 relative of JAX's
  ``PipelineEngine`` on a host mesh of ``pipe`` devices (``1f1b``; JAX's
  own tests hold ``gpipe`` to it).  The bytes each stage counts equal
  ``pipe_comm_model``.
* The tied embedding ⇄ head (the JAX package's tests/test_pipe.py
  ``Embed`` as the first layer and, through ``forward_fn``, the last) at
  2 and 4 stages: the two stages' gradients summed over ``pipe``; losses
  and parameters as one stage's, losses as JAX's ``PipelineEngine``'s.
* At gas 8, 1F1B keeps at most ``stages`` micro-batches live on every
  stage; GPipe keeps 8 on the first.
* ``pipe 2 x model 2`` with the Megatron MLP block equals one process.
* A tag saved at ``pipe 2`` loads at ``pipe 1`` with the saver's
  parameters (the natural layout).
* ZeRO stage 2 and the micro-step API are refused.
"""
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.comm.mesh import make_mesh
from deepspeed_tpu.config.config import MeshConfig
from deepspeed_tpu.runtime import utils as jutils
from deepspeed_tpu.runtime.pipe import PipelineModule as JPipelineModule
from deepspeed_tpu.runtime.pipe import LayerSpec as JLayerSpec
from deepspeed_tpu.runtime.pipe import TiedLayerSpec as JTiedLayerSpec
from deepspeed_tpu.runtime.pipe import schedule as jsched
from deepspeed_tpu_torch.runtime import utils as tutils
from deepspeed_tpu_torch.runtime.engine import tree_items
from deepspeed_tpu_torch.runtime.pipe import LayerSpec, PipelineModule, TiedLayerSpec
from deepspeed_tpu_torch.runtime.pipe import schedule as tsched
from deepspeed_tpu_torch.tools import pipe_worker as pw

from tests.simple_model import base_config
from tests.test_pipe import Embed as JEmbed
from tests.test_pipe import Linear as JLinear
from tests.test_pipe import mse_loss as jmse

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DIM, MB, GAS, STEPS = 16, 2, 4, 3
VOCAB, SEQ = 32, 4
TIED = {"kind": "tied", "vocab": VOCAB, "dim": DIM, "nblocks": 4}
LOSS_RTOL, PARAM_ATOL = 1e-5, 2e-6


# ---------------------------------------------------------------------------
# pure logic
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,parts", [(8, 4), (9, 4), (3, 4), (14, 2), (1, 1), (13, 5)])
def test_partition_uniform_matches_jax(n, parts):
    assert tutils.partition_uniform(n, parts) == jutils.partition_uniform(n, parts)


@pytest.mark.parametrize("weights,parts", [
    ([1, 1, 1, 1], 2), ([10, 1, 1, 1, 1], 2), ([1, 1, 1, 1, 10], 2),
    ([3, 0, 5, 2, 2, 7, 1], 3), ([0, 4, 4, 4, 4, 0], 4), ([2], 3)])
def test_partition_balanced_matches_jax(weights, parts):
    assert tutils.partition_balanced(weights, parts) == jutils.partition_balanced(weights, parts)
    assert tutils.prefix_sum_inc(weights) == jutils.prefix_sum_inc(weights)


def _stream(sched):
    return [[repr(c) for c in step] for step in sched]


@pytest.mark.parametrize("name", ["TrainSchedule", "InferenceSchedule", "DataParallelSchedule"])
@pytest.mark.parametrize("stages", [1, 2, 4])
def test_schedules_match_jax(name, stages):
    for M in (1, 3, 8):
        for s in range(stages):
            a = getattr(tsched, name)(micro_batches=M, stages=stages, stage_id=s)
            b = getattr(jsched, name)(micro_batches=M, stages=stages, stage_id=s)
            assert _stream(a) == _stream(b), (M, s)
            assert a.num_pipe_buffers() == b.num_pipe_buffers()
            assert a.bubble_fraction() == b.bubble_fraction()


def test_pipeline_module_body_detection_and_refusals():
    m = PipelineModule([LayerSpec(pw.Linear, 8) for _ in range(4)]
                       + [LayerSpec(pw.Linear, 8, act=False)], loss_fn=pw.mse_loss)
    assert (m.body_len, m.post_ids) == (4, [4])
    m2 = PipelineModule([LayerSpec(pw.Linear, 8, seed_scale=2.0)]
                        + [LayerSpec(pw.Linear, 8) for _ in range(4)], loss_fn=pw.mse_loss)
    assert (m2.body_start, m2.body_len, m2.pre_ids) == (1, 4, [0])
    params = m.build_params(0)
    assert params["blocks"]["w"].shape == (4, 8, 8) and params["pre"] == {}
    m.configure_stages(2)
    assert m.parts == JPipelineModule([JLayerSpec(JLinear, 8) for _ in range(4)]
                                      + [JLayerSpec(JLinear, 8, act=False)],
                                      loss_fn=jmse)._partition_layers(2)
    with pytest.raises(ValueError, match="does not divide"):
        m.configure_stages(3)
    with pytest.raises(ValueError, match="homogeneous run"):
        PipelineModule([lambda x: x, lambda x: x * 2]).configure_stages(2)


def test_tied_layers_share_params_and_sequential_matches_manual():
    class Embed:
        def __init__(self, vocab, dim):
            self.vocab, self.dim = vocab, dim

        def init(self, rng):
            return {"e": (rng.standard_normal((self.vocab, self.dim)) * 0.02).astype(np.float32)}

        def apply(self, params, x, generator=None):
            return params["e"][x]

    m = PipelineModule([TiedLayerSpec("embed", Embed, 32, 8), LayerSpec(pw.Linear, 8),
                        LayerSpec(pw.Linear, 8),
                        TiedLayerSpec("embed", Embed, 32, 8, forward_fn=lambda p, x: x @ p["e"].t())],
                       loss_fn=lambda out, labels: out.mean())
    params = m.build_params(0)
    assert list(params["tied"]) == ["embed"]
    tp = {k: {n: (torch.from_numpy(v) if not isinstance(v, dict)
                  else {q: torch.from_numpy(a) for q, a in v.items()}) for n, v in sec.items()}
          for k, sec in params.items()}
    out = m.sequential(tp, torch.tensor([[1, 2], [3, 4]]))
    assert out.shape == (2, 2, 32)
    h = tp["tied"]["embed"]["e"][torch.tensor([[1, 2], [3, 4]])]
    for i in range(2):
        h = torch.nn.functional.gelu(h @ tp["blocks"]["w"][i] + tp["blocks"]["b"][i],
                                     approximate="tanh")
    torch.testing.assert_close(out, h @ tp["tied"]["embed"]["e"].t())


def test_zero2_and_the_micro_api_are_refused():
    module, _ = pw.build_module({"kind": "linear", "dim": 8}, {})
    with pytest.raises(AssertionError):
        deepspeed_tpu_torch.initialize(model=module, device="cpu",
                                       config=base_config(stage=2, micro_bs=2, gas=2, dtype="fp32"))
    eng, *_ = deepspeed_tpu_torch.initialize(model=module, device="cpu",
                                             config=base_config(stage=0, micro_bs=2, gas=2,
                                                                dtype="fp32"))
    with pytest.raises(RuntimeError):
        eng.forward({"x": np.zeros((2, 8))})
    with pytest.raises(RuntimeError):
        eng.backward()
    with pytest.raises(RuntimeError):
        eng.step()
    x = np.zeros((4, 8), np.float32)
    loss = eng.train_batch(iter([(x[:2], x[:2]), (x[2:], x[2:])]))  # the data-iterator API
    assert np.isfinite(float(loss))


# ---------------------------------------------------------------------------
# stages as processes
# ---------------------------------------------------------------------------

def _config(mesh, schedule="1f1b", gas=GAS, stage=0):
    return {**base_config(stage=stage, micro_bs=MB, gas=gas, dtype="fp32", mesh=mesh),
            "pipeline": {"schedule": schedule}}


def _launch(world, cases, tmp, name):
    spec = {"device": "cpu", "init_method": f"file://{tmp}/store{name}", "out": str(tmp),
            "cases": cases}
    path = tmp / f"spec{name}.json"
    path.write_text(json.dumps(spec))
    procs = []
    for r in range(world):
        env = dict(os.environ, RANK=str(r), WORLD_SIZE=str(world), LOCAL_RANK=str(r),
                   PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "deepspeed_tpu_torch.tools.pipe_worker", str(path)],
            env=env, cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    outs = [p.communicate(timeout=300)[0] for p in procs]
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} of {world} exited {p.returncode}:\n{out[-3000:]}"


def _batches(path, gas=GAS, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((STEPS, gas * MB, DIM)).astype(np.float32)
    w = rng.standard_normal((DIM, DIM)).astype(np.float32)
    np.savez(path, x=x, y=np.tanh(x @ w * 0.3))
    return str(path)


def _token_batches(path, seed=1):
    rng = np.random.default_rng(seed)
    shape = (STEPS, GAS * MB, SEQ)
    np.savez(path, x=rng.integers(0, VOCAB, shape, dtype=np.int32),
             y=rng.integers(0, VOCAB, shape, dtype=np.int32))
    return str(path)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("pipe")
    b4, b8 = _batches(tmp / "b4.npz"), _batches(tmp / "b8.npz", gas=8)
    bt = _token_batches(tmp / "bt.npz")
    lin = {"kind": "linear", "dim": DIM, "nblocks": 4}
    ck = str(tmp / "ckpt")
    case = lambda name, mesh, **kw: {"name": name, "module": kw.pop("module", lin),  # noqa: E731
                                     "config": _config(mesh, **kw.pop("cfg", {})),
                                     "batches": kw.pop("batches", b4), "steps": STEPS, **kw}
    _launch(2, [case("p2_1f1b", {"pipe": 2}, eval=True, save={"dir": ck, "tag": "p2"}),
                case("p2_gpipe", {"pipe": 2}, cfg={"schedule": "gpipe"}),
                case("p2_live_1f1b", {"pipe": 2}, cfg={"gas": 8}, batches=b8, steps=1,
                     record="none"),
                case("p2_live_gpipe", {"pipe": 2}, cfg={"gas": 8, "schedule": "gpipe"},
                     batches=b8, steps=1, record="none"),
                case("p2_tied", {"pipe": 2}, module=TIED, batches=bt)], tmp, "2")
    mlp = {"kind": "mlp", "dim": DIM, "nblocks": 4}
    _launch(4, [case("p4_1f1b", {"pipe": 4}),
                case("p4_gpipe", {"pipe": 4}, cfg={"schedule": "gpipe"}),
                case("p2m2", {"pipe": 2, "model": 2}, module=mlp, cfg={"stage": 1}),
                case("p4_tied", {"pipe": 4}, module=TIED, batches=bt)], tmp, "4")
    return {"tmp": tmp, "b4": b4, "bt": bt, "ck": ck}


def _read(runs, name):
    with open(runs["tmp"] / f"{name}.json") as f:
        meta = json.load(f)
    path = runs["tmp"] / f"{name}.npz"
    state = None
    if path.exists():
        with np.load(path) as z:
            state = {k: z[k] for k in z.files}
    return meta, state


def _one_process(module_spec, batches, stage=0, load=None, steps=STEPS):
    torch.use_deterministic_algorithms(True)
    module, _ = pw.build_module(module_spec, {})
    eng, *_ = deepspeed_tpu_torch.initialize(model=module, device="cpu",
                                             config=_config({"pipe": 1}, stage=stage))
    if load is not None:
        eng.load_checkpoint(*load)
    with np.load(batches) as z:
        losses = [float(eng.train_batch(batch=(z["x"][s], z["y"][s]))) for s in range(steps)]
    return losses, {p: t.numpy() for p, t in tree_items(eng.params)}


def _jnll(logits, labels):
    lp = jax.nn.log_softmax(logits.astype(jnp.float32), axis=-1)
    return -jnp.mean(jnp.take_along_axis(lp, labels[..., None].astype(jnp.int32), axis=-1))


def _jax_losses(batches, stages, spec=None):
    if spec is None:
        spec = {"kind": "linear", "dim": DIM, "nblocks": 4}
        module = JPipelineModule([JLayerSpec(JLinear, DIM, act=True) for _ in range(4)]
                                 + [JLayerSpec(JLinear, DIM, act=False)], loss_fn=jmse)
    else:
        module = JPipelineModule(
            [JTiedLayerSpec("embed", JEmbed, VOCAB, DIM)]
            + [JLayerSpec(JLinear, DIM, act=True) for _ in range(4)]
            + [JTiedLayerSpec("embed", JEmbed, VOCAB, DIM,
                              forward_fn=lambda p, x: x @ p["e"].T.astype(x.dtype))],
            loss_fn=_jnll)
    params, _ = pw.build_module(spec, {})
    params = jax.tree.map(jnp.asarray, params.build_params(42))  # the config seed (default 42)
    mesh = make_mesh(MeshConfig(pipe=stages, data=1), devices=jax.devices()[:stages])
    eng, *_ = deepspeed_tpu.initialize(model=module, model_parameters=params, mesh=mesh,
                                       config=base_config(stage=0, micro_bs=MB, gas=GAS,
                                                          dtype="fp32"))
    with np.load(batches) as z:
        return [float(eng.train_batch(batch=(z["x"][s], z["y"][s]))) for s in range(STEPS)]


_ONE = {}


def _reference(runs):
    if "lin" not in _ONE:
        _ONE["lin"] = _one_process({"kind": "linear", "dim": DIM, "nblocks": 4}, runs["b4"])
    return _ONE["lin"]


@pytest.mark.parametrize("name", ["p2_1f1b", "p2_gpipe", "p4_1f1b", "p4_gpipe"])
def test_pipelined_training_matches_one_stage(runs, name):
    meta, state = _read(runs, name)
    losses, params = _reference(runs)
    np.testing.assert_allclose(meta["losses"], losses, rtol=LOSS_RTOL)
    assert losses[-1] < losses[0]
    for path, a in params.items():
        np.testing.assert_allclose(state[path], a, atol=PARAM_ATOL, rtol=0, err_msg=path)
    if meta["evals"]:
        assert all(np.isfinite(meta["evals"]))
    for rank in meta["ranks"]:
        for step in rank["comm"]:
            for kind, want in rank["model"].items():
                assert step.get(kind, 0) == want, (name, rank["stage"], kind, step)


@pytest.mark.parametrize("stages", [2, 4])
def test_pipelined_training_matches_the_jax_engine(runs, stages):
    meta, _ = _read(runs, f"p{stages}_1f1b")
    np.testing.assert_allclose(meta["losses"], _jax_losses(runs["b4"], stages), rtol=LOSS_RTOL)


@pytest.mark.parametrize("stages", [2, 4])
def test_tied_embedding_head_across_stages_matches_one_stage_and_jax(runs, stages):
    """The embedding on the first stage and the head on the last share one
    leaf; their gradients are summed over ``pipe`` (``pipe-grad-reduce``),
    so the losses and every parameter equal one stage's, and the losses
    JAX's ``PipelineEngine``'s."""
    meta, state = _read(runs, f"p{stages}_tied")
    if "tied" not in _ONE:
        _ONE["tied"] = _one_process(TIED, runs["bt"])
    losses, params = _ONE["tied"]
    np.testing.assert_allclose(meta["losses"], losses, rtol=LOSS_RTOL)
    assert losses[-1] < losses[0]
    assert "tied/embed/e" in params
    for path, a in params.items():
        np.testing.assert_allclose(state[path], a, atol=PARAM_ATOL, rtol=0, err_msg=path)
    for rank in meta["ranks"]:
        assert rank["comm"][-1]["pipe-grad-reduce"] == rank["model"]["pipe-grad-reduce"] > 0
    np.testing.assert_allclose(meta["losses"], _jax_losses(runs["bt"], stages, TIED),
                               rtol=LOSS_RTOL)


def test_1f1b_live_micro_batches_bounded_by_stages(runs):
    one, _ = _read(runs, "p2_live_1f1b")
    gp, _ = _read(runs, "p2_live_gpipe")
    assert max(r["max_live"] for r in one["ranks"]) <= 2
    assert gp["ranks"][0]["stage"] == 0 and gp["ranks"][0]["max_live"] == 8
    np.testing.assert_allclose(one["losses"], gp["losses"], rtol=LOSS_RTOL)


def test_pipe_by_model_matches_one_process(runs):
    meta, state = _read(runs, "p2m2")
    losses, params = _one_process({"kind": "mlp", "dim": DIM, "nblocks": 4}, runs["b4"], stage=1)
    np.testing.assert_allclose(meta["losses"], losses, rtol=LOSS_RTOL)
    for path, a in params.items():
        np.testing.assert_allclose(state[path], a, atol=PARAM_ATOL, rtol=0, err_msg=path)


def test_pipe_2_tag_loads_at_pipe_1(runs):
    _, state = _read(runs, "p2_1f1b")
    _, params = _one_process({"kind": "linear", "dim": DIM, "nblocks": 4}, runs["b4"],
                             load=(runs["ck"], "p2"), steps=0)
    for path, a in params.items():
        np.testing.assert_array_equal(a, state[path], err_msg=path)
