"""The compressed gradient exchanges of the port (``comm/compressed.py``,
``comm/collectives.py``'s int8 all-reduce, ``comm/strategy.py``'s
``exchange_rows``) against the JAX package's on a ``data: 4`` host mesh,
on the CPU, and the host staging rule of ``comm/collectives.py``.

The port's plain versions take every rank's row stacked ``(n, M)`` in one
process (the JAX functions take the same rows sharded over ``data``); the
group versions run over real gloo ranks in
``tests/test_torch_onebit.py``'s spawn, held to the plain ones there.

Tolerances (f32):
* 1-bit: signs and scales from a mean of |x| over a row: the port and XLA
  sum in other orders, so a scale differs by a few f32 roundings
  (``SCALE_RTOL`` 1e-6); an output is a sign times a scale
  (``OUT_RTOL`` 1e-6 of the largest), a residual is ``x - sign * scale``
  (``RES_ATOL`` 1e-6).  A sign may flip only where the JAX value lies
  within ``SIGN_EPS`` (1e-7) of zero: such flips are counted and reported,
  and none is allowed elsewhere.
* int8 with nearest rounding: a code may move by one only where ``y``
  sits within 1e-5 of a rounding boundary; the outputs are held to one
  code's width (``scale``) at those places and 1e-6 relative elsewhere.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.comm import collectives as jcoll
from deepspeed_tpu.comm import compressed as jcomp
from deepspeed_tpu.comm.mesh import make_mesh
from deepspeed_tpu.comm import strategy as jstrategy
from deepspeed_tpu.config.config import CommConfig as JCommConfig
from deepspeed_tpu.config.config import MeshConfig
from deepspeed_tpu_torch.comm import collectives, compressed
from deepspeed_tpu_torch.comm import strategy
from deepspeed_tpu_torch.config.config import CommConfig

SCALE_RTOL, OUT_RTOL, RES_ATOL, SIGN_EPS = 1e-6, 1e-6, 1e-6, 1e-7
N = 4


def _mesh():
    return make_mesh(MeshConfig(data=N), devices=jax.devices()[:N])


def _rows(seed, m=1024, zeros=False):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((N, m)).astype(np.float32)
    if zeros:
        x[:, ::37] = 0.0  # exact zeros sign +1 on both sides
    return x


def _near_zero_flips(jax_vals, port_signs, jax_signs):
    """Sign disagreements, split into those on JAX values within SIGN_EPS
    of zero (allowed, counted) and the rest."""
    differ = np.asarray(port_signs) != np.asarray(jax_signs)
    near = np.abs(np.asarray(jax_vals)) <= SIGN_EPS
    return int((differ & near).sum()), int((differ & ~near).sum())


@pytest.mark.parametrize("zeros", [False, True], ids=["random", "with_zeros"])
def test_compressed_allreduce_and_residuals_match_jax(zeros):
    x = _rows(0, zeros=zeros)
    rng = np.random.default_rng(1)
    werr = (0.1 * rng.standard_normal(x.shape)).astype(np.float32)
    serr = (0.1 * rng.standard_normal((N, x.shape[1] // N))).astype(np.float32)
    mesh = _mesh()
    jout, jw, js = (np.asarray(a) for a in jcomp.compressed_allreduce(
        jnp.asarray(x), jnp.asarray(werr), jnp.asarray(serr), mesh))
    tout, tw, ts = compressed.compressed_allreduce_rows(
        torch.from_numpy(x), torch.from_numpy(werr), torch.from_numpy(serr))
    # the worker's signs, read back from the residuals (x + werr - new
    # residual = sign * scale): a flip only on a value within SIGN_EPS of 0
    corrected = x + werr
    near, far = _near_zero_flips(corrected, (corrected - tw.numpy()) > 0, (corrected - jw) > 0)
    print(f"worker sign flips within {SIGN_EPS} of zero: {near}")
    assert far == 0
    np.testing.assert_allclose(tout.numpy(), jout, rtol=0, atol=OUT_RTOL * np.abs(jout).max())
    np.testing.assert_allclose(tw.numpy(), jw, rtol=0, atol=RES_ATOL)
    np.testing.assert_allclose(ts.numpy(), js, rtol=0, atol=RES_ATOL)
    # every row of the average is the same
    assert all(torch.equal(tout[0], tout[i]) for i in range(N))


def test_compressed_out_form_and_chunks_match_jax():
    x = _rows(2)
    rng = np.random.default_rng(3)
    werr = (0.05 * rng.standard_normal(x.shape)).astype(np.float32)
    serr = np.zeros((N, x.shape[1] // N), np.float32)
    js, jsc, jw, je = (np.asarray(a) for a in jcoll.compressed_allreduce_compressed_out(
        jnp.asarray(x), jnp.asarray(werr), jnp.asarray(serr), _mesh()))
    ts, tsc, tw, te = compressed.compressed_allreduce_rows_compressed_out(
        torch.from_numpy(x), torch.from_numpy(werr), torch.from_numpy(serr))
    assert ts.dtype == torch.int8 and ts.shape == js.shape
    np.testing.assert_allclose(tsc.numpy(), jsc, rtol=SCALE_RTOL)
    flips = int((ts.numpy() != js).sum())
    assert flips == 0, f"{flips} server signs differ"
    np.testing.assert_allclose(tw.numpy(), jw, rtol=0, atol=RES_ATOL)
    np.testing.assert_allclose(te.numpy(), je, rtol=0, atol=RES_ATOL)
    # the chunk helpers
    flat = x[0]
    s1, c1 = jcomp.compress_chunks(jnp.asarray(flat), N)
    s2, c2 = compressed.compress_chunks(torch.from_numpy(flat), N)
    np.testing.assert_array_equal(s2.numpy(), np.asarray(s1))
    np.testing.assert_allclose(c2.numpy(), np.asarray(c1), rtol=SCALE_RTOL)
    np.testing.assert_allclose(compressed.decompress_chunks(s2, c2).numpy(),
                               np.asarray(jcomp.decompress_chunks(s1, c1)), rtol=SCALE_RTOL)


def test_error_feedback_keeps_the_running_mean():
    """The EF guarantee on the port's plain version (the JAX test's
    property, at 12 rounds): the time average of the outputs nears the true
    mean."""
    x = torch.from_numpy(_rows(4, m=512))
    werr, serr = torch.zeros_like(x), torch.zeros(N, 512 // N)
    acc = torch.zeros(512, dtype=torch.float64)
    for _ in range(12):
        out, werr, serr = compressed.compressed_allreduce_rows(x, werr, serr)
        acc += out[0].double()
    true = x.double().mean(0)
    err = float((acc / 12 - true).abs().mean() / true.abs().mean())
    assert err < 0.5, err


def _int8_jax(x, stochastic=False):
    return np.asarray(jcoll.quantized_allreduce_replicated(jnp.asarray(x), _mesh(),
                                                           stochastic=stochastic))


def test_int8_allreduce_nearest_matches_jax():
    x = _rows(5, m=2048)
    x[1, :100] = 0.0
    x[2] *= 1e3  # scales far apart
    want = _int8_jax(x)
    got = collectives.quantized_allreduce_rows(torch.from_numpy(x)).numpy()
    # where a scaled value sits on a rounding boundary, one code apart
    diff = np.abs(got - want)
    width = np.abs(want).max() / 127.0
    assert diff.max() <= width + 1e-6 * np.abs(want).max()
    assert (diff > 1e-6 * np.abs(want).max()).mean() < 1e-3
    np.testing.assert_allclose(collectives.dense_allreduce_rows(torch.from_numpy(x)).numpy(),
                               np.asarray(jcoll.dense_allreduce_replicated(jnp.asarray(x),
                                                                           _mesh())),
                               rtol=1e-6, atol=1e-6 * np.abs(x).max())


def test_int8_codes_and_scales_match_jax():
    x = _rows(6, m=256).reshape(N * 4, -1)
    q, s = collectives.quantize_chunks_int8(torch.from_numpy(x))
    jq, js = jcoll._quantize_chunks_int8(jnp.asarray(x), None)
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_allclose(s.numpy(), np.asarray(js), rtol=0)
    zero = collectives.quantize_chunks_int8(torch.zeros(2, 8))
    assert float(zero[1][0]) == 1.0 and int(zero[0].abs().max()) == 0


def test_int8_stochastic_rounding_is_unbiased():
    """The torch generator draws other bits than JAX's key (ROADMAP C4):
    held statistically: the mean of many stochastic codes nears y, and
    each code is floor(y) or floor(y) + 1."""
    y = torch.linspace(-3.3, 3.3, 64)[None].expand(4096, -1) * (126 / 3.3)
    xc = y.clone()
    g = torch.Generator().manual_seed(0)
    q, s = collectives.quantize_chunks_int8(xc, g)
    scaled = xc / s[:, None]
    lo = torch.floor(scaled)
    assert bool(((q.float() == lo) | (q.float() == lo + 1)).all())
    bias = (q.float() - scaled).mean(0).abs().max()
    assert float(bias) < 0.03, float(bias)


@pytest.mark.parametrize("name", ["dense", "int8", "onebit"])
def test_exchange_rows_matches_jax(name):
    x = _rows(7, m=512)
    jcfg = JCommConfig.from_dict({"strategy": name})
    tcfg = CommConfig.from_dict({"strategy": name})
    from deepspeed_tpu.comm.mesh import MeshInfo

    mesh = _mesh()
    jlayer = jstrategy.CommLayer(mesh, MeshInfo.from_mesh(mesh), jcfg)
    tlayer = strategy.CommLayer(None, None, tcfg)
    res = None
    if name == "onebit":
        res = (np.zeros_like(x), np.zeros((N, x.shape[1] // N), np.float32))
    jout, jres = jlayer.exchange_rows(
        jnp.asarray(x), "data", name,
        residuals=None if res is None else tuple(jnp.asarray(r) for r in res))
    tout, tres = tlayer.exchange_rows(
        torch.from_numpy(x), name,
        residuals=None if res is None else tuple(torch.from_numpy(r) for r in res))
    jout = np.asarray(jout)
    tol = (np.abs(jout).max() / 127.0) if name == "int8" else OUT_RTOL * np.abs(jout).max()
    np.testing.assert_allclose(tout.numpy(), jout, rtol=0, atol=tol + 1e-7)
    if name == "onebit":
        for a, b in zip(tres, jres):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=RES_ATOL)
    else:
        assert tres is None and jres is None


def test_select_no_longer_raises_and_keeps_the_policy():
    from deepspeed_tpu_torch.comm.mesh import Mesh, MeshInfo

    mesh = Mesh({"data": 2})
    for name, want in (("int8", "int8"), ("onebit", "onebit"), ("auto", "int8"),
                       ("dense", "dense")):
        layer = strategy.CommLayer(mesh, MeshInfo.from_mesh(mesh),
                                   CommConfig.from_dict({"strategy": name, "threshold_bytes": 0}))
        assert layer.select(4096, torch.float32, ("data", "fsdp"), site="grad-exchange") == want
        jd = jstrategy.select_strategy(JCommConfig.from_dict({"strategy": name,
                                                              "threshold_bytes": 0}),
                                       4096, jnp.float32, 2)
        assert jd.strategy == want
    one = Mesh({"data": 1})
    layer = strategy.CommLayer(one, MeshInfo.from_mesh(one), CommConfig.from_dict(
        {"strategy": "int8", "threshold_bytes": 0}))
    assert layer.select(4096, torch.float32, ("data",), site="grad-exchange") == "dense"


def test_host_staging_rule(tmp_path):
    """A CUDA tensor on a gloo group goes through host memory; a CPU tensor
    does not; the staged all-to-all, all-gather and reduce-scatter give
    the unstaged results (a one-rank gloo group, the staging forced)."""
    import torch.distributed as dist

    own = not dist.is_initialized()
    if own:
        dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store", world_size=1,
                                rank=0)
    try:
        pg = dist.group.WORLD
        assert collectives._host_staged(torch.device("cuda"), pg)
        assert not collectives._host_staged(torch.device("cpu"), pg)
        x = torch.arange(24, dtype=torch.float32).reshape(4, 6)
        plain = (collectives.all_to_all(x, pg, 0, 1), collectives.all_gather(x, pg, dim=1),
                 collectives.reduce_scatter(x, pg, dim=0))
        orig = collectives._host_staged
        collectives._host_staged = lambda device, group: True
        try:
            staged = (collectives.all_to_all(x, pg, 0, 1), collectives.all_gather(x, pg, dim=1),
                      collectives.reduce_scatter(x, pg, dim=0))
        finally:
            collectives._host_staged = orig
        for a, b in zip(plain, staged):
            assert torch.equal(a, b)
        out = collectives.host_all_gather(torch.ones(5), pg)
        assert out.shape == (5,) and collectives.host_group() is pg
    finally:
        if own:
            dist.destroy_process_group()
