"""horovod_tpu_torch's sequence parallelism against the JAX package.

Four gloo ranks, spawned once for the whole module, each hold one shard
of a numpy-seeded sequence and run ``ring_attention``,
``ring_flash_attention`` and ``ulysses_attention`` (causal and not) over
the world's ring, forward and backward, plus ``mpi_ops.reducescatter``
and ``alltoall``; the tests hold the shards, put together in rank order,
against ``jax.shard_map`` over an 'sp' axis of 4 devices running
``horovod_tpu/parallel/ring.py`` on the same inputs (its ring_flash runs
its pure-JAX pair twins on the CPU; the port's runs the plain tile walks
of the flash kernels). Tolerances as ``tests/test_ring_attention.py``:
fp32 2e-5 forward, rtol 1e-4 / atol 1e-5 gradients. In this process: the
ulysses divisibility error, the one-rank ring (the sp = 1 path), and the
thread-backed ring that lets ranks share one card.
"""

import socket
import threading
import traceback

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from horovod_tpu_torch import mpi_ops
from horovod_tpu_torch.parallel import ring as tring

WORLD = 4
JOIN_TIMEOUT_S = 180
B, S, H, D = 2, 32, 4, 8
IMPLS = ("ring", "ring_flash", "ulysses")
CASES = [(impl, causal) for impl in IMPLS for causal in (True, False)]
FWD_TOL = dict(rtol=2e-5, atol=2e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _inputs(seed=0, h=H):
    """Unit-scale q, k, v and the output cotangent, [B, S, h, D]."""
    rng = np.random.RandomState(seed)
    return [rng.randn(B, S, h, D).astype(np.float32) for _ in range(4)]


def _shard(x, r, world=WORLD):
    n = x.shape[1] // world
    return np.ascontiguousarray(x[:, r * n:(r + 1) * n])


def _attend(impl, ring, arrays, causal):
    """(out, dq, dk, dv) of this rank's shards through ``impl``."""
    fn = getattr(tring, f"{impl}_attention")
    ts = [torch.from_numpy(a).requires_grad_(True) for a in arrays[:3]]
    out = fn(*ts, axis_name=ring, causal=causal)
    out.backward(torch.from_numpy(arrays[3]))
    return [out.detach().numpy()] + [t.grad.numpy() for t in ts]


def _collectives(r):
    x = (np.arange(8 * 3, dtype=np.float32).reshape(8, 3) + 100 * r)
    y = (np.arange(2 * 4 * 8, dtype=np.float32).reshape(2, 4, 8) + 1000 * r)
    return {"reducescatter": mpi_ops.reducescatter(torch.from_numpy(x))
            .numpy(),
            "reducescatter_avg": mpi_ops.reducescatter(
                torch.from_numpy(x), average=True).numpy(),
            "alltoall": mpi_ops.alltoall(torch.from_numpy(y), split_axis=2,
                                         concat_axis=1).numpy()}


def _worker(r, port, results):
    torch.set_num_threads(1)   # four ranks share the host's cores
    report = {}
    try:
        mpi_ops.init(device="cpu", rank=r, size=WORLD,
                     init_method=f"tcp://localhost:{port}")
        ring = tring.GroupRing()
        arrays = [_shard(x, r) for x in _inputs()]
        for impl, causal in CASES:
            try:
                report[(impl, causal)] = _attend(impl, ring, arrays, causal)
            except Exception:  # noqa: BLE001 — reported to the parent
                report[(impl, causal)] = traceback.format_exc()
        report["collectives"] = _collectives(r)
        mpi_ops.shutdown()
    except Exception:  # noqa: BLE001
        report["init"] = traceback.format_exc()
    results.put((r, report))


@pytest.fixture(scope="module")
def reports():
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    port = _free_port()
    procs = [ctx.Process(target=_worker, args=(r, port, results))
             for r in range(WORLD)]
    for p in procs:
        p.start()
    got = {}
    try:
        for _ in range(WORLD):
            r, report = results.get(timeout=JOIN_TIMEOUT_S)
            got[r] = report
    finally:
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.terminate()
                p.join(timeout=10)
    assert sorted(got) == list(range(WORLD))
    for r in range(WORLD):
        assert "init" not in got[r], got[r]["init"]
    return got


def _jax_sp(fn, arrays, n_sp=WORLD):
    """(out, dq, dk, dv) of ``fn`` under shard_map over an 'sp' axis of
    ``n_sp`` devices, whole-sequence arrays in and out."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, PartitionSpec as JP
    from horovod_tpu.common import compat
    mesh = Mesh(np.asarray(jax.devices()[:n_sp]), ("sp",))
    spec = JP(None, "sp")
    f = compat.shard_map(fn, mesh=mesh, in_specs=(spec, spec, spec),
                         out_specs=spec)
    q, k, v, g = (jnp.asarray(a) for a in arrays)

    @jax.jit
    def run(q, k, v, g):
        out, vjp = jax.vjp(f, q, k, v)
        return (out, *vjp(g))
    return [np.asarray(t) for t in run(q, k, v, g)]


def _jax_impl(impl, causal):
    from horovod_tpu.parallel import ring as jring
    fn = getattr(jring, f"{impl}_attention")
    return lambda q, k, v: fn(q, k, v, axis_name="sp", causal=causal)


@pytest.mark.parametrize("impl,causal", CASES)
def test_matches_jax_shard_map(hvd, reports, impl, causal):
    for r in range(WORLD):
        assert not isinstance(reports[r][(impl, causal)], str), \
            f"rank {r}:\n{reports[r][(impl, causal)]}"
    got = [np.concatenate([reports[r][(impl, causal)][i]
                           for r in range(WORLD)], axis=1)
           for i in range(4)]
    want = _jax_sp(_jax_impl(impl, causal), _inputs())
    np.testing.assert_allclose(got[0], want[0], **FWD_TOL)
    for name, a, w in zip(("dq", "dk", "dv"), got[1:], want[1:]):
        np.testing.assert_allclose(a, w, err_msg=name, **GRAD_TOL)


def test_collectives_match_jax(hvd, reports):
    import jax
    import jax.numpy as jnp
    from jax import lax
    from jax.sharding import Mesh, PartitionSpec as JP
    from horovod_tpu.common import compat
    mesh = Mesh(np.asarray(jax.devices()[:WORLD]), ("sp",))
    xs = np.concatenate([np.arange(24, dtype=np.float32).reshape(8, 3) +
                         100 * r for r in range(WORLD)])
    ys = np.concatenate([np.arange(64, dtype=np.float32).reshape(2, 4, 8) +
                         1000 * r for r in range(WORLD)], axis=1)
    rs = compat.shard_map(lambda x: lax.psum_scatter(x, "sp", tiled=True),
                          mesh=mesh, in_specs=JP("sp"), out_specs=JP("sp"))
    a2a = compat.shard_map(
        lambda y: lax.all_to_all(y, "sp", split_axis=2, concat_axis=1,
                                 tiled=True),
        mesh=mesh, in_specs=JP(None, "sp"), out_specs=JP(None, None, "sp"))
    want_rs = np.asarray(jax.jit(rs)(jnp.asarray(xs)))
    want_a2a = np.asarray(jax.jit(a2a)(jnp.asarray(ys)))
    got = [reports[r]["collectives"] for r in range(WORLD)]
    np.testing.assert_array_equal(
        np.concatenate([g["reducescatter"] for g in got]), want_rs)
    np.testing.assert_allclose(
        np.concatenate([g["reducescatter_avg"] for g in got]),
        want_rs / WORLD)
    np.testing.assert_array_equal(
        np.concatenate([g["alltoall"] for g in got], axis=2), want_a2a)


def test_ulysses_divisibility_error(hvd):
    """3 heads over 4 ranks: both packages refuse with the same message
    (the JAX package through an assert)."""
    from horovod_tpu.parallel import ring as jring
    arrays = _inputs(h=3)
    with pytest.raises(AssertionError) as jerr:
        _jax_sp(lambda q, k, v: jring.ulysses_attention(q, k, v), arrays)
    world = tring.ThreadRing(WORLD)
    q = torch.from_numpy(_shard(arrays[0], 0))
    with pytest.raises(ValueError) as terr:
        tring.ulysses_attention(q, q, q, axis_name=world.rank(0))
    assert str(terr.value) == str(jerr.value)


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("causal", [True, False])
def test_one_rank_ring_matches_jax(hvd, impl, causal):
    """The sp = 1 path: a ring of one rank is full attention, forward and
    backward, as the JAX package's over an sp axis of one device."""
    arrays = _inputs(seed=1)
    got = _attend(impl, tring.ThreadRing(1).rank(0), arrays, causal)
    want = _jax_sp(_jax_impl(impl, causal), arrays, n_sp=1)
    np.testing.assert_allclose(got[0], want[0], **FWD_TOL)
    for a, w in zip(got[1:], want[1:]):
        np.testing.assert_allclose(a, w, **GRAD_TOL)


@pytest.mark.parametrize("causal", [True, False])
def test_thread_ring_flash_matches_the_gloo_ring(reports, causal):
    """Ranks as threads of one process (how ranks share one card): each
    thread drives ``ring_flash_fwd`` and ``ring_flash_bwd`` itself and
    gets the gloo ranks' output and gradients."""
    arrays = _inputs()
    world = tring.ThreadRing(WORLD)
    got = [None] * WORLD
    errors = []

    def rank(r):
        try:
            ring = world.rank(r)
            q, k, v, g = (torch.from_numpy(_shard(a, r)) for a in arrays)
            out, lse = tring.ring_flash_fwd(q, k, v, ring, causal, D ** -0.5,
                                            (8, 8))
            got[r] = [out, *tring.ring_flash_bwd(q, k, v, out, lse, g, ring,
                                                 causal, D ** -0.5, (8, 8))]
        except Exception:  # noqa: BLE001 — re-raised below
            errors.append(traceback.format_exc())
            world._barrier.abort()
    threads = [threading.Thread(target=rank, args=(r,)) for r in range(WORLD)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
        assert not t.is_alive()
    assert not errors, errors[0]
    for r in range(WORLD):
        for a, w in zip(got[r], reports[r][("ring_flash", causal)]):
            np.testing.assert_allclose(a.numpy(), w, rtol=1e-6, atol=1e-7)
