"""horovod_tpu_torch's mesh module against ``horovod_tpu/parallel/mesh.py``.

The layout math needs no process group: ``build_mesh`` over a list of
ranks gives the axis names, shape and device order the JAX package gives
over as many devices (its 8-device CPU mesh), and raises the same errors;
``parse_mesh_spec``, ``mesh_from_env``, the global-mesh lifecycle,
``spec_shard_shape``, ``axis_size`` and ``mesh_layout`` agree case by
case (mirroring ``tests/test_parallel.py`` and
``tests/test_mesh_plane.py``). A PartitionSpec's shard on each rank
(``NamedSharding.local_slice``) is the block JAX places on that device.
The worker-mesh names of ``common.state`` come last.
"""

import numpy as np
import pytest
import torch

from horovod_tpu_torch.parallel import mesh as tmesh
from horovod_tpu_torch.parallel.mesh import P


@pytest.fixture
def jmesh(hvd):
    from horovod_tpu.parallel import mesh as jm
    jm.reset_global_mesh()
    tmesh.reset_global_mesh()
    yield jm
    jm.reset_global_mesh()
    tmesh.reset_global_mesh()


def _jax_devices(n):
    import jax
    return jax.devices()[:n]


def _same_layout(tm, jm_mesh):
    assert tm.axis_names == tuple(jm_mesh.axis_names)
    assert tm.shape == dict(jm_mesh.shape)
    ids = np.vectorize(lambda d: d.id)(jm_mesh.devices)
    np.testing.assert_array_equal(tm.devices, ids)


def _raises_alike(fn_t, fn_j):
    with pytest.raises(Exception) as jerr:
        fn_j()
    with pytest.raises(type(jerr.value)) as terr:
        fn_t()
    assert str(terr.value) == str(jerr.value)


class TestBuildMesh:
    @pytest.mark.parametrize("kw", [dict(), dict(tp=2), dict(tp=2, sp=2),
                                    dict(dp=2, tp=4), dict(pp=2, ep=2),
                                    dict(dp=1, pp=2, tp=2, sp=2, ep=1)])
    def test_shape_and_order(self, jmesh, kw):
        _same_layout(tmesh.build_mesh(devices=list(range(8)), **kw),
                     jmesh.build_mesh(devices=_jax_devices(8), **kw))

    def test_custom_axis_order(self, jmesh):
        order = ("tp", "dp", "pp", "sp", "ep")
        _same_layout(tmesh.build_mesh(tp=2, devices=list(range(8)),
                                      axis_order=order),
                     jmesh.build_mesh(tp=2, devices=_jax_devices(8),
                                      axis_order=order))

    @pytest.mark.parametrize("kw", [dict(tp=3), dict(dp=3, tp=2),
                                    dict(dp=2, tp=2)])
    def test_errors(self, jmesh, kw):
        _raises_alike(lambda: tmesh.build_mesh(devices=list(range(8)), **kw),
                      lambda: jmesh.build_mesh(devices=_jax_devices(8), **kw))

    def test_size_one_axes_are_kept(self, jmesh):
        m = tmesh.build_mesh(devices=[0])
        assert m.shape == {"dp": 1, "pp": 1, "tp": 1, "sp": 1, "ep": 1}
        assert tmesh.mesh_axis_size(m, "sp") == 1
        assert tmesh.mesh_axis_size(m, "nope") == 1


class TestSpec:
    @pytest.mark.parametrize("spec", ["dp=2,tp=4", "tp=2", " sp = 4 ,",
                                      "dp=1,pp=1,tp=1,sp=1,ep=8", ""])
    def test_parse(self, jmesh, spec):
        assert tmesh.parse_mesh_spec(spec) == jmesh.parse_mesh_spec(spec)

    @pytest.mark.parametrize("spec", ["tp", "xp=2", "tp=2,tp=2", "tp=two",
                                      "tp=0"])
    def test_parse_errors(self, jmesh, spec):
        _raises_alike(lambda: tmesh.parse_mesh_spec(spec),
                      lambda: jmesh.parse_mesh_spec(spec))

    @pytest.mark.parametrize("env", [{}, {"HOROVOD_MESH": "tp=2,sp=2"},
                                     {"HOROVOD_MESH_TP": "4"},
                                     {"HOROVOD_MESH_SP": "2",
                                      "HOROVOD_MESH_PP": "2"},
                                     {"HOROVOD_MESH": "dp=2,tp=4",
                                      "HOROVOD_MESH_TP": "8"}])
    def test_mesh_from_env(self, jmesh, env):
        _same_layout(tmesh.mesh_from_env(devices=list(range(8)), environ=env),
                     jmesh.mesh_from_env(devices=_jax_devices(8),
                                         environ=env))

    def test_mesh_from_env_error(self, jmesh):
        env = {"HOROVOD_MESH": "tp=3"}
        _raises_alike(lambda: tmesh.mesh_from_env(devices=list(range(8)),
                                                  environ=env),
                      lambda: jmesh.mesh_from_env(devices=_jax_devices(8),
                                                  environ=env))


class TestGlobalMesh:
    def test_lifecycle(self, jmesh, monkeypatch):
        monkeypatch.setenv("HOROVOD_MESH", "tp=2")
        for mod, devs in ((tmesh, list(range(8))),
                          (jmesh, _jax_devices(8))):
            assert mod.global_mesh_if_set() is None
            m = mod.global_mesh(devices=devs)   # lazily from the env
            assert mod.global_mesh_if_set() is m
            assert dict(m.shape)["tp"] == 2 and dict(m.shape)["dp"] == 4
            assert mod.global_mesh() is m        # first call wins
            assert mod.axis_size("tp") == 2
            assert mod.mesh_layout() == {"dp": 4, "pp": 1, "tp": 2, "sp": 1,
                                         "ep": 1}
            same = mod.build_mesh(tp=2, devices=devs)
            assert mod.set_global_mesh(same) is same   # same shape: fine
            mod.reset_global_mesh()
            assert mod.global_mesh_if_set() is None

    def test_replacing_with_another_shape_raises(self, jmesh):
        tmesh.set_global_mesh(tmesh.build_mesh(tp=2,
                                               devices=list(range(8))))
        jmesh.set_global_mesh(jmesh.build_mesh(tp=2,
                                               devices=_jax_devices(8)))
        _raises_alike(
            lambda: tmesh.set_global_mesh(tmesh.build_mesh(
                sp=4, devices=list(range(8)))),
            lambda: jmesh.set_global_mesh(jmesh.build_mesh(
                sp=4, devices=_jax_devices(8))))


class TestShardShapes:
    @pytest.mark.parametrize("shape,spec", [
        ((8, 16), P("tp", None)), ((8, 16), P(None, "tp")),
        ((12, 16), P(("dp", "tp"), None)), ((6, 16), P("tp", None)),
        ((8, 16, 4), P("dp", "sp")), ((8,), None), ((8, 16), P())])
    def test_spec_shard_shape(self, jmesh, shape, spec):
        from jax.sharding import PartitionSpec as JP
        jspec = None if spec is None else JP(*spec)
        layout = {"dp": 2, "pp": 1, "tp": 4, "sp": 2, "ep": 1}
        assert tmesh.spec_shard_shape(shape, spec, layout) == \
            jmesh.spec_shard_shape(shape, jspec, layout)
        tm = tmesh.build_mesh(dp=2, tp=2, sp=2, devices=list(range(8)))
        jm = jmesh.build_mesh(dp=2, tp=2, sp=2, devices=_jax_devices(8))
        assert tmesh.spec_shard_shape(shape, spec, tm) == \
            jmesh.spec_shard_shape(shape, jspec, jm)

    @pytest.mark.parametrize("spec", [P("tp", None), P(None, "tp"),
                                      P("dp", "sp"), P(("dp", "tp"), None),
                                      P(None, ("sp", "tp")), P()])
    def test_each_ranks_shard_is_the_block_jax_places(self, jmesh, spec):
        import jax
        from jax.sharding import PartitionSpec as JP
        x = np.arange(16 * 8, dtype=np.float32).reshape(16, 8)
        tm = tmesh.build_mesh(dp=2, tp=2, sp=2, devices=list(range(8)))
        jm = jmesh.build_mesh(dp=2, tp=2, sp=2, devices=_jax_devices(8))
        placed = jax.device_put(x, jmesh.named_sharding(JP(*spec), jm))
        sharding = tmesh.NamedSharding(tm, spec)
        for shard in placed.addressable_shards:
            got = sharding.local_slice(torch.from_numpy(x),
                                       rank=shard.device.id)
            np.testing.assert_array_equal(got.numpy(), np.asarray(shard.data))
        assert sharding.shard_shape(x.shape) == tuple(
            placed.sharding.shard_shape(x.shape))

    def test_placements(self):
        from torch.distributed.tensor import Replicate, Shard
        tm = tmesh.build_mesh(dp=2, tp=2, devices=list(range(4)))
        got = tmesh.NamedSharding(tm, P("dp", "tp")).placements()
        assert got == [Shard(0), Replicate(), Shard(1), Replicate(),
                       Replicate()]
        with pytest.raises(ValueError, match="does not fit"):
            tmesh.NamedSharding(tm, P("xp"))
        with pytest.raises(ValueError, match="does not fit"):
            tmesh.NamedSharding(tm, P("tp", "tp"))

    def test_indivisible_dim_is_refused_on_placement(self):
        tm = tmesh.build_mesh(tp=4, devices=list(range(4)))
        with pytest.raises(ValueError, match="does not divide"):
            tmesh.NamedSharding(tm, P("tp")).local_slice(torch.zeros(6),
                                                         rank=1)


class TestStateMesh:
    def test_worker_mesh_and_axis(self, hvd):
        from horovod_tpu_torch import mpi_ops
        from horovod_tpu_torch.common import state
        from horovod_tpu.common import state as jstate
        mpi_ops.init(device="cpu")
        try:
            m = state.mesh()
            assert m.axis_names == (state.HVD_AXIS,) == (jstate.HVD_AXIS,)
            assert state.hvd_axis_name() == jstate.hvd_axis_name() == "hvd"
            assert m.shape == {"hvd": 1}
            assert state.process_local_rank() == 0
            assert state.process_local_size() == 1
        finally:
            mpi_ops.shutdown()
        with pytest.raises(Exception, match="init"):
            state.mesh()

    def test_process_local_identity_from_env(self, monkeypatch):
        from horovod_tpu_torch import mpi_ops
        from horovod_tpu_torch.common import state
        monkeypatch.setenv("HVD_LOCAL_RANK", "3")
        monkeypatch.setenv("HVD_LOCAL_SIZE", "4")
        mpi_ops.init(device="cpu")
        try:
            assert state.process_local_rank() == 3
            assert state.process_local_size() == 4
        finally:
            mpi_ops.shutdown()

    def test_process_local_identity_is_local_rank_under_torchrun(
            self, monkeypatch):
        """torchrun exports LOCAL_RANK / LOCAL_WORLD_SIZE, not the HVD_
        names: the process-local identity is the card ``local_rank``
        drives, whichever launcher set it."""
        from horovod_tpu_torch import mpi_ops
        from horovod_tpu_torch.common import state
        for name in ("HVD_LOCAL_RANK", "HVD_LOCAL_SIZE"):
            monkeypatch.delenv(name, raising=False)
        monkeypatch.setenv("LOCAL_RANK", "2")
        monkeypatch.setenv("LOCAL_WORLD_SIZE", "4")
        mpi_ops.init(device="cpu")
        try:
            assert state.process_local_rank() == mpi_ops.local_rank() == 2
            assert state.process_local_size() == mpi_ops.local_size() == 4
        finally:
            mpi_ops.shutdown()
        with pytest.raises(Exception, match="init"):
            state.process_local_rank()
