"""horovod_tpu_torch's quantized wire (``ops/quantization.py``, the int8
and fp8 compressors, the two-phase engines and the eager core's
quantized leg) against ``horovod_tpu.ops.quantization``.

The codecs, ``stacked_wire_allreduce`` and ``ErrorFeedback`` are held
bit-equal to the JAX functions on seeded numpy inputs (fp8 payloads
compared as uint8 views: ml_dtypes on the JAX side, float8_e4m3fn on the
port's), over lengths with a pad tail, all-zero blocks and blocks at
exactly +-448. Codec selection, fingerprints and the registry against
the reference's. Two gloo ranks (spawned once, negotiated): the two-phase
allreduce bit-equal to JAX's ``stacked_wire_allreduce``, and three
steps of the eager core's quantized leg with error feedback bit-equal to
JAX's ``encode``/``decode``/``ErrorFeedback`` composed here (the JAX
eager path itself is not the expectation: its quantized test fails in
a full run, ROADMAP §C). Four gloo ranks (spawned once): the two-phase
allreduce within one code step of each output block's scale of JAX's
``stacked_wire_allreduce`` (the f32 sum of four rows depends on its
order), three ranks of them on a bucket that is no multiple of the block
(bit-equal to a rank-ordered composition), and the hierarchical leg (2
hosts x 2) over two steps with its shard-length residual, bit-equal to
a composition of the JAX functions (the reference's own hierarchical leg
raises on ``check_rep`` on this JAX).
"""

import base64
import os
import socket
import traceback

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from horovod_tpu_torch.ops import compression as tcomp
from horovod_tpu_torch.ops import quantization as tq

BLOCK = 256
CODECS = ("int8", "fp8")
JOIN_TIMEOUT_S = 60
# lengths: one element, a partial block, whole blocks, a pad tail over
# several blocks
LENGTHS = (1, 255, 512, 1000, 4097)


def _jq():
    from horovod_tpu.ops import quantization
    return quantization


def _encode_blocks(x, codec):
    """The JAX package's ``_block_encode`` as its collectives run it,
    compiled: the compiler turns ``amax / QMAX`` into a multiply by the
    f32 reciprocal, which op-by-op dispatch does not."""
    import jax
    return jax.jit(_jq()._block_encode, static_argnums=(1, 2))(
        x, BLOCK, codec)


def _rows(seed, world, n):
    """[world, n] f32 rows of mixed magnitudes with an all-zero first
    block in row 0 and a block holding exactly +-448 in row 1."""
    g = np.random.RandomState(seed)
    x = (g.randn(world, n) *
         g.choice([1e-3, 1.0, 50.0], size=(world, 1))).astype(np.float32)
    x[0, :min(n, BLOCK)] = 0.0
    if world > 1 and n > 300:
        x[1, 260], x[1, 261] = 448.0, -448.0
    return x


def _bits(a):
    a = np.ascontiguousarray(a)
    return a.view({1: np.uint8, 2: np.uint16, 4: np.uint32}[a.itemsize])


def _np(t):
    """A payload's bytes as uint8."""
    return t.view(torch.uint8).numpy()


# ---------------------------------------------------------------------------
# codecs on one process


@pytest.mark.parametrize("codec", CODECS)
@pytest.mark.parametrize("n", LENGTHS)
def test_encode_decode_bit_equal(codec, n):
    import jax.numpy as jnp
    jq = _jq()
    x = _rows(n, 3, n)
    for multiple in (None, BLOCK * 3):
        qj, sj = jq.encode(jnp.asarray(x), BLOCK, codec, multiple=multiple)
        qt, st = tq.encode(torch.from_numpy(x), BLOCK, codec,
                           multiple=multiple)
        assert np.array_equal(_bits(np.asarray(qj)), _np(qt))
        assert np.array_equal(_bits(np.asarray(sj)), _bits(st.numpy()))
        dj = np.asarray(jq.decode(qj, sj, BLOCK, n))
        dt = tq.decode(qt, st, BLOCK, n).numpy()
        assert np.array_equal(_bits(dj), _bits(dt))
        assert np.all(np.isfinite(dt))


@pytest.mark.parametrize("codec", CODECS)
@pytest.mark.parametrize("average", [False, True])
@pytest.mark.parametrize("n", (255, 1000))
def test_stacked_wire_allreduce_two_rows_bit_equal(codec, average, n):
    import jax.numpy as jnp
    jq = _jq()
    x = _rows(7, 2, n)
    oj, ej = jq.stacked_wire_allreduce(jnp.asarray(x), BLOCK, codec,
                                       average, n)
    ot, et = tq.stacked_wire_allreduce(torch.from_numpy(x), BLOCK, codec,
                                       average, n)
    assert np.array_equal(_bits(np.asarray(oj)), _bits(ot.numpy()))
    assert np.array_equal(_bits(np.asarray(ej)), _bits(et.numpy()))


def _code_step_bound(x, codec):
    """Per element of the JAX stacked allreduce's output, one code step:
    the requantized sum's block scale."""
    import jax.numpy as jnp
    jq = _jq()
    q, s = jq.encode(jnp.asarray(x), BLOCK, codec)
    total = jnp.sum(jq._block_decode(q, s, BLOCK), axis=0)
    _, s2 = _encode_blocks(total, codec)
    return np.repeat(np.asarray(s2), BLOCK)[:x.shape[1]]


@pytest.mark.parametrize("codec", CODECS)
def test_stacked_wire_allreduce_four_rows_within_a_code_step(codec):
    import jax.numpy as jnp
    jq = _jq()
    x = _rows(8, 4, 4097)
    oj, ej = jq.stacked_wire_allreduce(jnp.asarray(x), BLOCK, codec, False,
                                       4097)
    ot, et = tq.stacked_wire_allreduce(torch.from_numpy(x), BLOCK, codec,
                                       False, 4097)
    assert np.array_equal(_bits(np.asarray(ej)), _bits(et.numpy()))
    bound = _code_step_bound(x, codec)
    assert np.all(np.abs(ot.numpy()[0] - np.asarray(oj)[0]) <=
                  bound * (1 + 2 ** -20))


@pytest.mark.parametrize("codec", CODECS)
def test_error_feedback_three_steps_bit_equal(codec):
    import jax.numpy as jnp
    jq = _jq()
    ej, et = jq.ErrorFeedback(), tq.ErrorFeedback()
    for step in range(3):
        x = _rows(20 + step, 1, 1000)[0]
        cj = ej.compensate("k", jnp.asarray(x))
        ct = et.compensate("k", torch.from_numpy(x))
        assert np.array_equal(_bits(np.asarray(cj, np.float32)),
                              _bits(ct.numpy().astype(np.float32)))
        pj, sj = jq.encode(cj, BLOCK, codec)
        pt, st = tq.encode(ct, BLOCK, codec)
        ej.update("k", cj, jq.decode(pj, sj, BLOCK, 1000), BLOCK)
        et.update("k", ct, tq.decode(pt, st, BLOCK, 1000), BLOCK,
                  anchor="k")
        assert np.array_equal(_bits(np.asarray(ej.peek("k"))),
                              _bits(et.peek("k").numpy()))
    assert et.peek("k", (999,)) is None
    assert float(et.norms["k"]) > 0
    et.reset()
    assert et.peek("k") is None


class _Cfg:
    def __init__(self, **kw):
        self.__dict__.update(kw)


_CONFIGS = [dict(compression=c, quant_block=b, quant_min_bytes=m,
                 quant_ef=ef)
            for c in ("none", "fp16", "bf16", "int8", "fp8", None)
            for b, m, ef in ((256, 1024, True), (128, 0, False))]


@pytest.mark.parametrize("cfg", _CONFIGS,
                         ids=lambda c: "%s-%d-%d" % (c["compression"],
                                                     c["quant_block"],
                                                     c["quant_min_bytes"]))
def test_selection_and_fingerprint_match_the_reference(cfg):
    import jax.numpy as jnp
    jq = _jq()
    config = _Cfg(**cfg)
    assert tq.config_fingerprint(config) == jq.config_fingerprint(config)
    assert tcomp.config_fingerprint(config) == jq.config_fingerprint(config)
    pairs = ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16),
             (torch.float16, jnp.float16), (torch.int32, jnp.int32),
             (torch.float64, jnp.float64))
    for (tdt, jdt) in pairs:
        for nbytes in (0, 1023, 1024, 1 << 20):
            assert tq.select_codec(config, tdt, nbytes) == \
                jq.select_codec(config, jdt, nbytes)
    assert tq.select_codec(config, None, 4096) is None


def test_sizes_and_registry_match_the_reference():
    jq = _jq()
    from horovod_tpu.ops.compression import Compression as JCompression
    for n in (1, 255, 256, 1000):
        assert tq.pad_to(n, 512) == jq.pad_to(n, 512)
        for codec in ("int8", "fp8", "bf16", "fp16"):
            assert tq.encoded_nbytes(n, codec, BLOCK) == \
                jq.encoded_nbytes(n, codec, BLOCK)
    q, s = tq.encode(torch.ones(1000), BLOCK, "int8")
    assert tq.wire_nbytes(q, s) == 1024 + 4 * 4
    assert tcomp.Compression.names() == JCompression.names()
    for name in JCompression.names():
        assert tcomp.Compression.from_name(name).name == \
            JCompression.from_name(name).name
        assert tcomp.Compression.from_name(name.upper()).name == name
    assert tq.wire_dtype("fp8") is torch.float8_e4m3fn
    assert tq.is_quantized("int8") and not tq.is_quantized("bf16")
    assert tq.is_wire("fp16") and not tq.is_wire("none")
    with pytest.raises(ValueError, match="unknown"):
        tcomp.Compression.from_name("int4")


@pytest.mark.parametrize("codec", CODECS)
def test_compressor_is_the_reference_fake_quant(codec):
    import jax.numpy as jnp
    from horovod_tpu.ops.compression import Compression as JCompression
    x = _rows(31, 1, 700)[0].reshape(7, 100)
    jout, _ = JCompression.from_name(codec).compress(jnp.asarray(x))
    tout, ctx = tcomp.Compression.from_name(codec).compress(
        torch.from_numpy(x))
    assert ctx is None and tout.shape == (7, 100)
    assert np.array_equal(_bits(np.asarray(jout)), _bits(tout.numpy()))
    ints = torch.arange(5)
    assert tcomp.Compression.from_name(codec).compress(ints)[0] is ints
    assert tcomp.Compression.from_name(codec).decompress(tout, ctx) is tout


def test_world_one_eager_leg_encodes_and_decodes(monkeypatch):
    """One rank takes the reference's arithmetic at nproc 1: the result is
    the requantized decode of its own contribution, and the tally counts
    the encoded bytes."""
    import jax.numpy as jnp
    from horovod_tpu_torch import mpi_ops
    jq = _jq()
    monkeypatch.setenv("HOROVOD_COMPRESSION", "int8")
    tq.reset_tally()
    mpi_ops.init(device="cpu")
    try:
        x = _rows(40, 1, 1000)[0]
        out = mpi_ops.allreduce(torch.from_numpy(x), average=False)
    finally:
        mpi_ops.shutdown()
    want, _ = jq.stacked_wire_allreduce(jnp.asarray(x[None]), BLOCK, "int8",
                                        False, 1000)
    assert np.array_equal(_bits(out.numpy()), _bits(np.asarray(want)[0]))
    tally = tq.tally()
    assert tally[("hvd_wire_bytes_total", "int8", "dp")] == 1024 + 16
    assert tally[("hvd_wire_raw_bytes_total", "int8", "dp")] == 4000


def test_error_feedback_keeps_one_residual_per_named_bucket(monkeypatch):
    """Unnamed submissions get a new generated name every step, so the
    core keeps no residual for them (none could be read back); named ones
    keep one per bucket, and from the second step on the bucket's input
    is compensated. The eager training step names its gradients, so its
    table holds one residual whatever the number of steps."""
    from horovod_tpu_torch import mpi_ops, optim, trainer
    from horovod_tpu_torch.common import state as state_mod
    monkeypatch.setenv("HOROVOD_COMPRESSION", "int8")
    mpi_ops.init(device="cpu")
    try:
        coord = state_mod.global_state().coordinator
        coord.record_quantized = True
        x = [torch.from_numpy(_rows(60 + i, 1, 700)[0]) for i in range(2)]
        sizes = []
        for _ in range(6):
            mpi_ops.grouped_allreduce(x)
            sizes.append(len(coord._ef))
        assert sizes == [0] * 6
        assert coord.last_quantized["compensated"] is False
        flags = []
        for _ in range(4):
            for h in mpi_ops.grouped_allreduce_async(x, name="w"):
                mpi_ops.synchronize(h)
            sizes.append(len(coord._ef))
            flags.append(coord.last_quantized["compensated"])
        assert sizes[6:] == [1] * 4 and flags == [False, True, True, True]
        coord._ef.reset()
        torch.manual_seed(0)
        model = torch.nn.Linear(64, 32)
        step = trainer.make_eager_step(
            model, optim.SGD(model.parameters(), 0.1),
            lambda m, b: (m(b) ** 2).mean())
        batch = torch.from_numpy(_rows(70, 4, 64))
        for i in range(5):
            step(batch)
            assert len(coord._ef) == 1
        assert coord.last_quantized["compensated"] is True
        assert all(n.startswith("hvd.eager_grads.")
                   for n in coord.last_quantized["names"])
    finally:
        mpi_ops.shutdown()


# ---------------------------------------------------------------------------
# ranks as processes


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _eager_inputs(r, step):
    """Rank r's three gradients of step ``step``: two fuse into one int8
    bucket, the third is under quant_min_bytes and stays full width."""
    g = np.random.RandomState(1000 + 10 * step + r)
    return [g.randn(300).astype(np.float32) * (1 + r),
            g.randn(700).astype(np.float32),
            g.randn(100).astype(np.float32)]


def _pair_jobs(r, world, codec):
    """Two ranks: the flat engine's two-phase sum, then three eager steps
    with error feedback."""
    import torch.distributed as dist
    from horovod_tpu_torch import mpi_ops
    from horovod_tpu_torch.common import state as state_mod
    from horovod_tpu_torch.ops import process_collectives as pc
    out = {}
    x = torch.from_numpy(_rows(50, world, 1000)[r])
    q, s = tq.encode(x, BLOCK, codec, multiple=BLOCK * world)
    eng = pc.ProcessCollectiveEngine(dist.group.WORLD)
    out["two_phase"] = eng.allreduce_quantized(q, s, codec, BLOCK,
                                               average=True)[:1000].numpy()
    coord = state_mod.global_state().coordinator
    out["steps"] = []
    for step in range(3):
        with coord.hold_cycle():
            hs = mpi_ops.grouped_allreduce_async(
                [torch.from_numpy(t) for t in _eager_inputs(r, step)],
                average=True, name="g")
        out["steps"].append([mpi_ops.synchronize(h).numpy() for h in hs])
    out["tally"] = tq.tally()
    out["negotiated"] = coord.negotiated
    return out


def _quad_jobs(r, world, codec):
    """Four ranks: the flat two-phase sum over all four and over ranks
    0-2 on a bucket that is no multiple of the block, then two steps of
    the eager core's hierarchical leg (2 hosts x 2)."""
    import torch.distributed as dist
    from horovod_tpu_torch import mpi_ops
    from horovod_tpu_torch.ops import process_collectives as pc
    out = {}
    x = torch.from_numpy(_rows(60, world, 4097)[r])
    q, s = tq.encode(x, BLOCK, codec, multiple=BLOCK * world)
    eng = pc.ProcessCollectiveEngine(dist.group.WORLD)
    out["four"] = eng.allreduce_quantized(q, s, codec, BLOCK)[:4097].numpy()
    sub = dist.new_group([0, 1, 2])
    if r < 3:
        x3 = torch.from_numpy(_rows(61, 3, 1000)[r])
        q, s = tq.encode(x3, BLOCK, codec, multiple=BLOCK * 3)
        eng3 = pc.ProcessCollectiveEngine(sub)
        out["three"] = eng3.allreduce_quantized(q, s, codec,
                                                BLOCK)[:1000].numpy()
    out["hier"] = [mpi_ops.allreduce(
        torch.from_numpy(_rows(70 + step, world, 1000)[r]), average=True,
        name="h").numpy() for step in range(2)]
    out["tally"] = tq.tally()
    return out


def _worker(r, world, port, cport, codec, job, results):
    torch.set_num_threads(1)
    os.environ["HOROVOD_COMPRESSION"] = codec
    if cport is not None:
        os.environ["HVD_CONTROL_ADDR"] = f"localhost:{cport}"
        os.environ["HVD_SECRET_KEY"] = base64.b64encode(b"q" * 32).decode()
    else:
        os.environ["HOROVOD_HIERARCHICAL_ALLREDUCE"] = "1"
        os.environ["HVD_LOCAL_SIZE"] = "2"
    from horovod_tpu_torch import mpi_ops
    report = {}
    try:
        mpi_ops.init(device="cpu", rank=r, size=world,
                     init_method=f"tcp://localhost:{port}")
        report = globals()[job](r, world, codec)
        mpi_ops.shutdown()
    except Exception:  # noqa: BLE001 — reported to the parent
        report = {"error": traceback.format_exc()}
    results.put((r, report))


def _spawn(world, job, codec, negotiated):
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    port = _free_port()
    cport = _free_port() if negotiated else None
    procs = [ctx.Process(target=_worker, args=(r, world, port, cport, codec,
                                               job, results))
             for r in range(world)]
    for p in procs:
        p.start()
    got = {}
    try:
        for _ in range(world):
            r, report = results.get(timeout=JOIN_TIMEOUT_S)
            got[r] = report
    finally:
        for p in procs:
            p.join(timeout=20)
            if p.is_alive():
                p.terminate()
                p.join(timeout=10)
    for r in range(world):
        assert "error" not in got[r], f"rank {r}:\n{got[r]['error']}"
    return got


@pytest.fixture(scope="module")
def pair():
    """Two negotiated gloo ranks under int8, then fp8's two-phase sum is
    the same code path (its bits are held above)."""
    return _spawn(2, "_pair_jobs", "int8", negotiated=True)


@pytest.fixture(scope="module")
def quad():
    return _spawn(4, "_quad_jobs", "fp8", negotiated=False)


def test_two_ranks_two_phase_equals_stacked_wire_allreduce(pair):
    import jax.numpy as jnp
    jq = _jq()
    x = _rows(50, 2, 1000)
    want, _ = jq.stacked_wire_allreduce(jnp.asarray(x), BLOCK, "int8", True,
                                        1000)
    for r in range(2):
        assert np.array_equal(_bits(pair[r]["two_phase"]),
                              _bits(np.asarray(want)[r]))


def test_eager_quantized_leg_with_error_feedback(pair):
    """Three steps: the int8 bucket (members 0 and 1, fused in submission
    order) equals JAX's encode -> sum of decodes -> requant -> decode,
    each rank compensated by its own ErrorFeedback; member 2 is under
    quant_min_bytes and sums at full width."""
    import jax.numpy as jnp
    jq = _jq()
    efs = [jq.ErrorFeedback() for _ in range(2)]
    key = "g.0|g.1"
    for step in range(3):
        ins = [_eager_inputs(r, step) for r in range(2)]
        decs, comps, pays = [], [], []
        for r in range(2):
            fused = jnp.asarray(np.concatenate(ins[r][:2]))
            comp = efs[r].compensate(key, fused)
            p, s = jq.encode(comp, BLOCK, "int8", multiple=BLOCK * 2)
            decs.append(jq._block_decode(p, s, BLOCK))
            comps.append(comp)
            pays.append((p, s))
        q2, s2 = _encode_blocks(decs[0] + decs[1], "int8")
        want = np.asarray(jq._block_decode(q2, s2, BLOCK))[:1000] / 2
        for r in range(2):
            efs[r].update(key, comps[r], jq.decode(*pays[r], BLOCK, 1000),
                          BLOCK)
            got = pair[r]["steps"][step]
            assert np.array_equal(_bits(np.concatenate(got[:2])),
                                  _bits(want.astype(np.float32)))
            full = (ins[0][2] + ins[1][2]) / 2
            np.testing.assert_array_equal(got[2], full)


def test_eager_wire_bytes_are_counted(pair):
    tally = pair[0]["tally"]
    assert pair[0]["negotiated"] is True
    # three steps of one 1000-element int8 bucket padded to 1024
    assert tally[("hvd_wire_bytes_total", "int8", "dp")] == 3 * (1024 + 16)
    assert tally[("hvd_wire_raw_bytes_total", "int8", "dp")] == 3 * 4000
    assert tally[("hvd_wire_bytes_total", "none", "dp")] >= 3 * 400


def test_four_ranks_within_a_code_step(quad):
    import jax.numpy as jnp
    jq = _jq()
    x = _rows(60, 4, 4097)
    want, _ = jq.stacked_wire_allreduce(jnp.asarray(x), BLOCK, "fp8", False,
                                        4097)
    bound = _code_step_bound(x, "fp8") * (1 + 2 ** -20)
    for r in range(4):
        assert np.all(np.abs(quad[r]["four"] - np.asarray(want)[0]) <= bound)
        np.testing.assert_array_equal(quad[r]["four"], quad[0]["four"])


def test_three_ranks_on_a_ragged_bucket(quad):
    """A world of 3 and 1000 elements: encode pads to block · 3 so chunk
    boundaries land on block boundaries; the sum is rank-ordered."""
    import jax.numpy as jnp
    jq = _jq()
    x = _rows(61, 3, 1000)
    q, s = jq.encode(jnp.asarray(x), BLOCK, "fp8", multiple=BLOCK * 3)
    dec = np.asarray(jq._block_decode(q, s, BLOCK))
    total = (dec[0] + dec[1]) + dec[2]
    q2, s2 = _encode_blocks(jnp.asarray(total), "fp8")
    want = np.asarray(jq._block_decode(q2, s2, BLOCK))[:1000]
    for r in range(3):
        assert np.array_equal(_bits(quad[r]["three"]), _bits(want))


def test_hierarchical_leg_two_hosts_of_two(quad):
    """Two steps of the eager core's two-level quantized leg: a full-width
    reduce-scatter within each host, the shard (plus its residual)
    encoded across hosts, a full-width gather; the residual lives at
    shard length."""
    import jax.numpy as jnp
    jq = _jq()
    m, local, hosts = 1024, 2, 2
    shard = m // local
    efs = [jq.ErrorFeedback() for _ in range(4)]
    for step in range(2):
        x = np.zeros((4, m), np.float32)
        x[:, :1000] = _rows(70 + step, 4, 1000)
        parts = []
        for pos in range(local):
            comps = []
            for h in range(hosts):
                ranks = [h * local + j for j in range(local)]
                sh = x[ranks[0], pos * shard:(pos + 1) * shard] + \
                    x[ranks[1], pos * shard:(pos + 1) * shard]
                comps.append(efs[h * local + pos].compensate(
                    "h#hier", jnp.asarray(sh)))
            red, dec_own = jq.stacked_wire_allreduce(
                jnp.stack(comps), BLOCK, "fp8", False, shard)
            for h in range(hosts):
                efs[h * local + pos].update("h#hier", comps[h], dec_own[h],
                                            BLOCK)
            parts.append(np.asarray(red)[0])
        want = (np.concatenate(parts) / 4)[:1000]
        for r in range(4):
            assert np.array_equal(_bits(quad[r]["hier"][step]), _bits(want))
    tally = quad[0]["tally"]
    assert tally[("hvd_wire_leg_bytes_total", "inter", "fp8")] == \
        2 * (shard + shard // BLOCK * 4)
    assert tally[("hvd_wire_leg_bytes_total", "intra", "none")] == 2 * 4000
