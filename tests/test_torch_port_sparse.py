"""horovod_tpu_torch's sparse path (``ops/sparse.py``, its routing in
``mpi_ops`` and ``optim``, and ``word2vec``) against
``horovod_tpu.ops.sparse`` and ``examples/word2vec.py``.

On one process: ``to_dense``/``from_dense`` against the JAX functions
(duplicate indices accumulate; exact on integer-valued floats, 1e-6 of
the largest magnitude on random ones, whose duplicate sums may round in
another order), the COO conversions, and one ``word2vec`` step (its
batch, loss, row gradients and scatter-add update) against the JAX
example's ``loss_fn`` and update at vocab 50, dim 8, within 1e-6 of each
table's largest magnitude. Two gloo ranks, spawned once and negotiated:
a sparse allreduce with unequal nnz (the union of both ranks' rows,
values halved) whose ``to_dense`` equals the dense average of the
densified gradients (1e-6); a grouped one of three slices whose six
gathers the coordinator fuses into two allgatherv groups;
``allreduce_gradients`` with and without ``sparse_as_dense``; and an
``nn.Embedding(sparse=True)`` through ``DistributedOptimizer(SGD)``,
whose gradient comes back sparse and whose weights equal the dense
data-parallel update (1e-6).
"""

import base64
import os
import socket
import traceback

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from horovod_tpu_torch.ops import sparse as tsparse

WORLD = 2
JOIN_TIMEOUT_S = 60
VOCAB, DIM = 12, 4
TOL = 1e-6


def _slices(r, nnz, seed):
    g = np.random.RandomState(seed + r)
    idx = g.randint(0, VOCAB, nnz).astype(np.int64)
    return g.randn(nnz, DIM).astype(np.float32), idx


def _dense(values, idx):
    out = np.zeros((VOCAB, DIM), np.float32)
    np.add.at(out, idx, values)
    return out


def test_to_dense_from_dense_match_the_reference():
    import jax.numpy as jnp
    from horovod_tpu.ops import sparse as jsparse
    idx = np.array([3, 1, 3, 7, 1, 3])
    for values in (np.arange(24, dtype=np.float32).reshape(6, 4),
                   np.random.RandomState(0).randn(6, 4).astype(np.float32)):
        want = np.asarray(jsparse.to_dense(jsparse.IndexedSlices(
            jnp.asarray(values), jnp.asarray(idx), (VOCAB, DIM))))
        got = tsparse.to_dense(tsparse.IndexedSlices(
            torch.from_numpy(values), torch.from_numpy(idx), (VOCAB, DIM)))
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=TOL * np.abs(want).max())
    dense = np.random.RandomState(1).randn(VOCAB, DIM).astype(np.float32)
    j = jsparse.from_dense(jnp.asarray(dense), [2, 5])
    t = tsparse.from_dense(torch.from_numpy(dense), [2, 5])
    assert t.dense_shape == tuple(j.dense_shape)
    np.testing.assert_array_equal(t.values.numpy(), np.asarray(j.values))
    assert tsparse.is_indexed_slices(t) and not tsparse.is_indexed_slices(
        dense)
    assert "dense_shape=(12, 4)" in repr(t)


def test_coo_round_trip():
    emb = torch.nn.Embedding(VOCAB, DIM, sparse=True)
    emb(torch.tensor([1, 4, 1])).sum().backward()
    grad = emb.weight.grad
    assert tsparse.is_sparse_coo(grad)
    s = tsparse.from_coo(grad)
    assert s.values.shape == (3, DIM) and s.dense_shape == (VOCAB, DIM)
    back = tsparse.to_coo(s)
    torch.testing.assert_close(back.to_dense(), grad.to_dense(), rtol=0,
                               atol=0)
    with pytest.raises(ValueError, match="first dim"):
        tsparse.from_coo(torch.eye(3).to_sparse())


def test_word2vec_step_matches_the_jax_example():
    """One step of the port's word2vec on one process against the JAX
    example's loss and update (its sparse allreduce is the identity at
    one process)."""
    import jax
    import jax.numpy as jnp
    from horovod_tpu_torch import mpi_ops, word2vec
    from horovod_tpu_torch.ops.sparse import sparse_allreduce
    vocab, dim, b, k = 50, 8, 16, 4
    corpus = word2vec.make_corpus(vocab, 2000, 1)
    rng = np.random.RandomState(1)
    centers, contexts = word2vec.skipgram_batches(corpus, 2, b, rng)
    negs = rng.randint(0, vocab, (b, k))
    emb, ctx = word2vec.init_tables(vocab, dim, 1, "cpu")
    ctx += torch.from_numpy(np.random.RandomState(2).uniform(
        -0.1, 0.1, (vocab, dim)).astype(np.float32))
    emb0, ctx0 = emb.numpy().copy(), ctx.numpy().copy()
    mpi_ops.init(device="cpu")
    try:
        loss, slices = word2vec.sparse_grads(
            emb, ctx, torch.from_numpy(centers).long(),
            torch.from_numpy(contexts).long(), torch.from_numpy(negs))
        reduced = [sparse_allreduce(s) for s in slices]
        word2vec.apply(emb, ctx, reduced, 0.5)
    finally:
        mpi_ops.shutdown()

    def loss_fn(c_rows, pos_rows, neg_rows):   # examples/word2vec.py
        pos_logit = jnp.sum(c_rows * pos_rows, -1)
        neg_logit = jnp.einsum("bd,bkd->bk", c_rows, neg_rows)
        return (-jnp.mean(jax.nn.log_sigmoid(pos_logit))
                - jnp.mean(jnp.sum(jax.nn.log_sigmoid(-neg_logit), -1)))
    je, jc = jnp.asarray(emb0), jnp.asarray(ctx0)
    jloss, (g_c, g_pos, g_neg) = jax.value_and_grad(
        loss_fn, argnums=(0, 1, 2))(je[centers], jc[contexts], jc[negs])
    je = je.at[centers].add(-0.5 * g_c)
    jc = jc.at[contexts].add(-0.5 * g_pos)
    jc = jc.at[negs.reshape(-1)].add(-0.5 * g_neg.reshape(b * k, -1))
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=TOL)
    for got, want in ((emb, je), (ctx, jc)):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=TOL * np.abs(want).max())


# ---------------------------------------------------------------------------
# two ranks


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _jobs(r):
    from horovod_tpu_torch import mpi_ops, optim
    from horovod_tpu_torch.common import state as state_mod
    coord = state_mod.global_state().coordinator
    out = {}
    # unequal nnz: rank 0 contributes 3 rows, rank 1 five
    v, i = _slices(r, 3 + 2 * r, 10)
    red = mpi_ops.allreduce(tsparse.IndexedSlices(
        torch.from_numpy(v), torch.from_numpy(i), (VOCAB, DIM)),
        name="uneq")
    out["uneq"] = (red.values.numpy(), red.indices.numpy(),
                   tsparse.to_dense(red).numpy())
    # three slices, six gathers, two fused allgatherv groups
    group = [tsparse.IndexedSlices(*map(torch.from_numpy,
                                        _slices(r, 4 + j, 20 + 5 * j)),
                                   (VOCAB, DIM)) for j in range(3)]
    before = coord.executed_ops["allgather"]
    reduced = tsparse.grouped_sparse_allreduce(group, name="grp")
    out["groups"] = coord.executed_ops["allgather"] - before
    out["grouped"] = [tsparse.to_dense(s).numpy() for s in reduced]
    # allreduce_gradients: a dense leaf, a slices leaf and a COO leaf
    tree = {"w": torch.full((3,), float(r + 1)), "s": group[0],
            "c": tsparse.to_coo(group[1])}
    for as_dense in (False, True):
        got = optim.allreduce_gradients(tree, sparse_as_dense=as_dense)
        out[f"tree{int(as_dense)}"] = {
            "w": got["w"].numpy(),
            "s_kind": type(got["s"]).__name__,
            "s": (tsparse.to_dense(got["s"]) if not as_dense
                  else got["s"]).numpy(),
            "c_sparse": got["c"].is_sparse,
            "c": got["c"].to_dense().numpy()}
    # nn.Embedding(sparse=True) through DistributedOptimizer(SGD)
    torch.manual_seed(0)
    emb = torch.nn.Embedding(VOCAB, DIM, sparse=True)
    opt = optim.DistributedOptimizer(torch.optim.SGD(emb.parameters(),
                                                     lr=0.5))
    ids = torch.from_numpy(_slices(r, 6, 40)[1])
    (emb(ids) ** 2).sum().backward()
    opt.step()
    out["emb_grad_sparse"] = emb.weight.grad.is_sparse
    out["emb"] = emb.weight.detach().numpy()
    # a dp subgroup (each rank alone, as under tp 2) and a process group
    # of both ranks: the sparse leaves reduce over the group, not over
    # every worker through the eager core
    import torch.distributed as dist
    alone = [dist.new_group([0]), dist.new_group([1])][r]
    both = dist.new_group([0, 1])
    for key, grp in (("alone", alone), ("both", both)):
        got = optim.allreduce_gradients(
            {"s": group[0], "c": tsparse.to_coo(group[1])}, axis_name=grp)
        out[f"{key}_tree"] = {"s": tsparse.to_dense(got["s"]).numpy(),
                              "c": got["c"].to_dense().numpy()}
        torch.manual_seed(0)
        emb = torch.nn.Embedding(VOCAB, DIM, sparse=True)
        opt = optim.DistributedOptimizer(
            torch.optim.SGD(emb.parameters(), lr=0.5), process_group=grp)
        (emb(ids) ** 2).sum().backward()
        opt.step()
        out[f"{key}_emb"] = emb.weight.detach().numpy()
    uneq = mpi_ops.allreduce(tsparse.IndexedSlices(
        torch.from_numpy(v), torch.from_numpy(i), (VOCAB, DIM)))
    red = tsparse.sparse_allreduce(tsparse.IndexedSlices(
        torch.from_numpy(v), torch.from_numpy(i), (VOCAB, DIM)),
        axis_name=both)
    out["uneq_group"] = (red.values.numpy(), red.indices.numpy(),
                         uneq.values.numpy(), uneq.indices.numpy())
    out["negotiated"] = coord.negotiated
    return out


def _worker(r, port, cport, results):
    torch.set_num_threads(1)
    os.environ["HVD_CONTROL_ADDR"] = f"localhost:{cport}"
    os.environ["HVD_SECRET_KEY"] = base64.b64encode(b"s" * 32).decode()
    from horovod_tpu_torch import mpi_ops
    try:
        mpi_ops.init(device="cpu", rank=r, size=WORLD,
                     init_method=f"tcp://localhost:{port}")
        report = _jobs(r)
        mpi_ops.shutdown()
    except Exception:  # noqa: BLE001 — reported to the parent
        report = {"error": traceback.format_exc()}
    results.put((r, report))


@pytest.fixture(scope="module")
def pair():
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    port, cport = _free_port(), _free_port()
    procs = [ctx.Process(target=_worker, args=(r, port, cport, results))
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
            p.join(timeout=20)
            if p.is_alive():
                p.terminate()
                p.join(timeout=10)
    for r in range(WORLD):
        assert "error" not in got[r], f"rank {r}:\n{got[r]['error']}"
        assert got[r]["negotiated"] is True
    return got


def _close(got, want):
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=TOL * max(np.abs(want).max(), 1.0))


def test_unequal_nnz_is_the_union_and_the_dense_average(pair):
    rows = [_slices(r, 3 + 2 * r, 10) for r in range(WORLD)]
    want_dense = sum(_dense(v, i) for v, i in rows) / WORLD
    for r in range(WORLD):
        values, indices, dense = pair[r]["uneq"]
        np.testing.assert_array_equal(indices, np.concatenate(
            [i for _, i in rows]))
        np.testing.assert_array_equal(values, np.concatenate(
            [v for v, _ in rows]) / WORLD)
        _close(dense, want_dense)


def test_grouped_fuses_six_gathers_into_two(pair):
    for r in range(WORLD):
        assert pair[r]["groups"] == 2
        for j in range(3):
            want = sum(_dense(*_slices(q, 4 + j, 20 + 5 * j))
                       for q in range(WORLD)) / WORLD
            _close(pair[r]["grouped"][j], want)


@pytest.mark.parametrize("as_dense", [0, 1])
def test_allreduce_gradients_sparse_and_as_dense(pair, as_dense):
    want_s = sum(_dense(*_slices(q, 4, 20)) for q in range(WORLD)) / WORLD
    want_c = sum(_dense(*_slices(q, 5, 25)) for q in range(WORLD)) / WORLD
    for r in range(WORLD):
        got = pair[r][f"tree{as_dense}"]
        np.testing.assert_array_equal(got["w"], np.full(3, 1.5, np.float32))
        assert got["s_kind"] == ("Tensor" if as_dense else "IndexedSlices")
        assert got["c_sparse"] is (not as_dense)
        _close(got["s"], want_s)
        _close(got["c"], want_c)


def _emb_grad(q, w0):
    ids = _slices(q, 6, 40)[1]
    g = np.zeros_like(w0)
    np.add.at(g, ids, 2 * w0[ids])
    return g


def test_sparse_embedding_through_distributed_optimizer(pair):
    torch.manual_seed(0)
    w0 = torch.nn.Embedding(VOCAB, DIM).weight.detach().numpy()
    grad = sum(_emb_grad(q, w0) for q in range(WORLD)) / WORLD
    want = w0 - 0.5 * grad
    for r in range(WORLD):
        assert pair[r]["emb_grad_sparse"] is True
        _close(pair[r]["emb"], want)
        _close(pair[r]["both_emb"], want)


def test_sparse_leaves_reduce_over_the_callers_group(pair):
    """A dp subgroup of one rank leaves each rank's sparse gradient its
    own (it was averaged over both ranks before); a process group of both
    ranks averages over both, on the group's own gathers."""
    torch.manual_seed(0)
    w0 = torch.nn.Embedding(VOCAB, DIM).weight.detach().numpy()
    for r in range(WORLD):
        _close(pair[r]["alone_tree"]["s"], _dense(*_slices(r, 4, 20)))
        _close(pair[r]["alone_tree"]["c"], _dense(*_slices(r, 5, 25)))
        _close(pair[r]["alone_emb"], w0 - 0.5 * _emb_grad(r, w0))
        for leaf, (k, seed) in (("s", (4, 20)), ("c", (5, 25))):
            want = sum(_dense(*_slices(q, k, seed))
                       for q in range(WORLD)) / WORLD
            _close(pair[r]["both_tree"][leaf], want)
        values, indices, e_values, e_indices = pair[r]["uneq_group"]
        np.testing.assert_array_equal(indices, e_indices)
        np.testing.assert_array_equal(values, e_values)
