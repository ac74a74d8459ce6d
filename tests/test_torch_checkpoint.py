"""The port's BlobSeer checkpointer: the reference's cases, and exchange.

The cases of ``tests/test_checkpoint.py`` run on the port's own copy of
the BlobSeer client with torch states on the CPU (where the delta scan
runs the plain digest and mask).  Then the two packages are held to one
format: for the same converted state the port writes the reference's
manifest, and a checkpoint written by either package, spooled to disk
with its version-manager WAL, is recovered by the other package's
``BlobSeerService.restore`` and restored bit for bit.
"""

import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro.checkpoint import BlobCheckpointer as JBlobCheckpointer
from repro.configs import get_config as jget_config
from repro.core import BlobSeerService as JBlobSeerService
from repro.distributed.axes import clear_logical_rules
from repro.models import build_model as jbuild_model
from repro.train.optimizer import adamw_init as jadamw_init
from repro_torch.checkpoint import BlobCheckpointer
from repro_torch.checkpoint.blobckpt import flatten_with_paths
from repro_torch.configs import get_config
from repro_torch.convert import state_from_jax
from repro_torch.core import BlobSeerService, collect_garbage
from repro_torch.data import ByteTokenizer, CorpusWriter, ShardedReader
from repro_torch.kernels import ops

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def _no_leaked_axis_rules():
    # an earlier test in this worker may leave logical-axis rules active,
    # which makes every JAX ``constrain`` call raise
    clear_logical_rules()


@pytest.fixture
def ckpt_env():
    svc = BlobSeerService(n_providers=6, n_meta_shards=4)
    return svc, svc.client()


def _state(seed=0, scale=1.0):
    w = np.random.default_rng(seed).standard_normal(600).astype(np.float32)
    return {
        "params": {"w": torch.from_numpy(scale * w),
                   "frozen": torch.ones(256, dtype=torch.float32)},
        "step": torch.tensor(seed, dtype=torch.int32),
    }


def _assert_same(got, want):
    g, w = flatten_with_paths(got), flatten_with_paths(want)
    assert [k for k, _ in g] == [k for k, _ in w]
    for (k, a), (_, b) in zip(g, w):
        assert a.dtype == b.dtype and a.shape == b.shape, k
        assert torch.equal(a, b), k


def test_save_restore_roundtrip(ckpt_env):
    svc, c = ckpt_env
    ck = BlobCheckpointer(c, psize=256, header_pages=8)
    s = _state(1)
    stats = ck.save(s, step=1)
    assert stats.version >= 1
    _assert_same(ck.restore(s, device="cpu"), s)


def test_incremental_save_shares_unchanged_pages(ckpt_env):
    svc, c = ckpt_env
    ck = BlobCheckpointer(c, psize=256, header_pages=8)
    s1 = _state(1)
    st1 = ck.save(s1, step=1)
    s2 = dict(s1, step=torch.tensor(2, dtype=torch.int32))  # only 'step' changes
    ops.reset_launch_counts()
    st2 = ck.save(s2, step=2)
    assert st2.pages_written < st1.pages_total // 4
    assert st2.sharing_fraction > 0.5
    assert ops.launch_counts()["page_digest"] == 0   # the CPU runs the plain versions


def test_old_checkpoints_remain_readable(ckpt_env):
    svc, c = ckpt_env
    ck = BlobCheckpointer(c, psize=256, header_pages=8)
    versions = {}
    for step in range(1, 4):
        s = _state(step, scale=float(step))
        versions[step] = (ck.save(s, step=step).version, s)
    for step, (v, want) in versions.items():
        got, mani = ck.restore(want, version=v, with_manifest=True, device="cpu")
        assert mani["step"] == step
        _assert_same(got, want)


def test_branch_forks_lineage(ckpt_env):
    svc, c = ckpt_env
    ck = BlobCheckpointer(c, psize=256, header_pages=8)
    st1 = ck.save(_state(1), step=1)
    child = ck.branch(st1.version)
    sb = _state(9, scale=3.0)
    child.save(sb, step=9)
    s2 = _state(2, scale=2.0)
    ck.save(s2, step=2)
    _assert_same(child.restore(sb, device="cpu"), sb)
    _assert_same(ck.restore(s2, device="cpu"), s2)
    assert [s for _, s in ck.steps()] == [1, 2]


def test_reader_mid_save_sees_consistent_checkpoint(ckpt_env):
    """GET_RECENT during a save never yields a torn checkpoint."""
    svc, c = ckpt_env
    ck = BlobCheckpointer(c, psize=128, header_pages=8)
    like = _state(0)
    ck.save(_state(1, scale=1.0), step=1)
    errs = []
    stop = threading.Event()

    def reader():
        rck = BlobCheckpointer(svc.client("reader"), ck.blob_id, header_pages=8)
        while not stop.is_set():
            try:
                got, mani = rck.restore(like, with_manifest=True, device="cpu")
                want = _state(mani["step"], scale=float(mani["step"]))
                if not torch.equal(got["params"]["w"], want["params"]["w"]):
                    errs.append(f"torn checkpoint at step {mani['step']}")
            except Exception as e:
                errs.append(repr(e))

    t = threading.Thread(target=reader)
    t.start()
    try:
        for step in range(2, 6):
            ck.save(_state(step, scale=float(step)), step=step)
    finally:
        stop.set()
        t.join(timeout=60)
    assert not t.is_alive()
    assert not errs, errs[:3]


def test_restart_resumes_delta_detection(ckpt_env):
    svc, c = ckpt_env
    ck = BlobCheckpointer(c, psize=256, header_pages=8)
    s = _state(1)
    ck.save(s, step=1)
    ck2 = BlobCheckpointer(c, ck.blob_id, header_pages=8)
    ck2.load_digest_cache()
    assert ck2.save(s, step=2).pages_written == 0       # identical content


def test_manifest_carries_extra_state(ckpt_env):
    svc, c = ckpt_env
    ck = BlobCheckpointer(c, psize=256, header_pages=8)
    ck.save(_state(1), step=1, extra={"reader": {"version": 3, "position": 77,
                                                 "shard": 0, "n_shards": 2}})
    _, mani = ck.restore(_state(1), with_manifest=True, device="cpu")
    assert mani["extra"]["reader"]["position"] == 77


def test_pipeline_reader_deterministic_resume(ckpt_env):
    svc, c = ckpt_env
    w = CorpusWriter(c, psize=128)
    tok = ByteTokenizer()
    for i in range(30):
        w.append_tokens(tok.encode(f"doc {i} " + "lorem ipsum " * (i % 7 + 1)))
    r = ShardedReader(c, w.blob_id, batch=2, seq_len=16)
    r.next_batch()
    st = r.state_dict()
    want = [r.next_batch() for _ in range(3)]
    r2 = ShardedReader(c, w.blob_id, batch=2, seq_len=16, state=st)
    for (a1, b1), (a2, b2) in zip(want, [r2.next_batch() for _ in range(3)]):
        np.testing.assert_array_equal(a1, a2)
        np.testing.assert_array_equal(b1, b2)


def test_concurrent_ingestion_does_not_disturb_pinned_reader(ckpt_env):
    svc, c = ckpt_env
    w = CorpusWriter(c, psize=128)
    tok = ByteTokenizer()
    for i in range(20):
        w.append_tokens(tok.encode(f"base doc {i} " + "abc " * 20))
    r = ShardedReader(c, w.blob_id, batch=2, seq_len=8)
    pinned = r.state.version
    first = r.next_batch()
    stop = threading.Event()

    def ingest():
        cw = CorpusWriter(svc.client("ingest"), w.blob_id)
        i = 0
        while not stop.is_set():
            cw.append_tokens(tok.encode(f"new doc {i}"))
            i += 1

    t = threading.Thread(target=ingest)
    t.start()
    try:
        again = ShardedReader(c, w.blob_id, batch=2, seq_len=8,
                              state=dict(version=pinned, position=0, shard=0,
                                         n_shards=1)).next_batch()
    finally:
        stop.set()
        t.join(timeout=60)
    assert not t.is_alive()
    np.testing.assert_array_equal(first[0], again[0])


def test_rolling_pin_taken_before_commit_survives_gc_race(ckpt_env):
    """A keep-last-1 GC round after every write RPC of save() cannot
    retire the manifest of a just-committed checkpoint."""
    svc, c = ckpt_env
    ck = BlobCheckpointer(c, psize=256, header_pages=8)
    c.set_retention(ck.blob_id, keep_last=1)
    orig_write = c.write

    def write_then_gc(bid, buf, off):
        v = orig_write(bid, buf, off)
        collect_garbage(svc, orphan_grace=None)
        return v

    c.write = write_then_gc
    try:
        s = _state(1)
        ck.save(s, step=1)
        _assert_same(ck.restore(s, device="cpu"), s)
        s2 = dict(s, step=torch.tensor(2, dtype=torch.int32))
        ck.save(s2, step=2)
        assert int(ck.restore(s2, device="cpu")["step"]) == 2
    finally:
        c.write = orig_write


def test_failed_commit_releases_fresh_pin(ckpt_env):
    svc, c = ckpt_env
    ck = BlobCheckpointer(c, psize=256, header_pages=8)
    ck.save(_state(1), step=1)
    base = len(svc.vm.pins())
    orig_write = c.write

    def fail_commit(bid, buf, off):
        if off == 0 and len(buf) == 9:  # the commit-pointer record
            raise RuntimeError("injected commit failure")
        return orig_write(bid, buf, off)

    c.write = fail_commit
    try:
        with pytest.raises(RuntimeError):
            ck.save(_state(2, scale=2.0), step=2)
    finally:
        c.write = orig_write
    assert len(svc.vm.pins()) == base  # no orphan lease
    ck.save(_state(3, scale=3.0), step=3)
    assert len(svc.vm.pins()) == base


# ------------------------------------------------------------ both packages
PSIZE, HEADER_PAGES = 4096, 16


def _jax_state():
    """A reduced olmo-1b train state from the JAX init, numpy leaves: bf16
    params (the dtype of the full-size model), fp32 optimizer, int32
    count and step."""
    cfg = jget_config("olmo-1b").reduced(vocab_size=ByteTokenizer().vocab_size + 1)
    model = jbuild_model(cfg)
    params = jax.jit(lambda r: model.init(r)[0])(jax.random.PRNGKey(0))
    opt = jadamw_init(params)
    opt["count"] = jnp.asarray(3, jnp.int32)
    opt["mu"] = jax.tree.map(lambda m: m + 0.25, opt["mu"])
    params = jax.tree.map(lambda p: p.astype(jnp.bfloat16), params)
    state = {"params": params, "opt": opt, "step": jnp.asarray(3, jnp.int32)}
    return jax.tree.map(np.asarray, state), get_config("olmo-1b").reduced(
        vocab_size=ByteTokenizer().vocab_size + 1)


def _changed(np_state):
    """The state one step later: step, count and one moment changed."""
    out = jax.tree.map(np.copy, np_state)
    out["step"] = np.asarray(4, np.int32)
    out["opt"]["count"] = np.asarray(4, np.int32)
    out["opt"]["mu"]["embed"]["table"][:3] += 1.0
    return out


def _like(np_state):
    return jax.tree.map(lambda a: jax.ShapeDtypeStruct(a.shape, a.dtype), np_state)


def test_manifest_equals_reference_for_converted_state():
    np_state, cfg = _jax_state()
    extra = {"reader": {"version": 2, "position": 64, "shard": 0, "n_shards": 1}}
    jck = JBlobCheckpointer(JBlobSeerService(n_providers=4, n_meta_shards=2).client(),
                            psize=PSIZE, header_pages=HEADER_PAGES)
    tck = BlobCheckpointer(BlobSeerService(n_providers=4, n_meta_shards=2).client(),
                           psize=PSIZE, header_pages=HEADER_PAGES)
    for state in (np_state, _changed(np_state)):
        jst = jck.save(jax.tree.map(jnp.asarray, state), step=int(state["step"]), extra=extra)
        tst = tck.save(state_from_jax(state, cfg, device="cpu"), step=int(state["step"]),
                       extra=extra)
        assert (tst.pages_total, tst.pages_written, tst.written_bytes, tst.total_bytes) == \
            (jst.pages_total, jst.pages_written, jst.written_bytes, jst.total_bytes)
        jm, tm = jck.read_manifest()[0], tck.read_manifest()[0]
        assert {l["dtype"] for l in tm["leaves"]} == {"bfloat16", "float32", "int32"}
        assert tm == jm


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_checkpoint_exchanges_between_packages(writer, tmp_path):
    np_state, cfg = _jax_state()
    spool, wal = str(tmp_path / "spool"), str(tmp_path / "vm.wal")
    kw = dict(n_providers=4, n_meta_shards=2)
    states = [np_state, _changed(np_state)]
    if writer == "jax":
        ck = JBlobCheckpointer(JBlobSeerService(spool_dir=spool, wal_path=wal, **kw).client(),
                               psize=PSIZE, header_pages=HEADER_PAGES)
        for s in states:
            ck.save(jax.tree.map(jnp.asarray, s), step=int(s["step"]))
        rck = BlobCheckpointer(BlobSeerService.restore(spool, wal, **kw).client(), ck.blob_id,
                               header_pages=HEADER_PAGES)
        got = rck.restore(state_from_jax(np_state, cfg, device="meta"), device="cpu")
        _assert_same(got, state_from_jax(states[-1], cfg, device="cpu"))
        assert [s for _, s in rck.steps()] == [3, 4]
    else:
        ck = BlobCheckpointer(BlobSeerService(spool_dir=spool, wal_path=wal, **kw).client(),
                              psize=PSIZE, header_pages=HEADER_PAGES)
        for s in states:
            ck.save(state_from_jax(s, cfg, device="cpu"), step=int(s["step"]))
        rck = JBlobCheckpointer(JBlobSeerService.restore(spool, wal, **kw).client(),
                                ck.blob_id, header_pages=HEADER_PAGES)
        got = rck.restore(_like(np_state))
        want = jax.tree_util.tree_leaves_with_path(states[-1])
        for (path, w), g in zip(want, jax.tree.leaves(got)):
            assert g.dtype == w.dtype and g.shape == w.shape, path
            assert g.tobytes() == w.tobytes(), path
        assert [s for _, s in rck.steps()] == [3, 4]
