"""Scenario library for the deterministic concurrency harness.

Reproduces the paper's §5 experiments — N concurrent readers of one
blob, N concurrent appenders, N writers to disjoint ranges, and a mixed
read/write workload — as client programs scheduled by
:class:`~repro.core.sim.Simulator` in virtual time.  Hundreds of
simulated clients run in milliseconds of wall time, every interleaving
is replayable from the seed, and aggregate throughput falls out of the
virtual makespan (the same per-endpoint wire model the benchmarks
always used for derived bandwidth, now actually driving the schedule).

Writing a new scenario::

    def my_scenario(env: ScenarioEnv) -> None:          # setup (driver
        env.blob = env.client("setup").create(...)      # thread — free)

    def my_program(env: ScenarioEnv, i: int):
        def prog():                                     # one client task
            c = env.client(f"c{i:03d}")
            ...                                         # blocking calls
            return {"ops": ..., "bytes": ...}           # charge virtual time
        return prog

    SCENARIOS["mine"] = Scenario("mine", "...", my_scenario, my_program)

then ``run_scenario("mine", n_clients=256, seed=1)``.  Programs must
return ``{"ops": int, "bytes": int}``; the runner aggregates those into
the throughput figures.  Failure injection: pass
``failures=[(virtual_time, target), ...]`` and the runner spawns a
chaos task that downs each target at its scheduled virtual instant.  A
plain target names a data provider; ``"vm-leader:<idx>"`` downs the
replicated version-manager leader of the ``idx``-th setup blob's
lineage (resolved at fire time), exercising the lease-based failover;
``"corrupt:<provider>"`` silently flips bytes of one stored page
*behind the provider's back* (bitrot injection — the recorded digest
stays intact, so only a scrub's ``verify_pages`` probe can tell).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from repro_torch.core.blob import BlobClient
from repro_torch.core.service import BlobSeerService
from repro_torch.core.sim import Simulator
from repro_torch.core.transport import EndpointDown, Wire
from repro_torch.core.version_manager import RetiredVersion


@dataclass
class ScenarioEnv:
    """Everything a scenario's setup and client programs can touch."""

    sim: Simulator
    svc: BlobSeerService
    n_clients: int
    psize: int
    chunk_pages: int
    ops_per_client: int
    blob: str = ""
    state: Dict[str, object] = field(default_factory=dict)

    @property
    def chunk(self) -> int:
        return self.chunk_pages * self.psize

    def client(self, name: str) -> BlobClient:
        return self.svc.client(name)


@dataclass(frozen=True)
class Scenario:
    """One experiment: driver-thread setup + per-client program.

    ``env_defaults`` are deployment kwargs the scenario pins unless the
    caller overrides them explicitly — the §5 paper reproductions pin
    ``page_cache_bytes=0`` because their clients model *distinct*
    nodes that share nothing (a shared in-process page cache would
    serve their repeat reads locally and fake the provider contention
    those figures measure); the beyond-paper cache/GC scenarios keep
    the production default (shared cache on).
    """

    name: str
    doc: str
    setup: Callable[[ScenarioEnv], None]
    program: Callable[[ScenarioEnv, int], Callable[[], dict]]
    env_defaults: Dict[str, object] = field(default_factory=dict)


@dataclass
class ScenarioResult:
    scenario: str
    n_clients: int
    seed: int
    ops: int
    bytes_moved: int
    makespan: float            # virtual seconds
    aggregate_mbps: float      # simulated aggregate throughput
    wall_seconds: float        # real time the simulation took
    events: int                # scheduler dispatches
    rpc: Dict[str, int]
    trace_digest: str
    client_results: Dict[str, object]
    errors: Dict[str, str]

    def row(self) -> str:
        return (
            f"{self.scenario},n={self.n_clients},seed={self.seed},"
            f"agg={self.aggregate_mbps:.1f}MBps,"
            f"makespan={self.makespan * 1e3:.2f}ms,"
            f"rpc_rounds={self.rpc.get('wire_round_trips', 0)},"
            f"wall={self.wall_seconds:.2f}s,trace={self.trace_digest[:12]}"
        )


# ---------------------------------------------------------------------------
# The four §5 experiments
# ---------------------------------------------------------------------------


def _setup_preloaded(env: ScenarioEnv) -> None:
    """One blob preloaded so every client has a disjoint chunk to read."""
    c = env.client("setup")
    env.blob = c.create(psize=env.psize)
    payload = b"\xcd" * env.chunk
    for _ in range(max(1, env.n_clients)):
        c.append(env.blob, payload)
    env.state["version"] = c.get_recent(env.blob)


def _reader_program(env: ScenarioEnv, i: int):
    """Fig 2(b): N readers concurrently read distinct chunks of one blob."""

    def prog() -> dict:
        c = env.client(f"r{i:03d}")
        v = env.state["version"]
        size = c.get_size(env.blob, v)
        done = 0
        for k in range(env.ops_per_client):
            off = ((i + k * env.n_clients) * env.chunk) % max(
                size - env.chunk, 1
            )
            data = c.read(env.blob, v, off, env.chunk)
            assert len(data) == env.chunk
            done += 1
        return {"ops": done, "bytes": done * env.chunk}

    return prog


def _setup_empty(env: ScenarioEnv) -> None:
    env.blob = env.client("setup").create(psize=env.psize)


def _appender_program(env: ScenarioEnv, i: int):
    """Fig 2(a)/3: N appenders; total order is asserted by the tests."""

    def prog() -> dict:
        c = env.client(f"a{i:03d}")
        versions: List[int] = []
        payload = bytes([i % 251 + 1]) * env.chunk
        for _ in range(env.ops_per_client):
            versions.append(c.append(env.blob, payload))
        return {"ops": len(versions), "bytes": len(versions) * env.chunk,
                "versions": versions}

    return prog


def _writer_program(env: ScenarioEnv, i: int):
    """§5 "concurrent writes": each client overwrites its own disjoint
    range of the preloaded blob, so final content is schedule-independent."""

    def prog() -> dict:
        c = env.client(f"w{i:03d}")
        payload = bytes([i % 251 + 1]) * env.chunk
        versions: List[int] = []
        for _ in range(env.ops_per_client):
            versions.append(c.write(env.blob, payload, i * env.chunk))
        return {"ops": len(versions), "bytes": len(versions) * env.chunk,
                "versions": versions}

    return prog


def _mixed_program(env: ScenarioEnv, i: int):
    """R/W workload: even clients read the most recent published
    snapshot while odd clients keep appending."""
    if i % 2 == 1:
        return _appender_program(env, i)

    def prog() -> dict:
        c = env.client(f"r{i:03d}")
        done = bytes_read = 0
        for _ in range(env.ops_per_client):
            v = c.get_recent(env.blob)
            if v == 0:
                # nothing published yet: wait (in virtual time) for the
                # first append instead of spinning on GET_RECENT
                c.sync(env.blob, 1, timeout=600.0)
                v = c.get_recent(env.blob)
            size = c.get_size(env.blob, v)
            take = min(env.chunk, size)
            data = c.read(env.blob, v, size - take, take)
            done += 1
            bytes_read += len(data)
        return {"ops": done, "bytes": bytes_read}

    return prog


def _setup_multi_blob(env: ScenarioEnv) -> None:
    """Several independent blobs (one lineage shard each): the ingest
    swarm spreads bursts over them, so version-manager contention is
    per lineage, never global."""
    c = env.client("setup")
    n_blobs = max(2, min(8, env.n_clients // 8 or 2))
    env.state["blobs"] = [c.create(psize=env.psize) for _ in range(n_blobs)]


BURST = 4  # appends per append_many burst in the append_burst scenario


def _append_burst_program(env: ScenarioEnv, i: int):
    """Multi-blob ingest: each client APPENDs bursts of ``BURST`` chunks
    via ``append_many``, cycling over the deployment's blobs.  One
    burst pays one ``assign_versions_many`` + one
    ``metadata_complete_many`` control round trip — the write-plane
    amortization ``bench_append`` gates on — and bursts to different
    blobs publish on independent lineage shards."""

    def prog() -> dict:
        blobs = env.state["blobs"]
        c = env.client(f"b{i:03d}")
        payload = bytes([i % 251 + 1]) * env.chunk
        versions: List[int] = []
        for k in range(env.ops_per_client):
            bid = blobs[(i + k) % len(blobs)]
            versions.extend(c.append_many(bid, [payload] * BURST))
        return {"ops": len(versions), "bytes": len(versions) * env.chunk,
                "versions": versions}

    return prog


def _setup_vm_failover(env: ScenarioEnv) -> None:
    """Multi-lineage burst fixture for the HA control plane: each blob
    roots its own lineage with a replicated leader endpoint
    (``vm-<blob>``), and clients are *pinned* to one blob each so
    per-lineage effects (the killed leader's lineage vs the untouched
    ones) are attributable in the wire stats."""
    c = env.client("setup")
    n_blobs = max(2, min(4, env.n_clients // 4 or 2))
    env.state["blobs"] = [c.create(psize=env.psize) for _ in range(n_blobs)]


def _vm_failover_program(env: ScenarioEnv, i: int):
    """Append bursts pinned per lineage, recording each burst's virtual
    latency.  With ``failures=[(t, 'vm-leader:0')]`` the leader of the
    first blob's lineage dies mid-run: its writers wait out the lease,
    promote a follower and re-drive — the burst still completes and no
    published version is lost (``bench_failover`` gates this)."""

    def prog() -> dict:
        blobs = env.state["blobs"]
        bid = blobs[i % len(blobs)]
        c = env.client(f"f{i:03d}")
        clock = env.svc.clock
        payload = bytes([i % 251 + 1]) * env.chunk
        versions: List[int] = []
        lats: List[float] = []
        for _ in range(env.ops_per_client):
            t0 = clock.now()
            versions.extend(c.append_many(bid, [payload] * BURST))
            lats.append(clock.now() - t0)
        return {"ops": len(versions), "bytes": len(versions) * env.chunk,
                "versions": versions, "lineage": i % len(blobs),
                "burst_latencies": lats}

    return prog


def _setup_hot_set(env: ScenarioEnv) -> None:
    """Small preloaded blob every reader hammers: the shared page cache
    and single-flight de-duplication are what keep the providers idle."""
    c = env.client("setup")
    env.blob = c.create(psize=env.psize)
    hot_chunks = max(4, min(16, env.n_clients // 4))
    payload = b"\xe7" * env.chunk
    for _ in range(hot_chunks):
        c.append(env.blob, payload)
    env.state["version"] = c.get_recent(env.blob)
    env.state["hot_chunks"] = hot_chunks


def _hot_set_program(env: ScenarioEnv, i: int):
    """N readers over a hot set much smaller than N * ops: reader *i*
    starts at chunk ``i % hot`` and walks the set sequentially, so the
    same pages are wanted by many clients at once (single-flight) and
    again later (cache hits).  Deterministic; no RNG."""

    def prog() -> dict:
        c = env.client(f"h{i:03d}")
        v = env.state["version"]
        hot = env.state["hot_chunks"]
        done = 0
        for k in range(env.ops_per_client):
            off = ((i + k) % hot) * env.chunk
            data = c.read(env.blob, v, off, env.chunk)
            assert len(data) == env.chunk
            done += 1
        return {"ops": done, "bytes": done * env.chunk}

    return prog


def _setup_gc_mixed(env: ScenarioEnv) -> None:
    """Preloaded blob with a keep-last retention window: GC rounds run
    *inside* the concurrent phase, racing readers and appenders."""
    c = env.client("setup")
    env.blob = c.create(psize=env.psize)
    payload = b"\xab" * env.chunk
    for _ in range(4):
        c.append(env.blob, payload)
    c.set_retention(env.blob, keep_last=4)
    env.state["version"] = c.get_recent(env.blob)


def _gc_mixed_program(env: ScenarioEnv, i: int):
    """GC-while-active: client 0 runs GC epochs, odd clients append,
    even clients read a pinned snapshot plus the most recent one.

    Reads of pinned (kept) versions must NEVER fail — that is the
    epoch/mark safety property.  Reads of the recency pointer may race
    past the retention window and get the typed ``RetiredVersion``;
    those are counted and retried, never crashes.
    """
    if i == 0:

        def gc_prog() -> dict:
            from repro_torch.core.gc import collect_garbage

            clock = env.svc.clock
            rounds = swept_pages = retired = 0
            for _ in range(max(4, env.ops_per_client)):
                clock.sleep(0.02)
                try:
                    # orphan inventory off: it is a slow-cadence job (600s
                    # grace) and would ship every provider's full listing
                    # each 0.02s round for nothing
                    stats = collect_garbage(env.svc, client=f"gc{i:03d}",
                                            orphan_grace=None)
                except EndpointDown:
                    continue  # a downed endpoint aborts the round; retried
                rounds += 1
                swept_pages += stats["swept_pages"]
                retired += stats["retired_versions"]
            return {"ops": rounds, "bytes": 0, "swept_pages": swept_pages,
                    "retired_versions": retired}

        return gc_prog

    if i % 2 == 1:

        def writer_prog() -> dict:
            # alternate append/overwrite: overwrites orphan the previous
            # copies of their pages, so the sweep has bytes to reclaim
            c = env.client(f"a{i:03d}")
            payload = bytes([i % 251 + 1]) * env.chunk
            versions: List[int] = []
            for k in range(env.ops_per_client):
                if k % 2 == 0:
                    versions.append(c.append(env.blob, payload))
                else:
                    versions.append(c.write(env.blob, payload, 0))
            return {"ops": len(versions), "bytes": len(versions) * env.chunk,
                    "versions": versions}

        return writer_prog

    def reader_prog() -> dict:
        c = env.client(f"r{i:03d}")
        v_pin = env.state["version"]
        lease = c.pin(env.blob, v_pin)
        pinned_size = c.get_size(env.blob, v_pin)
        done = bytes_read = pinned_failures = retired_retries = 0
        try:
            for _ in range(env.ops_per_client):
                try:
                    data = c.read(env.blob, v_pin, 0,
                                  min(env.chunk, pinned_size))
                    bytes_read += len(data)
                except Exception:  # noqa: BLE001 - any failure is a bug
                    pinned_failures += 1
                v = c.get_recent(env.blob)
                try:
                    size = c.get_size(env.blob, v)
                    take = min(env.chunk, size)
                    data = c.read(env.blob, v, size - take, take)
                    bytes_read += len(data)
                except RetiredVersion:
                    retired_retries += 1  # recency raced the GC window: allowed
                done += 1
        finally:
            c.unpin(lease)
        return {"ops": done, "bytes": bytes_read,
                "pinned_failures": pinned_failures,
                "retired_retries": retired_retries}

    return reader_prog


def _setup_train_serve(env: ScenarioEnv) -> None:
    """Blob-backed train/serve loop fixture (the integrated e2e workload).

    Driver-thread setup (free in virtual time): a token corpus the
    trainers will stream through ``data/pipeline.py`` shards, a model
    state sized ``TS_MODEL_PAGES`` pages, and its step-0 checkpoint
    committed through ``blobckpt`` — whose delta-scan digests feed the
    dedup handshake during the measured phase.  Lazy imports keep the
    scenario library's module surface jax-free for every other
    scenario.
    """
    import numpy as np

    from repro_torch.checkpoint.blobckpt import BlobCheckpointer
    from repro_torch.data.pipeline import CorpusWriter

    cfg = {
        "model_pages": env.state.get("model_pages", 256),
        "dirty_pages": env.state.get("dirty_pages", 32),
        "steps": max(2, env.ops_per_client),
        "header_pages": 4,
        "batch": 2,
        "seq_len": 127,
    }
    env.state["cfg"] = cfg

    corpus_client = env.client("corpus-setup")
    writer = CorpusWriter(corpus_client, psize=env.psize)
    words = env.psize // 4
    rng = np.random.default_rng(1234)
    writer.append_tokens(
        rng.integers(0, 50_000, size=4 * words, dtype=np.int32))
    env.state["corpus"] = writer.blob_id

    # model state: one flat int32 leaf, TS_MODEL_PAGES pages of psize
    w = np.zeros(cfg["model_pages"] * words, dtype=np.int32)
    w[::words] = np.arange(cfg["model_pages"])
    env.state["model"] = {"w": w}

    ckpt = BlobCheckpointer(env.client("ckpt-writer"), psize=env.psize,
                            header_pages=cfg["header_pages"])
    ckpt.save(env.state["model"], step=0)
    env.client("retention-setup").set_retention(ckpt.blob_id, keep_last=6)
    env.state["ckpt"] = ckpt
    env.state["ckpt_blob"] = ckpt.blob_id


def _train_serve_program(env: ScenarioEnv, i: int):
    """Roles: client 0 is the training checkpointer (the measured one),
    client 1 runs GC rounds, even clients serve reads of recent
    checkpoints through the shared page cache, odd clients are trainers
    streaming disjoint corpus shards.

    The checkpointer's result carries the bytes-on-wire ledger the
    ``bench_e2e`` gate asserts: per steady step it dirties exactly
    ``dirty_pages`` pages with step-unique content (the honest delta —
    never dedupable), then re-saves the full state from a fresh
    checkpointer with no digest cache (restart: every page *looks*
    dirty, the content-hash index absorbs all of it), then branches and
    saves a one-page mutation (fork: shared pages by refcount, not
    copy).
    """
    cfg = env.state["cfg"]

    def _provider_in_bytes() -> int:
        return sum(env.svc.wire.stats(p.pid).bytes_in
                   for p in env.svc.pm.all_providers())

    if i == 0:

        def ckpt_prog() -> dict:
            import numpy as np

            from repro_torch.checkpoint.blobckpt import BlobCheckpointer

            clock = env.svc.clock
            ckpt = env.state["ckpt"]
            model = env.state["model"]
            w = model["w"]
            words = env.psize // 4
            per_step_wire: List[int] = []
            payload_bytes = 0
            for step in range(1, cfg["steps"] + 1):
                clock.sleep(0.05)
                for j in range(cfg["dirty_pages"]):
                    p = (step * 7 + j * 5) % cfg["model_pages"]
                    w[p * words + 1] = step * 100_000 + p
                before = _provider_in_bytes()
                stats = ckpt.save(model, step=step)
                per_step_wire.append(_provider_in_bytes() - before)
                payload_bytes += stats.written_bytes
            # restart: fresh checkpointer, no digest cache — all pages
            # scan dirty; with dedup on, the handshake ships none of them
            clock.sleep(0.05)
            ck2 = BlobCheckpointer(env.client("ckpt-restart"),
                                   blob_id=ckpt.blob_id, psize=env.psize,
                                   header_pages=cfg["header_pages"])
            before = _provider_in_bytes()
            s_restart = ck2.save(model, step=cfg["steps"] + 1)
            restart_wire = _provider_in_bytes() - before
            # branch + one-page mutation: shared pages stay shared
            clock.sleep(0.05)
            child = ck2.branch()
            w[1] = -1
            pages_before = env.svc.storage_report()["pages"]
            before = _provider_in_bytes()
            s_branch = child.save(model, step=cfg["steps"] + 2)
            branch_wire = _provider_in_bytes() - before
            branch_pages_added = (env.svc.storage_report()["pages"]
                                  - pages_before)
            return {
                "ops": cfg["steps"] + 2,
                "bytes": payload_bytes,
                "per_step_wire": per_step_wire,
                "restart_wire": restart_wire,
                "restart_pages_scanned": s_restart.pages_written,
                "branch_wire": branch_wire,
                "branch_pages_added": branch_pages_added,
                "branch_pages_written": s_branch.pages_written,
                "model_bytes": cfg["model_pages"] * env.psize,
                "dirty_frac": cfg["dirty_pages"] / cfg["model_pages"],
            }

        return ckpt_prog

    if i == 1:

        def gc_prog() -> dict:
            from repro_torch.core.gc import collect_garbage

            clock = env.svc.clock
            rounds = swept = 0
            for _ in range(cfg["steps"] + 2):
                clock.sleep(0.07)
                try:
                    stats = collect_garbage(env.svc, client=f"gc{i:03d}",
                                            orphan_grace=None)
                except EndpointDown:
                    continue
                rounds += 1
                swept += stats["swept_pages"]
            return {"ops": rounds, "bytes": 0, "swept_pages": swept}

        return gc_prog

    if i % 2 == 0:

        def serve_prog() -> dict:
            from repro_torch.checkpoint.blobckpt import BlobCheckpointer

            c = env.client(f"serve{i:03d}")
            reader = BlobCheckpointer(c, blob_id=env.state["ckpt_blob"],
                                      psize=env.psize,
                                      header_pages=cfg["header_pages"])
            clock = env.svc.clock
            done = bytes_read = retired_retries = 0
            for k in range(cfg["steps"]):
                clock.sleep(0.03 + 0.001 * i)
                try:
                    manifest, mv = reader.read_manifest()
                    leaf = manifest["leaves"][0]
                    off = leaf["offset"] + ((i + k) % cfg["model_pages"]) \
                        * env.psize
                    data = c.read(env.state["ckpt_blob"], mv, off, env.psize)
                    bytes_read += len(data)
                    done += 1
                except RetiredVersion:
                    retired_retries += 1  # raced the retention window: retry
            return {"ops": done, "bytes": bytes_read,
                    "retired_retries": retired_retries}

        return serve_prog

    def trainer_prog() -> dict:
        from repro_torch.data.pipeline import ShardedReader

        c = env.client(f"train{i:03d}")
        n_shards = max(1, (env.n_clients - 1) // 2)
        shard = (i - 3) // 2 % n_shards
        reader = ShardedReader(c, env.state["corpus"], batch=cfg["batch"],
                               seq_len=cfg["seq_len"], shard=shard,
                               n_shards=n_shards)
        clock = env.svc.clock
        done = bytes_read = 0
        for _ in range(cfg["steps"]):
            xs, ys = reader.next_batch()
            bytes_read += xs.nbytes + ys.nbytes
            done += 1
            clock.sleep(0.04)
        return {"ops": done, "bytes": bytes_read}

    return trainer_prog


def _setup_durability(env: ScenarioEnv) -> None:
    """Durability-tier fixture: an erasure-coded blob (``ec:6+2``) and a
    3-way replicated twin, both preloaded with distinct per-chunk
    content.  The runner's ``failures`` list then kills providers (and
    injects bitrot via ``corrupt:<prov>``) mid-run; the scrub client
    repairs while readers keep verifying both blobs."""
    c = env.client("setup")
    ec_blob = c.create(psize=env.psize)
    env.svc.set_blob_placement(ec_blob, "ec:6+2")
    rep_blob = c.create(psize=env.psize)
    env.svc.set_blob_placement(rep_blob, "rep:3")
    chunks = max(2, min(8, env.n_clients))
    for blob in (ec_blob, rep_blob):
        for k in range(chunks):
            c.append(blob, bytes([(k % 251) + 1]) * env.chunk)
    env.state["blobs"] = [ec_blob, rep_blob]
    env.state["versions"] = {b: c.get_recent(b) for b in (ec_blob, rep_blob)}
    env.state["chunks"] = chunks
    env.state.setdefault("scrub_budget", 2 * 1024 * 1024)


def _durability_program(env: ScenarioEnv, i: int):
    """Client 0 is the scrub plane (budget-capped repair rounds on the
    virtual clock); everyone else reads both blobs throughout the chaos
    window and counts failed reads — the availability figure
    ``bench_durability`` gates on (EC must mask the loss of any ``m``
    shard providers with ZERO failed reads)."""
    if i == 0:

        def scrub_prog() -> dict:
            clock = env.svc.clock
            budget = env.state["scrub_budget"]
            rounds = repaired = corrupt = deferred = 0
            max_round_bytes = 0
            lost: set = set()
            for _ in range(max(8, env.ops_per_client * 4)):
                clock.sleep(0.02)
                try:
                    stats = env.svc.scrub(budget_bytes=budget,
                                          peer=f"scrub{i:03d}")
                except EndpointDown:
                    continue  # a probe raced a kill; retried next round
                rounds += 1
                repaired += stats["repaired_pages"]
                corrupt += stats["corrupt_copies"]
                deferred += stats["deferred_pages"]
                max_round_bytes = max(max_round_bytes,
                                      stats["repair_bytes"])
                lost.update(stats["losses"])
            # verification round: all damage the chaos injected must be
            # gone by now (anything this round still finds is residual)
            final = env.svc.scrub(budget_bytes=budget, peer=f"scrub{i:03d}")
            return {"ops": rounds, "bytes": 0,
                    "repaired_pages": repaired,
                    "corrupt_found": corrupt,
                    "deferred": deferred,
                    "max_round_repair_bytes": max_round_bytes,
                    "lost": sorted(lost),
                    "final_damaged": final["damaged_pages"],
                    "final_losses": list(final["losses"])}

        return scrub_prog

    def reader_prog() -> dict:
        c = env.client(f"d{i:03d}")
        blobs = env.state["blobs"]
        versions = env.state["versions"]
        chunks = env.state["chunks"]
        clock = env.svc.clock
        done = bytes_read = 0
        failed = [0] * len(blobs)
        for k in range(env.ops_per_client * 2):
            clock.sleep(0.01)
            which = (i + k) % len(blobs)
            bid = blobs[which]
            off = ((i + k) % chunks) * env.chunk
            try:
                data = c.read(bid, versions[bid], off, env.chunk)
                assert len(data) == env.chunk
                bytes_read += len(data)
            except EndpointDown:
                failed[which] += 1
            done += 1
        return {"ops": done, "bytes": bytes_read,
                "failed_reads": sum(failed),
                "failed_reads_ec": failed[0],
                "failed_reads_rep": failed[1]}

    return reader_prog


N_WATCH_WRITERS = 8  # writer clients in the watchers scenarios; the rest
#                      are gateway clients multiplexing many watch leases


def _setup_watchers(env: ScenarioEnv) -> None:
    """Subscription-plane fixture: ``N_WATCH_WRITERS`` blobs (one pinned
    writer each) and ``state["watchers"]`` simulated subscribers spread
    round-robin over the *gateway* clients.  Each gateway holds many
    watch leases on ONE shared inbox endpoint, so the notify fan-out is
    bounded by gateways (endpoints-with-watchers), never by the watcher
    count — the O(K x endpoints) property ``bench_watch`` gates on."""
    if env.n_clients <= N_WATCH_WRITERS:
        raise ValueError(
            f"watchers scenario needs > {N_WATCH_WRITERS} clients "
            f"({N_WATCH_WRITERS} writers + at least one gateway)")
    c = env.client("setup")
    blobs = [c.create(psize=env.psize) for _ in range(N_WATCH_WRITERS)]
    env.state["blobs"] = blobs
    env.state["final"] = env.ops_per_client * BURST
    total = int(env.state.get("watchers", 64))
    n_gateways = env.n_clients - N_WATCH_WRITERS
    gateways: List[Tuple[BlobClient, List[Tuple[str, str]]]] = []
    for g in range(n_gateways):
        client = env.client(f"gw{g:03d}")
        leases: List[Tuple[str, str]] = []
        for w in range(g, total, n_gateways):
            bid = blobs[w % len(blobs)]
            leases.append((client.watch(bid, from_version=0), bid))
        gateways.append((client, leases))
    env.state["gateways"] = gateways


def _watcher_program(env: ScenarioEnv, i: int):
    """Writers (``i < N_WATCH_WRITERS``) publish append bursts to their
    pinned blob; gateways block on their inboxes until every lease has
    been pushed the final version, then drain the delivered streams."""
    blobs = env.state["blobs"]
    final = env.state["final"]

    if i < N_WATCH_WRITERS:

        def writer_prog() -> dict:
            bid = blobs[i]
            c = env.client(f"wr{i:03d}")
            payload = bytes([i % 251 + 1]) * env.chunk
            versions: List[int] = []
            for _ in range(env.ops_per_client):
                versions.extend(c.append_many(bid, [payload] * BURST))
            return {"ops": len(versions), "bytes": len(versions) * env.chunk,
                    "versions": versions}

        return writer_prog

    def gateway_prog() -> dict:
        client, leases = env.state["gateways"][i - N_WATCH_WRITERS]
        delivered: Dict[str, List[int]] = {}
        for wid, _bid in leases:
            client.inbox.wait_for(wid, final, timeout=600.0)
            delivered[wid] = client.poll_notifications(wid)
        return {"ops": sum(len(vs) for vs in delivered.values()),
                "bytes": 0, "delivered": delivered}

    return gateway_prog


def _setup_watchers_poll(env: ScenarioEnv) -> None:
    """Poll-twin fixture: same blobs/writers/watcher spread as
    ``watchers``, but NO leases — gateways learn of publications by
    polling ``get_recent`` per simulated watcher, the control-plane
    cost the subscription plane exists to remove."""
    if env.n_clients <= N_WATCH_WRITERS:
        raise ValueError(
            f"watchers_poll scenario needs > {N_WATCH_WRITERS} clients "
            f"({N_WATCH_WRITERS} writers + at least one gateway)")
    c = env.client("setup")
    blobs = [c.create(psize=env.psize) for _ in range(N_WATCH_WRITERS)]
    env.state["blobs"] = blobs
    env.state["final"] = env.ops_per_client * BURST
    total = int(env.state.get("watchers", 64))
    n_gateways = env.n_clients - N_WATCH_WRITERS
    env.state["poll_sets"] = [
        [blobs[w % len(blobs)] for w in range(g, total, n_gateways)]
        for g in range(n_gateways)
    ]


def _poll_watcher_program(env: ScenarioEnv, i: int):
    """Identical writers; each gateway polls ``get_recent`` for every
    simulated watcher it fronts until all have observed the final
    version — one RPC per watcher per round, O(W) on the control plane
    (the figure the notify path beats by >= 10x)."""
    if i < N_WATCH_WRITERS:
        return _watcher_program(env, i)

    def poll_prog() -> dict:
        targets = env.state["poll_sets"][i - N_WATCH_WRITERS]
        final = env.state["final"]
        interval = float(env.state.get("poll_interval", 0.05))
        c = env.client(f"pg{i:03d}")
        clock = env.svc.clock
        last = [0] * len(targets)
        delivered: List[List[int]] = [[] for _ in targets]
        poll_rpcs = 0
        while any(lv < final for lv in last):
            for w, bid in enumerate(targets):
                if last[w] >= final:
                    continue
                v = c.get_recent(bid)
                poll_rpcs += 1
                if v > last[w]:
                    delivered[w].extend(range(last[w] + 1, v + 1))
                    last[w] = v
            if any(lv < final for lv in last):
                clock.sleep(interval)
        return {"ops": sum(len(vs) for vs in delivered),
                "bytes": 0, "poll_rpcs": poll_rpcs,
                "delivered": {str(w): vs for w, vs in enumerate(delivered)}}

    return poll_prog


# ---------------------------------------------------------------------------
# Elastic membership scenarios
# ---------------------------------------------------------------------------


def _setup_membership(env: ScenarioEnv) -> None:
    """Preloaded blob for the membership scenarios; ``state['blobs']``
    is set so index-based chaos targets resolve."""
    _setup_preloaded(env)
    env.state["blobs"] = [env.blob]


def _rolling_restart_program(env: ScenarioEnv, i: int):
    """Client 0 is the operator rolling the fleet: each cycled provider
    is drained (transfer-out concurrent with the readers, zero failed
    ops), deregistered, then rejoined as a fresh empty member that
    receives its owed pages back via budgeted migration.  Everyone else
    reads the preloaded blob throughout; ``failed_reads`` must stay 0 —
    the old owner serves every page until its move lands."""
    if i == 0:

        def operator_prog() -> dict:
            clock = env.svc.clock
            sleep = float(env.state.get("migration_sleep", 0.005))
            hot = sorted(p.pid for p in env.svc.pm.all_providers()
                         if getattr(p, "tier", "hot") == "hot")
            n_cycles = int(env.state.get(
                "restart_cycles", min(3, max(1, len(hot) - 2))))
            cycled = 0
            moves = 0
            for pid in hot[:n_cycles]:
                clock.sleep(0.01)
                stats = env.svc.drain_provider(pid, round_sleep=sleep)
                moves += stats["moves"] + stats["stragglers"]
                clock.sleep(0.01)
                plan = env.svc.join_provider(pid)
                back = env.svc.run_migration(plan, round_sleep=sleep)
                moves += back["moves"]
                cycled += 1
            return {"ops": cycled, "bytes": 0, "cycled": cycled,
                    "migration_moves": moves}

        return operator_prog

    def reader_prog() -> dict:
        c = env.client(f"r{i:03d}")
        v = env.state["version"]
        size = c.get_size(env.blob, v)
        clock = env.svc.clock
        done = bytes_read = failed = 0
        for k in range(env.ops_per_client * 2):
            clock.sleep(0.008)
            off = ((i + k * env.n_clients) * env.chunk) % max(
                size - env.chunk, 1)
            try:
                data = c.read(env.blob, v, off, env.chunk)
                assert len(data) == env.chunk
                bytes_read += len(data)
            except EndpointDown:
                failed += 1
            done += 1
        return {"ops": done, "bytes": bytes_read, "failed_reads": failed}

    return reader_prog


def _scale_out_program(env: ScenarioEnv, i: int):
    """Client 0 joins fresh providers mid-run and streams them their
    owed pages while odd clients keep appending (new pages place onto
    the joined members from their first allocation) and even clients
    keep reading the preloaded snapshot — zero failed ops both ways."""
    if i == 0:

        def operator_prog() -> dict:
            clock = env.svc.clock
            sleep = float(env.state.get("migration_sleep", 0.005))
            n_new = int(env.state.get("scale_out_by", 2))
            joined = []
            moves = 0
            for j in range(n_new):
                clock.sleep(0.02)
                pid = f"prov-join-{j:02d}"
                plan = env.svc.join_provider(pid)
                stats = env.svc.run_migration(plan, round_sleep=sleep)
                moves += stats["moves"]
                joined.append(pid)
            return {"ops": len(joined), "bytes": 0, "joined": joined,
                    "migration_moves": moves}

        return operator_prog

    if i % 2 == 1:

        def appender_prog() -> dict:
            c = env.client(f"a{i:03d}")
            clock = env.svc.clock
            payload = bytes([i % 251 + 1]) * env.chunk
            versions: List[int] = []
            for _ in range(env.ops_per_client):
                clock.sleep(0.006)
                versions.append(c.append(env.blob, payload))
            return {"ops": len(versions), "bytes": len(versions) * env.chunk,
                    "versions": versions}

        return appender_prog

    def reader_prog() -> dict:
        c = env.client(f"r{i:03d}")
        v = env.state["version"]
        size = c.get_size(env.blob, v)
        clock = env.svc.clock
        done = bytes_read = failed = 0
        for k in range(env.ops_per_client):
            clock.sleep(0.009)
            off = ((i + k * env.n_clients) * env.chunk) % max(
                size - env.chunk, 1)
            try:
                data = c.read(env.blob, v, off, env.chunk)
                bytes_read += len(data)
            except EndpointDown:
                failed += 1
            done += 1
        return {"ops": done, "bytes": bytes_read, "failed_reads": failed}

    return reader_prog


def _setup_flash_crowd(env: ScenarioEnv) -> None:
    """A small preloaded blob whose FIRST chunk every client hammers —
    the flash crowd.  ``state['flashcrowd_mitigate']`` (default on)
    lets the benchmark run a no-mitigation twin for the load contrast;
    the shared page cache is pinned off because the crowd models
    distinct client nodes hitting the providers directly."""
    c = env.client("setup")
    env.blob = c.create(psize=env.psize)
    for k in range(4):
        c.append(env.blob, bytes([(k % 251) + 1]) * env.chunk)
    env.state["version"] = c.get_recent(env.blob)
    env.state["blobs"] = [env.blob]
    env.state.setdefault("flashcrowd_mitigate", True)
    env.state.setdefault("flashcrowd_threshold", 16)
    env.state.setdefault("flashcrowd_extra", 2)


def _flash_crowd_program(env: ScenarioEnv, i: int):
    """Client 0 is the load balancer: it samples the served-read
    tallies every interval and widens any hot page onto its next ring
    owners (``mitigate_flash_crowd``); the crowd keeps re-reading the
    same first chunk.  The balancer's result carries the final
    per-provider served-read load — the distribution ``bench_ring``
    gates on (mitigated max-load must flatten vs the twin)."""
    if i == 0:

        def balancer_prog() -> dict:
            clock = env.svc.clock
            mitigate = bool(env.state.get("flashcrowd_mitigate", True))
            rounds = widened = 0
            for _ in range(max(6, env.ops_per_client * 2)):
                clock.sleep(0.01)
                rounds += 1
                if mitigate:
                    widened += len(env.svc.mitigate_flash_crowd(
                        threshold=int(env.state["flashcrowd_threshold"]),
                        extra=int(env.state["flashcrowd_extra"]),
                        blob_id=env.blob))
            return {"ops": rounds, "bytes": 0, "widened_pages": widened,
                    "read_load": dict(env.svc.pm.read_load())}

        return balancer_prog

    def crowd_prog() -> dict:
        c = env.client(f"c{i:03d}")
        v = env.state["version"]
        clock = env.svc.clock
        done = bytes_read = failed = 0
        for _ in range(env.ops_per_client * 2):
            clock.sleep(0.004)
            try:
                data = c.read(env.blob, v, 0, env.chunk)
                assert len(data) == env.chunk
                bytes_read += len(data)
            except EndpointDown:
                failed += 1
            done += 1
        return {"ops": done, "bytes": bytes_read, "failed_reads": failed}

    return crowd_prog


SCENARIOS: Dict[str, Scenario] = {
    "readers": Scenario(
        "readers",
        "N concurrent readers of one blob, disjoint chunks (paper Fig 2b)",
        _setup_preloaded, _reader_program,
        env_defaults={"page_cache_bytes": 0},
    ),
    "appenders": Scenario(
        "appenders",
        "N concurrent appenders to one blob (paper Fig 2a/3)",
        _setup_empty, _appender_program,
        env_defaults={"page_cache_bytes": 0},
    ),
    "writers": Scenario(
        "writers",
        "N concurrent writers to disjoint ranges (paper Fig 4)",
        _setup_preloaded, _writer_program,
        env_defaults={"page_cache_bytes": 0},
    ),
    "mixed": Scenario(
        "mixed",
        "N/2 readers of recent snapshots + N/2 appenders (paper §5 R/W)",
        _setup_preloaded, _mixed_program,
        env_defaults={"page_cache_bytes": 0},
    ),
    "append_burst": Scenario(
        "append_burst",
        "N clients ingesting multi-blob append bursts through the "
        "batched writer verbs (scale-out write plane)",
        _setup_multi_blob, _append_burst_program,
        env_defaults={"page_cache_bytes": 0},
    ),
    "hot_set": Scenario(
        "hot_set",
        "N readers hammering a small hot set of one blob (page-cache "
        "hits + single-flight de-duplication carry the load)",
        _setup_hot_set, _hot_set_program,
    ),
    "gc_mixed": Scenario(
        "gc_mixed",
        "GC epochs racing a mixed pinned-reader/appender workload "
        "(distributed mark/sweep while clients are active)",
        _setup_gc_mixed, _gc_mixed_program,
    ),
    "vm_failover": Scenario(
        "vm_failover",
        "Clients pinned per lineage driving append bursts while a VM "
        "lineage leader dies mid-run (HA control plane: lease failover, "
        "journal re-drive, untouched lineages unaffected)",
        _setup_vm_failover, _vm_failover_program,
        env_defaults={"page_cache_bytes": 0, "vm_replication": 2,
                      "vm_lease_ttl": 0.05},
    ),
    "durability": Scenario(
        "durability",
        "Self-healing tier under chaos: an ec:6+2 blob and a rep:3 twin "
        "read continuously while providers die and bitrot is injected; "
        "a budget-capped scrub plane detects and repairs everything "
        "(erasure decode on read masks the losses meanwhile)",
        _setup_durability, _durability_program,
        env_defaults={"verify_digests": True},
    ),
    "watchers": Scenario(
        "watchers",
        "Subscription plane at scale: thousands of watch leases "
        "multiplexed over gateway inboxes while pinned writers publish "
        "append bursts; notify fan-out is per endpoint, not per watcher",
        _setup_watchers, _watcher_program,
        env_defaults={"page_cache_bytes": 0, "vm_replication": 2,
                      "vm_lease_ttl": 0.05},
    ),
    "watchers_poll": Scenario(
        "watchers_poll",
        "Poll twin of the watchers scenario: the same watcher spread "
        "learns of publications by polling get_recent per watcher — the "
        "O(W) control-plane baseline the notify path is gated against",
        _setup_watchers_poll, _poll_watcher_program,
        env_defaults={"page_cache_bytes": 0, "vm_replication": 2,
                      "vm_lease_ttl": 0.05},
    ),
    "rolling_restart": Scenario(
        "rolling_restart",
        "Operator rolls the provider fleet: drain -> deregister -> "
        "rejoin each member in turn while readers stay on the blob; "
        "budget-capped migration keeps every op succeeding (elastic "
        "membership)",
        _setup_membership, _rolling_restart_program,
        env_defaults={"page_cache_bytes": 0},
    ),
    "scale_out": Scenario(
        "scale_out",
        "Fresh providers join mid-run and receive exactly their owed "
        "key ranges while appenders and readers keep running (online "
        "consistent-hash rebalance)",
        _setup_membership, _scale_out_program,
        env_defaults={"page_cache_bytes": 0},
    ),
    "flash_crowd": Scenario(
        "flash_crowd",
        "Every client hammers one chunk; a load balancer samples read "
        "tallies and widens the hot pages onto their next ring owners "
        "(load-aware replica widening vs the unmitigated twin)",
        _setup_flash_crowd, _flash_crowd_program,
        env_defaults={"page_cache_bytes": 0},
    ),
    "train_serve": Scenario(
        "train_serve",
        "Integrated train/serve loop: trainers stream corpus shards, the "
        "checkpointer commits deltas through the dedup handshake, a "
        "serving tier reads recent checkpoints via the page cache, GC "
        "races everyone (virtual clock, deterministic)",
        _setup_train_serve, _train_serve_program,
        env_defaults={"dedup": True},
    ),
}


# ---------------------------------------------------------------------------
# Failure injection
# ---------------------------------------------------------------------------


def parse_failure_target(target: str) -> Tuple[str, object]:
    """Parse a chaos target spec into ``(kind, arg)``.

    ``"vm-leader:<idx>"`` -> ``("vm-leader", idx)`` — down the replicated
    version-manager leader of the idx-th setup blob's lineage;
    ``"corrupt:<provider>"`` -> ``("corrupt", provider)`` — flip bytes of
    that provider's first stored page behind its back;
    ``"join:<provider>"`` -> ``("join", provider)`` — an elastic-membership
    event: the named provider joins the ring and receives its owed pages
    via budgeted migration rounds; ``"drain:<provider>"`` ->
    ``("drain", provider)`` — the named provider transfers out and
    deregisters with zero failed ops; ``"flashcrowd:<idx>"`` ->
    ``("flashcrowd", idx)`` — run one flash-crowd mitigation pass scoped
    to the idx-th setup blob (widen its hot pages onto their next ring
    owners); any other non-empty string -> ``("kill", target)`` — a data
    provider to down.  Malformed specs raise ``ValueError`` (so
    ``run_scenario`` rejects them up front, before any virtual time has
    elapsed).
    """
    if not target:
        raise ValueError("empty failure target")
    if target.startswith("vm-leader:"):
        raw = target.split(":", 1)[1]
        try:
            idx = int(raw)
        except ValueError:
            raise ValueError(
                f"vm-leader index must be an integer, got {raw!r}"
            ) from None
        if idx < 0:
            raise ValueError(f"vm-leader index must be >= 0, got {idx}")
        return "vm-leader", idx
    if target.startswith("corrupt:"):
        prov = target.split(":", 1)[1]
        if not prov:
            raise ValueError("corrupt target names no provider")
        return "corrupt", prov
    if target.startswith("join:"):
        prov = target.split(":", 1)[1]
        if not prov:
            raise ValueError("join target names no provider")
        return "join", prov
    if target.startswith("drain:"):
        prov = target.split(":", 1)[1]
        if not prov:
            raise ValueError("drain target names no provider")
        return "drain", prov
    if target.startswith("flashcrowd:"):
        raw = target.split(":", 1)[1]
        try:
            idx = int(raw)
        except ValueError:
            raise ValueError(
                f"flashcrowd index must be an integer, got {raw!r}"
            ) from None
        if idx < 0:
            raise ValueError(f"flashcrowd index must be >= 0, got {idx}")
        return "flashcrowd", idx
    return "kill", target


def apply_failure_target(svc: BlobSeerService, state: Dict[str, object],
                         target: str) -> str:
    """Fire one parsed chaos target against a live deployment.

    Targets resolve at fire time: "vm-leader:<idx>" downs the
    replicated VM leader of the idx-th setup blob's lineage (HA
    failover path); "corrupt:<prov>" flips bytes of that provider's
    first stored page behind its back (bitrot — the digest recorded at
    put time is left alone, so only a scrub probe can detect it);
    anything else is a data provider to kill.  Returns the endpoint (or
    spec) that was hit.
    """
    kind, arg = parse_failure_target(target)
    if kind == "vm-leader":
        blobs = state.get("blobs")
        if not blobs:
            raise ValueError(
                "vm-leader target needs setup blobs in env.state['blobs']")
        if arg >= len(blobs):  # type: ignore[operator]
            raise ValueError(
                f"vm-leader index {arg} out of range "
                f"(setup created {len(blobs)} blobs)")  # type: ignore[arg-type]
        return svc.kill_vm_leader(blobs[arg])  # type: ignore[index]
    if kind == "corrupt":
        prov = svc.pm.get(arg)
        victims = sorted(prov.store.iter_pids())
        if victims:
            vic = victims[0]
            payload = prov.store.get(vic)
            # mutate the raw store, NOT through delete_pages /
            # put_pages — silent corruption leaves bookkeeping
            # (digests, timestamps) untouched
            prov.store.delete(vic)
            prov.store.put(vic, bytes([payload[0] ^ 0xFF]) + payload[1:])
        return target
    if kind == "join":
        # elastic scale-out mid-run: the member starts taking new pages
        # at once; its owed already-stored pages stream over in budgeted
        # rounds that yield virtual time to the surrounding clients
        plan = svc.join_provider(arg)  # type: ignore[arg-type]
        svc.run_migration(
            plan, round_sleep=float(state.get("migration_sleep", 0.005)))
        return target
    if kind == "drain":
        svc.drain_provider(
            arg,  # type: ignore[arg-type]
            round_sleep=float(state.get("migration_sleep", 0.005)))
        return target
    if kind == "flashcrowd":
        blobs = state.get("blobs")
        if not blobs:
            raise ValueError(
                "flashcrowd target needs setup blobs in env.state['blobs']")
        if arg >= len(blobs):  # type: ignore[operator]
            raise ValueError(
                f"flashcrowd index {arg} out of range "
                f"(setup created {len(blobs)} blobs)")  # type: ignore[arg-type]
        svc.mitigate_flash_crowd(
            threshold=int(state.get("flashcrowd_threshold", 32)),
            extra=int(state.get("flashcrowd_extra", 1)),
            blob_id=blobs[arg])  # type: ignore[index]
        return target
    svc.kill_provider(arg)
    return target


# ---------------------------------------------------------------------------
# Runner
# ---------------------------------------------------------------------------


def build_env(
    n_clients: int,
    *,
    seed: int = 0,
    n_providers: int = 16,
    n_meta_shards: int = 8,
    psize: int = 64 * 1024,
    chunk_pages: int = 4,
    ops_per_client: int = 2,
    record_trace: bool = False,
    scenario: Optional[str] = None,
    **svc_kwargs,
) -> ScenarioEnv:
    """A simulated deployment + env, ready for spawn/run.

    Pass ``scenario`` to apply that scenario's ``env_defaults`` (e.g.
    the §5 reproductions pin ``page_cache_bytes=0``); explicit
    ``svc_kwargs`` still win.  Prebuilding an env without naming the
    scenario skips those pins — deliberate only when you want to study
    a scenario under non-default deployment settings.
    """
    if scenario is not None:
        svc_kwargs = {**SCENARIOS[scenario].env_defaults, **svc_kwargs}
    sim = Simulator(seed=seed, record_trace=record_trace)
    svc = BlobSeerService(
        n_providers=n_providers, n_meta_shards=n_meta_shards,
        wire=Wire(clock=sim), **svc_kwargs,
    )
    return ScenarioEnv(
        sim=sim, svc=svc, n_clients=n_clients, psize=psize,
        chunk_pages=chunk_pages, ops_per_client=ops_per_client,
    )


def run_scenario(
    scenario: str,
    n_clients: int,
    *,
    seed: int = 0,
    failures: Sequence[Tuple[float, str]] = (),
    raise_errors: bool = True,
    env: Optional[ScenarioEnv] = None,
    **env_kwargs,
) -> ScenarioResult:
    """Run one §5 scenario at ``n_clients`` simulated clients.

    Setup happens on the driver thread (free in virtual time); counters
    and wire accounting are then zeroed so makespan/throughput measure
    only the concurrent phase.  ``failures`` downs endpoints at
    scheduled virtual instants via a chaos task.
    """
    spec = SCENARIOS[scenario]
    if env is None:
        env = build_env(n_clients, seed=seed, scenario=scenario,
                        **env_kwargs)
    sim, svc = env.sim, env.svc
    spec.setup(env)
    svc.reset_rpc_counters()

    for i in range(n_clients):
        sim.spawn(spec.program(env, i), name=f"{scenario}-{i:03d}")
    for t, target in failures:
        parse_failure_target(target)  # reject malformed specs up front
        def chaos(target=target):
            # Targets resolve at FIRE time (see apply_failure_target):
            # the leader a "vm-leader:<idx>" spec downs is whoever holds
            # the lineage lease at that virtual instant.
            killed = apply_failure_target(svc, env.state, target)
            return {"ops": 0, "bytes": 0, "killed": killed}
        sim.spawn_at(t, chaos, name=f"chaos-{target}")

    t0 = time.perf_counter()
    sim.run(raise_errors=raise_errors)
    wall = time.perf_counter() - t0

    client_results = sim.results()
    errors = {k: repr(v) for k, v in sim.errors().items()}
    ops = sum(r.get("ops", 0) for r in client_results.values()
              if isinstance(r, dict))
    moved = sum(r.get("bytes", 0) for r in client_results.values()
                if isinstance(r, dict))
    makespan = max(sim.now(), svc.wire.sim_span())
    return ScenarioResult(
        scenario=scenario, n_clients=n_clients, seed=seed, ops=ops,
        bytes_moved=moved, makespan=makespan,
        aggregate_mbps=moved / max(makespan, 1e-12) / 1e6,
        wall_seconds=wall, events=sim.events_dispatched,
        rpc=svc.rpc_report(), trace_digest=sim.trace_digest(),
        client_results=client_results, errors=errors,
    )
