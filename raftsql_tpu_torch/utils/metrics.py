"""Node counters + timing helpers.

The reference instantiates etcd's ServerStats/LeaderStats only to satisfy
the transport (reference raft.go:167-176) and never reads them; SURVEY.md
§5.5 asks for real per-node counters instead, exported via the HTTP API
(`GET /metrics` in api/http.py).
"""
from __future__ import annotations

import os
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np


@dataclass
class NodeMetrics:
    ticks: int = 0
    proposals: int = 0
    commits: int = 0
    msgs_sent: int = 0
    elections_won: int = 0
    catchup_appends: int = 0
    compactions: int = 0
    snapshots_sent: int = 0
    snapshots_installed: int = 0
    # Dynamic membership (raftsql_tpu/membership/): committed
    # conf-change entries APPLIED by this node (device masks patched +
    # WAL baseline written).  The companion gauges members_voters /
    # members_learners are computed live from the manager at export
    # time (runtime/db.py metrics()).
    conf_changes_applied: int = 0
    # Quorum geometry (config.py flexible quorums + witness peers):
    # entries fsynced into witness peers' WALs — durability contributed
    # by voters that own no SQLite shard.  The companion gauges
    # quorum.{write_size,election_size,witnesses} are computed from the
    # config at export time (runtime/db.py metrics()).
    witness_appends: int = 0
    # Serving-plane 10x counters (PR 7): WAL group commits — one
    # write+fsync covering EVERY peer's tick records (storage/wal.py
    # GroupCommitWAL) — and double-buffered dispatch ticks, where the
    # previous tick's durable phase ran inside the next dispatch's
    # device window (runtime/hostplane.py overlap pipeline).
    wal_group_commits: int = 0
    overlap_ticks: int = 0
    # Read-plane counters (the lease/ReadIndex/session read plane,
    # runtime/db.py query modes): how each served read was satisfied,
    # plus the lease lifecycle — grants (a linear read served straight
    # from a live lease), expiries (a leader held the read path but its
    # lease had lapsed), degrades (a linear read fell back from the
    # lease fast path to a full ReadIndex quorum round).
    reads_local: int = 0
    reads_session: int = 0
    reads_follower: int = 0
    reads_lease: int = 0
    reads_read_index: int = 0
    lease_grants: int = 0
    lease_expiries: int = 0
    lease_degrades: int = 0
    # Zero-round-trip read plane (PR 12): shm_hits are GETs a worker
    # served from its mapped snapshot without any ring traffic;
    # shm_fallbacks are GETs that tried the shm plane and had to fall
    # back to the ring round trip (stale epoch, publisher behind the
    # requested watermark, log overflow); read_index_batched counts
    # ReadIndex reads confirmed by a SHARED per-tick quorum round
    # (runtime/node.py read batcher) rather than a round of their own.
    # The batch histogram buckets how many reads each confirming round
    # carried (power-of-2 buckets like transfer_stall_hist).
    reads_shm_hits: int = 0
    reads_shm_fallbacks: int = 0
    reads_read_index_batched: int = 0
    read_batch_hist: Dict[str, int] = field(default_factory=dict)
    # Reads parked on the apply (runtime/db.py RaftDB.park): reads that
    # waited for the local apply to reach their read point, those the
    # apply released, the sum of their waits (released or timed out),
    # the most parked at once, and those whose deadline came first.
    reads_parked: int = 0
    read_wakes: int = 0
    t_read_wait_ms: float = 0.0
    read_waiters_max: int = 0
    read_wait_timeouts: int = 0
    # Fault counters (chaos/ harness + storage fsio shim): injected
    # message-plane faults and storage faults survived by this node.
    # Zero outside chaos runs; exported so a chaos'd deployment's
    # /metrics names what it was subjected to.
    faults_dropped_msgs: int = 0
    faults_delayed_msgs: int = 0
    faults_partitions: int = 0
    faults_crashes: int = 0
    faults_fsync: int = 0
    # Extended fault matrix (PR 2): corrupt wire frames dropped by the
    # CRC-framed codec (transport/codec.py + tcp/_recv_loop), ENOSPC
    # write failures surfaced by the WAL (storage/fsio.py), fsync
    # latency stalls survived, and per-peer clock-skew timer deviation
    # applied (runtime/fused.py timer_inc seam).  corrupt_frames is ALSO
    # live in production: any bad frame a TCP peer sends is counted
    # here, not just injected ones.
    faults_corrupt_frames: int = 0
    faults_enospc: int = 0
    faults_fsync_stalls: int = 0
    faults_skew_ticks: int = 0
    # Leadership-transfer plane (PR 11): admin/placement-initiated
    # transfers by outcome — initiated (latch armed), completed (the
    # target took leadership), aborted (deadline passed or leadership
    # settled elsewhere; the group re-opened for proposals either way),
    # refused (validation failed: no leader, in-flight transfer,
    # learner/non-voter target).  The stall histogram buckets each
    # finished transfer's proposal-intake pause in ticks (power-of-2
    # buckets, keys are strings so prom_samples renders
    # transfers_stall_ticks_hist{bucket=...}).
    # Pod plane (raftsql_tpu/pod/): the multi-host runtime's cross-host
    # counters — collectives completed (one per tick once the pod is
    # formed), wall time this host spent WAITING in them (the lockstep
    # cost: slowest-host skew + the wire), proposals that arrived from
    # ANOTHER pod host via the gather, durable-commit acks sent as a
    # group-shard owner / received as an origin, and transport bytes.
    # All zero outside --pod deployments.
    pod_gathers: int = 0
    pod_gather_wait_ms: float = 0.0
    pod_proposals_routed: int = 0
    pod_acks_tx: int = 0
    pod_acks_rx: int = 0
    pod_bytes_tx: int = 0
    pod_bytes_rx: int = 0
    transfers_initiated: int = 0
    transfers_completed: int = 0
    transfers_aborted: int = 0
    transfers_refused: int = 0
    transfer_stall_hist: Dict[str, int] = field(default_factory=dict)
    # Per-phase tick wall time, accumulated by RaftNode.tick (SURVEY.md
    # §5.1 live profiling): staging (installs + inbox build) / device
    # step / WAL fsync / send / publish.
    t_stage_ms: float = 0.0
    t_device_ms: float = 0.0
    t_wal_ms: float = 0.0
    t_send_ms: float = 0.0
    t_publish_ms: float = 0.0
    # The state machines' apply (RaftDB._apply_run, on the apply
    # thread), and the fused tick's enqueue of its device step: wall
    # time always, the tick thread's own CPU time only while the span
    # tracer is on (obs/spans.py).
    t_apply_ms: float = 0.0
    t_launch_ms: float = 0.0
    t_launch_cpu_ms: float = 0.0
    # The apply's split (RaftDB._apply_run): native calls that applied a
    # run to its file-backed SQLite groups (models/sqlite_sm.py
    # apply_runs) and the entries they applied, entries applied one
    # state machine at a time from Python (`:memory:`, witness, KV), and
    # the wall time inside the native calls on SQLite's side of the
    # interpreter lock (measured in C); t_apply_ms less it is the
    # Python around them and the waits for the lock.
    apply_native_runs: int = 0
    apply_native_entries: int = 0
    apply_py_entries: int = 0
    t_apply_sqlite_ms: float = 0.0
    # The fused runtime's device step (runtime/fused.py): CUDA graphs
    # captured of it, ticks that replayed one, replays that first copied
    # a rebound state or inbox into the graph's buffers, and steps
    # enqueued op by op (every tick on the CPU; the warm-up tick before
    # a capture on a card).  graph_replays / ticks is the graph's share.
    graph_captures: int = 0
    graph_replays: int = 0
    graph_restages: int = 0
    eager_steps: int = 0
    started_at: float = field(default_factory=time.monotonic)

    def note_transfer_stall(self, ticks: int) -> None:
        """Bucket one finished transfer's intake-stall duration."""
        b = 1
        t = max(int(ticks), 1)
        while b < t:
            b <<= 1
        k = str(b)
        self.transfer_stall_hist[k] = self.transfer_stall_hist.get(k, 0) + 1

    def note_read_batch(self, n: int) -> None:
        """Bucket one confirming round's ReadIndex batch size."""
        b = 1
        t = max(int(n), 1)
        while b < t:
            b <<= 1
        k = str(b)
        self.read_batch_hist[k] = self.read_batch_hist.get(k, 0) + 1

    def snapshot(self) -> dict:
        up = max(time.monotonic() - self.started_at, 1e-9)
        t = max(self.ticks, 1)
        return {
            "ticks": self.ticks,
            "proposals": self.proposals,
            "commits": self.commits,
            "msgs_sent": self.msgs_sent,
            "elections_won": self.elections_won,
            "catchup_appends": self.catchup_appends,
            "compactions": self.compactions,
            "snapshots_sent": self.snapshots_sent,
            "snapshots_installed": self.snapshots_installed,
            "conf_changes_applied": self.conf_changes_applied,
            "witness_appends": self.witness_appends,
            "wal_group_commits": self.wal_group_commits,
            "overlap_ticks": self.overlap_ticks,
            "reads": {
                "local": self.reads_local,
                "session": self.reads_session,
                "follower": self.reads_follower,
                "lease": self.reads_lease,
                "read_index": self.reads_read_index,
                "lease_grants": self.lease_grants,
                "lease_expiries": self.lease_expiries,
                "lease_degrades": self.lease_degrades,
                "shm_hits": self.reads_shm_hits,
                "shm_fallbacks": self.reads_shm_fallbacks,
                "read_index_batched": self.reads_read_index_batched,
                "batch_hist": dict(self.read_batch_hist),
                "reads_parked": self.reads_parked,
                "read_wakes": self.read_wakes,
                "t_read_wait_ms": round(self.t_read_wait_ms, 3),
                "read_waiters_max": self.read_waiters_max,
                "read_wait_timeouts": self.read_wait_timeouts,
            },
            "faults": {
                "dropped_msgs": self.faults_dropped_msgs,
                "delayed_msgs": self.faults_delayed_msgs,
                "partitions": self.faults_partitions,
                "crashes": self.faults_crashes,
                "fsync": self.faults_fsync,
                "corrupt_frames": self.faults_corrupt_frames,
                "enospc": self.faults_enospc,
                "fsync_stalls": self.faults_fsync_stalls,
                "skew_ticks": self.faults_skew_ticks,
            },
            "pod": {
                "gathers": self.pod_gathers,
                "gather_wait_ms": round(self.pod_gather_wait_ms, 3),
                "proposals_routed": self.pod_proposals_routed,
                "acks_tx": self.pod_acks_tx,
                "acks_rx": self.pod_acks_rx,
                "bytes_tx": self.pod_bytes_tx,
                "bytes_rx": self.pod_bytes_rx,
            },
            "transfers": {
                "initiated": self.transfers_initiated,
                "completed": self.transfers_completed,
                "aborted": self.transfers_aborted,
                "refused": self.transfers_refused,
                "stall_ticks_hist": dict(self.transfer_stall_hist),
            },
            "uptime_s": round(up, 3),
            "commits_per_s": round(self.commits / up, 3),
            "phase_ms_per_tick": {
                "stage": round(self.t_stage_ms / t, 4),
                "device": round(self.t_device_ms / t, 4),
                "wal": round(self.t_wal_ms / t, 4),
                "send": round(self.t_send_ms / t, 4),
                "publish": round(self.t_publish_ms / t, 4),
                "apply": round(self.t_apply_ms / t, 4),
                "launch": round(self.t_launch_ms / t, 4),
            },
            "apply": {
                "native_runs": self.apply_native_runs,
                "native_entries": self.apply_native_entries,
                "py_entries": self.apply_py_entries,
                "t_apply_ms": round(self.t_apply_ms, 3),
                "t_apply_sqlite_ms": round(self.t_apply_sqlite_ms, 3),
            },
            "device_step": {
                "graph_captures": self.graph_captures,
                "graph_replays": self.graph_replays,
                "graph_restages": self.graph_restages,
                "eager_steps": self.eager_steps,
            },
        }


class GroupTraffic:
    """Host-side `[G]` propose/commit/ack counters + EWMA rates — the
    per-group traffic feed for `GET /metrics` (`group_traffic`) and the
    future placement controller (ROADMAP: traffic-aware leadership
    migration needs per-group propose rates to find hot groups).

    Counters are stamped where the host plane already walks per-group
    structures (runtime/hostplane.py: `_stage_ranges` for proposals,
    `_publish_shard` for commits; runtime/db.py `_ack_one` for acks) —
    one vectorized `np.add.at` per tick, no new device work.  Commit
    updates arrive from per-shard publish workers over DISJOINT group
    blocks, so the unsynchronized adds never race on an element.  Rates
    are EWMA'd lazily at scrape time (nothing on the tick path)."""

    def __init__(self, num_groups: int, alpha: float = 0.3,
                 top_k: int = 10):
        G = num_groups
        self.num_groups = G
        self.proposed = np.zeros(G, np.int64)
        self.committed = np.zeros(G, np.int64)
        self.acked = np.zeros(G, np.int64)
        self.top_k = int(os.environ.get("RAFTSQL_METRICS_TOPK", top_k))
        self._alpha = alpha
        self._rate_p = np.zeros(G)
        self._rate_c = np.zeros(G)
        self._last_p = np.zeros(G, np.int64)
        self._last_c = np.zeros(G, np.int64)
        self._last_t = time.monotonic()
        self._mu = threading.Lock()

    # -- hot path (tick thread / publish workers / commit consumer) ----

    def add_propose(self, groups, counts) -> None:
        np.add.at(self.proposed, groups, counts)

    def add_commit(self, groups, counts) -> None:
        np.add.at(self.committed, groups, counts)

    def add_ack(self, group: int) -> None:
        self.acked[group] += 1

    # -- scrape path ----------------------------------------------------

    def _advance_rates_locked(self) -> None:
        now = time.monotonic()
        dt = now - self._last_t
        if dt < 0.05:       # back-to-back scrapes: keep the last window
            return
        inst_p = (self.proposed - self._last_p) / dt
        inst_c = (self.committed - self._last_c) / dt
        a = self._alpha
        self._rate_p += a * (inst_p - self._rate_p)
        self._rate_c += a * (inst_c - self._rate_c)
        self._last_p = self.proposed.copy()
        self._last_c = self.committed.copy()
        self._last_t = now

    def doc(self, leader_of=None, shard_of=None,
            k: Optional[int] = None, transferring=None) -> dict:
        """Aggregate totals + the top-K hot-groups table
        (group id, 1-based leader, EWMA propose/commit rates, raw
        totals; a `shard` column on sharded runtimes so the placement
        story can move hot groups between shards; a `transferring`
        flag when the runtime supplies the set of groups with a
        leadership transfer in flight)."""
        with self._mu:
            self._advance_rates_locked()
            rp = self._rate_p.copy()
            rc = self._rate_c.copy()
        k = min(k if k is not None else self.top_k, self.num_groups)
        # Rate-first ranking with the all-time totals as tie-breaker
        # (a scrape before any rate window still ranks by volume).
        order = np.lexsort((-self.proposed, -rp))[:k]
        hot: List[dict] = []
        for g in order.tolist():
            if not (self.proposed[g] or self.committed[g]
                    or rp[g] > 0):
                continue
            row = {"group": g,
                   "leader": (int(leader_of(g)) + 1
                              if leader_of is not None else 0),
                   "propose_rate": round(float(rp[g]), 3),
                   "commit_rate": round(float(rc[g]), 3),
                   "proposed": int(self.proposed[g]),
                   "committed": int(self.committed[g]),
                   "acked": int(self.acked[g])}
            if callable(shard_of):
                row["shard"] = int(shard_of(g))
            if transferring is not None:
                row["transferring"] = g in transferring
            hot.append(row)
        return {"proposed": int(self.proposed.sum()),
                "committed": int(self.committed.sum()),
                "acked": int(self.acked.sum()),
                "hot_groups": hot}


# ---------------------------------------------------------------------------
# Prometheus text exposition (GET /metrics?format=prom).


PROM_CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"


def wants_prom(query: str, accept: str) -> bool:
    """Content negotiation for GET /metrics: `?format=prom` wins, else
    an Accept header asking for the Prometheus text exposition
    (`application/openmetrics-text` or `text/plain; version=0.0.4`)."""
    if "format=prom" in (query or ""):
        return True
    a = (accept or "").lower()
    return "openmetrics" in a or "version=0.0.4" in a


def _prom_name(s: str) -> str:
    return "".join(c if c.isalnum() or c == "_" else "_" for c in s)


def _prom_label_value(v) -> str:
    return str(v).replace("\\", "\\\\").replace('"', '\\"') \
        .replace("\n", "\\n")


def prom_samples(doc: dict, prefix: str = "raftsql"
                 ) -> List[Tuple[str, Dict[str, str], float]]:
    """Flatten a metrics() JSON document into Prometheus samples
    [(name, labels, value)].  One mapping owns both the exposition and
    the round-trip check (scripts/check_prom.py): every numeric leaf of
    the JSON becomes exactly one sample.

      * nested dicts join with `_` (faults.crashes ->
        raftsql_faults_crashes);
      * dicts keyed by digit strings become bucket-labeled samples
        (wal_gc_batch_hist -> raftsql_wal_gc_batch_hist{bucket="3"});
      * `phase_profile` becomes the summary raftsql_tick_phase_ms
        {phase=...,quantile=...} + _count/_sum/_max series;
      * `group_traffic.hot_groups` rows become raftsql_group_<field>
        {group=...,leader=...[,shard=...]} gauges;
      * None / NaN / strings are skipped (a scrape must always render).
    """
    out: List[Tuple[str, Dict[str, str], float]] = []

    def num(v):
        if isinstance(v, bool):
            return float(v)
        if isinstance(v, (int, float)) and v == v:
            return float(v)
        return None

    def add(name, labels, v):
        fv = num(v)
        if fv is not None:
            out.append((name, labels, fv))

    def walk(obj, name):
        if isinstance(obj, dict):
            if obj and all(isinstance(k, str) and k.lstrip("-").isdigit()
                           for k in obj) \
                    and all(num(v) is not None for v in obj.values()):
                for k, v in sorted(obj.items(), key=lambda kv: int(kv[0])):
                    add(name, {"bucket": k}, v)
                return
            for k, v in obj.items():
                walk(v, f"{name}_{_prom_name(k)}")
        else:
            add(name, {}, obj)

    for key, val in doc.items():
        if key == "phase_profile" and isinstance(val, dict):
            base = f"{prefix}_tick_phase_ms"
            for phase, st in val.items():
                if not isinstance(st, dict):
                    add(f"{prefix}_phase_profile_{_prom_name(phase)}",
                        {}, st)
                    continue
                lab = {"phase": phase}
                for q, f in (("0.5", "p50_ms"), ("0.95", "p95_ms"),
                             ("0.99", "p99_ms")):
                    if f in st:
                        add(base, {**lab, "quantile": q}, st[f])
                add(f"{base}_count", lab, st.get("n"))
                add(f"{base}_sum", lab, st.get("total_ms"))
                # max is not a summary-family suffix: standalone gauge.
                add(f"{prefix}_tick_phase_max_ms", lab,
                    st.get("max_ms"))
            continue
        if key == "group_traffic" and isinstance(val, dict):
            for k, v in val.items():
                if k != "hot_groups":
                    add(f"{prefix}_group_traffic_{_prom_name(k)}", {}, v)
            for row in val.get("hot_groups", ()):
                lab = {"group": str(row.get("group"))}
                if "leader" in row:
                    lab["leader"] = str(row["leader"])
                if "shard" in row:
                    lab["shard"] = str(row["shard"])
                for f, v in row.items():
                    if f in ("group", "leader", "shard"):
                        continue
                    add(f"{prefix}_group_{_prom_name(f)}", lab, v)
            continue
        walk(val, f"{prefix}_{_prom_name(key)}")
    return out


def prom_render(doc: dict, prefix: str = "raftsql") -> str:
    """The Prometheus text exposition of a metrics() document: samples
    grouped per metric name behind one # HELP/# TYPE pair (the format
    requires a metric's samples contiguous), gauges throughout except
    the tick-phase summary."""
    samples = prom_samples(doc, prefix)
    grouped: "Dict[str, List[Tuple[Dict[str, str], float]]]" = {}
    order: List[str] = []
    for name, labels, value in samples:
        if name not in grouped:
            grouped[name] = []
            order.append(name)
        grouped[name].append((labels, value))
    summary = f"{prefix}_tick_phase_ms"
    lines: List[str] = []
    for name in order:
        if name in (summary + "_count", summary + "_sum"):
            # Part of the summary family declared at `summary` — the
            # exposition format forbids a second TYPE for them.
            pass
        else:
            lines.append(f"# HELP {name} raftsql metric {name}")
            lines.append(f"# TYPE {name} "
                         + ("summary" if name == summary else "gauge"))
        for labels, value in grouped[name]:
            lab = ""
            if labels:
                lab = "{" + ",".join(
                    f'{_prom_name(k)}="{_prom_label_value(v)}"'
                    for k, v in labels.items()) + "}"
            if value == int(value) and abs(value) < 2 ** 53:
                sval = str(int(value))
            else:
                sval = repr(value)
            lines.append(f"{name}{lab} {sval}")
    return "\n".join(lines) + "\n"


class LatencyTimer:
    """Thread-safe propose→commit latency sampler (p50 north-star metric).

    A ring of the most recent `cap` samples, so percentiles track
    steady-state latency instead of freezing on compile-stall-dominated
    startup samples."""

    def __init__(self, cap: int = 4096):
        self._samples: list[float] = []
        self._cap = cap
        self._next = 0
        self._lock = threading.Lock()

    def record(self, seconds: float) -> None:
        with self._lock:
            if len(self._samples) < self._cap:
                self._samples.append(seconds)
            else:
                self._samples[self._next] = seconds
                self._next = (self._next + 1) % self._cap

    def percentile(self, q: float) -> float:
        return self.percentiles((q,))[0]

    def percentiles(self, qs) -> list:
        """Percentile per q in `qs`, from ONE snapshot + sort.

        The copy happens under the lock; the O(n log n) sort does NOT —
        a /metrics scrape sorting 4096 samples inside the lock would
        stall every record() on the tick hot path for the duration.
        NaN when empty."""
        with self._lock:
            s = list(self._samples)
        if not s:
            return [float("nan")] * len(qs)
        s.sort()
        return [s[min(int(q * len(s)), len(s) - 1)] for q in qs]
