"""Pod-plane chaos: a seeded nemesis over a REAL multi-process pod.

Port of raftsql_tpu/chaos/pod.py: the same plan, workload, invariants
and verdict digest, with every child a process of the port stepping on
`device` (the card by default) over RAFTSQL_SHARD_SLOTS=8 shard slots,
as the JAX package's children run on 8 forced host devices.

The pod runtime (raftsql_tpu_torch/pod/) breaks the single-controller
assumption: N host processes jointly own the cluster, lockstepped by a
per-tick collective, each durable for its own group shards.  Its
failure model is FAIL-STOP AND POD-WIDE — one host dying kills the
whole program — which moves the recovery burden to the restart path:
the respawned pod must rebuild the identical global state from the
MERGED cross-host replay exchange.  That is exactly what this nemesis
attacks.  It drives N `raftsql_tpu_torch.chaos.pod --child` processes
(TcpPodTransport between them, sharded WAL dirs per host) through a
seeded `PodChaosPlan` of INCARNATIONS:

  * SIGKILL of a NON-coordinator host — the coordinator's collective
    recv breaks mid-tick; it must abort the pod (PodPeerLost fan-out)
    rather than hang, and the respawned pod must recover every acked
    write from the dead host's surviving WAL dirs;
  * SIGKILL of the COORDINATOR host — the members' sockets break; the
    fail-fast path without the abort broadcast;
  * a PROPOSE-PLANE cut — one origin's client offers cannot reach the
    collective for a window (deferred, counted): availability degrades
    at one host without breaking any promise.  A transport-level cut
    is not a separate event on purpose: the pod is fail-stop, so a
    severed collective socket IS the kill path, already exercised.

Workload: each origin offers unique keyed writes ("{pid} SET
w{origin}x{n} h{origin}i{inc}"), pid strided by origin exactly like
the pod's proposal seqs so the existing ack plane routes it home.  The
owner of a group acks a write's pid only after the commit appears in
its post-barrier publish stream (durable by the pod tick contract);
the origin appends honest acks to an append-only ledger the nemesis
audits.  On reboot a child RE-OFFERS (same pid — the retry token)
every offered-unacked write absent from the replayed fold; the fold
dedups by pid, so a write that committed but lost its ack applies
exactly once.

After the final fault-free incarnation every host dumps its fold and
the nemesis checks:

  D  durability    — every acked (key, value) is in the audit fold;
  X  exactly-once  — every key applied exactly once (post-dedup);
  C  convergence   — all hosts' folds + hard-state digests identical.

Determinism tier matches the proc plane (the weakest, README fault
matrix): plan digest + invariant-verdict digest must reproduce across
runs of one seed; the committed history crosses N real kernels and is
not bit-stable.  The falsification pair (schedule.py
falsification_pod_plan): acks written at OFFER time plus a hard
pre-durability crash MUST be caught by D; the same schedule with
honest acks must pass.
"""
from __future__ import annotations

import hashlib
import json
import os
import signal
import socket
import subprocess
import sys
import time
from typing import Dict, List, Optional, Set, Tuple

from raftsql_tpu_torch.chaos.invariants import InvariantViolation
from raftsql_tpu_torch.chaos.schedule import (PodChaosPlan, PodKill,
                                              PodLinkCut)

# Child exit codes: PodPeerLost (a peer died; the pod-wide fail-stop
# exit) and the falsification plan's injected pre-durability crash.
EXIT_POD_LOST = 75
EXIT_POD_CRASH = 73


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _plan_from_doc(doc: dict) -> PodChaosPlan:
    return PodChaosPlan(
        seed=doc["seed"], ticks=doc["ticks"], procs=doc["procs"],
        peers=doc["peers"], groups=doc["groups"],
        group_shards=doc["group_shards"],
        settle_ticks=doc["settle_ticks"],
        kills=tuple(PodKill(**k) for k in doc["kills"]),
        cuts=tuple(PodLinkCut(**c) for c in doc["cuts"]),
        unsafe_ack=doc["unsafe_ack"], crash_at=doc["crash_at"])


def _fault_incarnations(plan: PodChaosPlan) -> int:
    """How many incarnations carry scripted faults; the audit
    incarnation (fault-free, runs to completion, dumps the fold) is
    the one after the last of these."""
    n = 0
    for k in plan.kills:
        n = max(n, k.incarnation + 1)
    if plan.crash_at >= 0:
        n = max(n, 1)
    return n


# ======================================================================
# Child: one pod process under the nemesis
# ======================================================================


class _PodChild:
    """One pod host process.  Lives in the same module as the nemesis
    (ProcCluster spawns server/main.py; the pod child has no server —
    its whole job is the workload + the audit fold)."""

    def __init__(self, plan: PodChaosPlan, proc_id: int, coord: str,
                 workdir: str, incarnation: int, device="cuda"):
        self.plan = plan
        self.device = device
        self.proc_id = proc_id
        self.coord = coord
        self.workdir = workdir
        self.inc = incarnation
        self.offers_path = os.path.join(workdir,
                                        f"offers-p{proc_id}.log")
        self.acks_path = os.path.join(workdir, f"acks-p{proc_id}.log")
        self.progress_path = os.path.join(
            workdir, f"progress-i{incarnation}-p{proc_id}.json")
        self.dump_path = os.path.join(workdir, f"dump-p{proc_id}.json")
        # pid -> (key, value, group) for every offer THIS origin ever
        # made (append-only ledger, replayed at boot for re-offers).
        self.offered: Dict[int, Tuple[str, str, int]] = {}
        self.acked: Set[int] = set()
        # The audit fold: key -> value, post-dedup, plus bookkeeping.
        self.fold: Dict[str, str] = {}
        self.applied_counts: Dict[str, int] = {}
        self.seen_pids: Set[int] = set()
        self.dups_folded = 0
        self.deferred = 0
        self.reoffered = 0

    # -- persistent ledgers --------------------------------------------

    def _load_ledgers(self) -> None:
        if os.path.exists(self.offers_path):
            with open(self.offers_path, encoding="utf-8") as f:
                for line in f:
                    parts = line.split()
                    if len(parts) == 4:
                        self.offered[int(parts[0])] = (
                            parts[1], parts[2], int(parts[3]))
        if os.path.exists(self.acks_path):
            with open(self.acks_path, encoding="utf-8") as f:
                for line in f:
                    parts = line.split()
                    if len(parts) == 3:
                        self.acked.add(int(parts[0]))

    def _log_offer(self, f, pid: int, key: str, value: str,
                   group: int) -> None:
        f.write(f"{pid} {key} {value} {group}\n")
        f.flush()
        self.offered[pid] = (key, value, group)

    def _log_ack(self, f, pid: int) -> None:
        if pid in self.acked or pid not in self.offered:
            return
        key, value, _g = self.offered[pid]
        f.write(f"{pid} {key} {value}\n")
        f.flush()
        self.acked.add(pid)

    def _progress(self, it: int) -> None:
        tmp = self.progress_path + ".tmp"
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump({"iter": it, "deferred": self.deferred,
                       "reoffered": self.reoffered}, f)
        os.replace(tmp, self.progress_path)

    # -- the node ------------------------------------------------------

    def _build_node(self):
        from raftsql_tpu_torch.config import RaftConfig
        from raftsql_tpu_torch.pod.config import PodConfig
        from raftsql_tpu_torch.pod.node import PodClusterNode
        from raftsql_tpu_torch.runtime.mesh import MeshConfig
        plan = self.plan
        pod = PodConfig(procs=plan.procs, proc_id=self.proc_id,
                        coordinator=self.coord)
        cfg = RaftConfig(num_groups=plan.groups, num_peers=plan.peers,
                         log_window=32, max_entries_per_msg=4,
                         election_ticks=10, heartbeat_ticks=1,
                         tick_interval_s=0.0, seed=7)
        mesh = MeshConfig(peer_shards=1,
                          group_shards=plan.group_shards).build(
                              device=self.device)
        return PodClusterNode(
            pod, cfg, os.path.join(self.workdir, f"h{self.proc_id}"),
            mesh, seed=3, connect_timeout_s=60.0, io_timeout_s=120.0)

    def _absorb(self, node, ack_f, honest_acks: bool) -> None:
        """Drain peer 0's publish stream into the fold (dedup by pid)
        and run both sides of the ack plane: owner-side acks for
        commits in OWNED groups, origin-side ledger appends for acks
        the collective carried home."""
        import queue

        from raftsql_tpu_torch.runtime.db import _expand_commit_item
        q = node.commit_q(0)
        ack_pids: List[int] = []
        while True:
            try:
                item = q.get_nowait()
            except queue.Empty:
                break
            if item is None or not isinstance(item, tuple):
                continue
            for (g, _i, data) in _expand_commit_item(item):
                text = data.decode("utf-8", "replace") \
                    if isinstance(data, (bytes, bytearray)) else str(data)
                parts = text.split()
                if len(parts) != 4 or parts[1] != "SET":
                    continue
                pid, key, value = int(parts[0]), parts[2], parts[3]
                if pid in self.seen_pids:
                    self.dups_folded += 1
                else:
                    self.seen_pids.add(pid)
                    self.fold[key] = value
                    self.applied_counts[key] = \
                        self.applied_counts.get(key, 0) + 1
                if honest_acks and node.owns_group(int(g)):
                    ack_pids.append(pid)
        if ack_pids:
            node.pod_send_ack(ack_pids)
        for pid in node.pod_take_acked():
            self._log_ack(ack_f, pid)

    # -- main ----------------------------------------------------------

    def run(self) -> int:
        from raftsql_tpu_torch.pod.transport import PodPeerLost
        plan = self.plan
        self._load_ledgers()
        honest = not plan.unsafe_ack
        # In an incarnation with a scheduled kill the child never
        # finishes on its own: it paces (so the parent's progress poll
        # can land the SIGKILL at the scripted iteration) and loops
        # until killed — a kill that silently misses would turn the
        # fired-families verdict into a coin flip.
        has_kill = any(k.incarnation == self.inc for k in plan.kills)
        iter_s = 0.05 if has_kill else 0.0
        cuts = [c for c in plan.cuts if c.incarnation == self.inc
                and c.origin == self.proc_id]
        crash_here = plan.crash_at >= 0 and self.inc == 0

        try:
            node = self._build_node()
        except PodPeerLost:
            return EXIT_POD_LOST
        ack_f = open(self.acks_path, "a", encoding="utf-8")
        offer_f = open(self.offers_path, "a", encoding="utf-8")
        try:
            # Settle: elections + the replayed prefix's re-publish all
            # land before the workload starts (fixed tick count — every
            # host must run the same collective sequence).
            for _ in range(plan.settle_ticks):
                node.tick()
                self._absorb(node, ack_f, honest)
            # Re-offer pending writes the replay did not recover: same
            # pid (the retry token — the fold dedups a write that
            # committed but lost its ack).
            pending = [pid for pid in sorted(self.offered)
                       if pid not in self.acked
                       and pid not in self.seen_pids]
            n = len(self.offered)
            it = 0
            while True:
                self._progress(it)
                if any(c.start <= it < c.end for c in cuts):
                    self.deferred += 1        # propose plane severed
                else:
                    if pending:
                        pid = pending.pop(0)
                        key, value, group = self.offered[pid]
                        self.reoffered += 1
                    else:
                        pid = self.proc_id + n * plan.procs
                        key = f"w{self.proc_id}x{n}"
                        value = f"h{self.proc_id}i{self.inc}"
                        group = pid % plan.groups
                        n += 1
                        self._log_offer(offer_f, pid, key, value, group)
                    if plan.unsafe_ack:
                        self._log_ack(ack_f, pid)   # BROKEN: pre-durable
                    if crash_here and it == plan.crash_at:
                        # The falsification crash point: a hard exit
                        # AFTER the offer (and, under unsafe_ack, its
                        # premature ack) but BEFORE the collective ever
                        # carries it — the acked write cannot possibly
                        # be durable anywhere, so the durability
                        # invariant must catch it in the audit fold.
                        ack_f.flush()
                        offer_f.flush()
                        os._exit(EXIT_POD_CRASH)
                    node.pod_propose(
                        group, [f"{pid} SET {key} {value}".encode()])
                node.tick()
                self._absorb(node, ack_f, honest)
                it += 1
                if it >= plan.ticks and not has_kill:
                    break
                if iter_s:
                    time.sleep(iter_s)
            # Trailing settle: let in-flight commits land and the last
            # acks ride home, then dump the audit fold.
            for _ in range(plan.settle_ticks):
                node.tick()
                self._absorb(node, ack_f, honest)
            self._progress(it)
            self._dump(node)
            node.stop()
            return 0
        except PodPeerLost:
            try:
                node.stop()
            except Exception:
                pass
            return EXIT_POD_LOST
        finally:
            ack_f.close()
            offer_f.close()

    def _dump(self, node) -> None:
        import numpy as np
        hard = hashlib.sha256(
            np.ascontiguousarray(node._hard).tobytes()).hexdigest()[:16]
        doc = {"proc_id": self.proc_id, "incarnation": self.inc,
               "kv": self.fold, "applied_counts": self.applied_counts,
               "hard_digest": hard, "dups_folded": self.dups_folded,
               "deferred": self.deferred, "reoffered": self.reoffered,
               "pod": node.pod_doc()}
        tmp = self.dump_path + ".tmp"
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump(doc, f, sort_keys=True)
        os.replace(tmp, self.dump_path)


# ======================================================================
# Parent: the nemesis
# ======================================================================


class PodChaosRunner:
    """Drive a PodChaosPlan against a real N-process pod; module doc.
    `device` is where every child steps (default cuda; a missing card
    raises here, before any child starts)."""

    def __init__(self, plan: PodChaosPlan, workdir: str, device="cuda"):
        from raftsql_tpu_torch.core.state import resolve_device
        self.plan = plan
        self.device = str(resolve_device(device))
        self.workdir = str(workdir)
        os.makedirs(self.workdir, exist_ok=True)
        with open(os.path.join(self.workdir, "plan.json"), "w",
                  encoding="utf-8") as f:
            json.dump(plan.describe(), f, sort_keys=True)
        repo_root = os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))))
        self.env_base = dict(
            os.environ, RAFTSQL_SHARD_SLOTS="8",
            PYTHONPATH=repo_root + (
                os.pathsep + os.environ["PYTHONPATH"]
                if os.environ.get("PYTHONPATH") else ""))
        # A CPU child steps with one torch thread: the pod's processes
        # share the host's cores (and a test run shares them too).
        if self.device == "cpu":
            self.env_base["OMP_NUM_THREADS"] = "1"
        self.procs: List[Optional[subprocess.Popen]] = \
            [None] * plan.procs
        self.report = {
            "incarnations": 0, "kills": 0, "coord_kills": 0,
            "noncoord_kills": 0, "pod_lost_exits": 0, "crash_exits": 0,
            "unexpected_exits": 0, "acked": 0, "cut_deferred": 0,
            "reoffered": 0, "folded_keys": 0, "dups_folded": 0,
        }
        self.verdicts: Dict[str, str] = {}

    # -- child control -------------------------------------------------

    def _spawn_all(self, inc: int, coord: str) -> None:
        for i in range(self.plan.procs):
            logf = open(os.path.join(self.workdir,
                                     f"pod{i}.log"), "ab")
            self.procs[i] = subprocess.Popen(
                [sys.executable, "-m", "raftsql_tpu_torch.chaos.pod",
                 "--child", "--proc-id", str(i), "--coord", coord,
                 "--workdir", self.workdir,
                 "--incarnation", str(inc), "--device", self.device],
                cwd=self.workdir, env=self.env_base,
                stdout=logf, stderr=logf)
            logf.close()

    def _progress_iter(self, inc: int, proc: int) -> int:
        path = os.path.join(self.workdir,
                            f"progress-i{inc}-p{proc}.json")
        try:
            with open(path, encoding="utf-8") as f:
                return int(json.load(f)["iter"])
        except (OSError, ValueError, KeyError):
            return -1

    def _wait_all(self, deadline_s: float) -> List[Optional[int]]:
        deadline = time.monotonic() + deadline_s
        codes: List[Optional[int]] = [None] * self.plan.procs
        while time.monotonic() < deadline:
            for i, p in enumerate(self.procs):
                codes[i] = None if p is None else p.poll()
            if all(c is not None for c in codes):
                return codes
            time.sleep(0.05)
        for i, p in enumerate(self.procs):      # fail-safe teardown
            if p is not None and p.poll() is None:
                p.kill()
                p.wait(timeout=15)
            codes[i] = None if p is None else p.poll()
        raise InvariantViolation(
            f"pod children failed to exit before the deadline "
            f"(codes so far: {codes})")

    def _score_exit(self, code: int, killed: bool) -> None:
        if killed:
            return                               # the scripted SIGKILL
        if code == EXIT_POD_LOST:
            self.report["pod_lost_exits"] += 1
        elif code == EXIT_POD_CRASH:
            self.report["crash_exits"] += 1
        elif code != 0:
            self.report["unexpected_exits"] += 1

    # -- incarnations --------------------------------------------------

    def _run_incarnation(self, inc: int) -> None:
        plan = self.plan
        coord = f"127.0.0.1:{_free_port()}"
        kills = [k for k in plan.kills if k.incarnation == inc]
        self._spawn_all(inc, coord)
        self.report["incarnations"] += 1
        killed: Set[int] = set()
        try:
            # Land every scripted SIGKILL once its target's progress
            # file shows it past the scripted iteration (children in a
            # kill incarnation loop until killed — the kill cannot be
            # missed, only late).
            deadline = time.monotonic() + 240.0
            for k in sorted(kills, key=lambda k: k.at_iter):
                while True:
                    if time.monotonic() > deadline:
                        raise InvariantViolation(
                            f"pod kill at iter {k.at_iter} of proc "
                            f"{k.proc} never became due "
                            f"(progress="
                            f"{self._progress_iter(inc, k.proc)})")
                    p = self.procs[k.proc]
                    if p is None or p.poll() is not None:
                        raise InvariantViolation(
                            f"pod proc {k.proc} died before its "
                            f"scripted kill (exit {p.poll()})")
                    if self._progress_iter(inc, k.proc) >= k.at_iter:
                        p.send_signal(signal.SIGKILL)
                        p.wait(timeout=15)
                        killed.add(k.proc)
                        self.report["kills"] += 1
                        if k.proc == 0:
                            self.report["coord_kills"] += 1
                        else:
                            self.report["noncoord_kills"] += 1
                        break
                    time.sleep(0.02)
            codes = self._wait_all(300.0)
        finally:
            for p in self.procs:
                if p is not None and p.poll() is None:
                    p.kill()
                    p.wait(timeout=15)
        expect_crash = plan.crash_at >= 0 and inc == 0
        for i, code in enumerate(codes):
            self._score_exit(code, killed=i in killed)
            if not kills and not expect_crash and code != 0:
                raise InvariantViolation(
                    f"pod proc {i} exited {code} in the fault-free "
                    f"incarnation {inc}: {self._log_tail(i)}")

    # -- the audit -----------------------------------------------------

    def _read_acked(self) -> Dict[int, Tuple[str, str]]:
        acked: Dict[int, Tuple[str, str]] = {}
        for i in range(self.plan.procs):
            path = os.path.join(self.workdir, f"acks-p{i}.log")
            if not os.path.exists(path):
                continue
            with open(path, encoding="utf-8") as f:
                for line in f:
                    parts = line.split()
                    if len(parts) == 3:
                        acked[int(parts[0])] = (parts[1], parts[2])
        return acked

    def _audit(self) -> None:
        dumps = []
        for i in range(self.plan.procs):
            path = os.path.join(self.workdir, f"dump-p{i}.json")
            try:
                with open(path, encoding="utf-8") as f:
                    dumps.append(json.load(f))
            except OSError as e:
                raise InvariantViolation(
                    f"pod proc {i} produced no audit dump: {e}")
        acked = self._read_acked()
        self.report["acked"] = len(acked)
        fold = dumps[0]["kv"]
        self.report["folded_keys"] = len(fold)
        self.report["dups_folded"] = sum(d["dups_folded"]
                                         for d in dumps)
        self.report["cut_deferred"] = self._sum_progress("deferred")
        self.report["reoffered"] = self._sum_progress("reoffered")
        # C: every host folded the identical committed state.
        for d in dumps[1:]:
            if d["kv"] != fold or d["hard_digest"] != \
                    dumps[0]["hard_digest"] or \
                    d["applied_counts"] != dumps[0]["applied_counts"]:
                raise InvariantViolation(
                    f"pod hosts DIVERGED after the audit incarnation: "
                    f"proc {d['proc_id']} folded {len(d['kv'])} keys / "
                    f"hard {d['hard_digest']}, proc 0 folded "
                    f"{len(fold)} keys / hard "
                    f"{dumps[0]['hard_digest']}")
        self.verdicts["convergence"] = "pass"
        # D: every acked (key, value) survived into the fold.
        missing = {pid: (k, v) for pid, (k, v) in acked.items()
                   if fold.get(k) != v}
        if missing:
            sample = sorted(missing.items())[:5]
            raise InvariantViolation(
                f"pod DURABILITY violated: {len(missing)} acked "
                f"writes missing from the audit fold, e.g. {sample}")
        self.verdicts["durability"] = "pass"
        # X: every key applied exactly once post-dedup (a re-offer
        # that forgot its retry token would double-apply).
        multi = {k: c for k, c in dumps[0]["applied_counts"].items()
                 if c != 1}
        if multi:
            raise InvariantViolation(
                f"pod EXACTLY-ONCE violated: keys applied more than "
                f"once post-dedup: {sorted(multi.items())[:5]}")
        self.verdicts["exactly_once"] = "pass"

    def _sum_progress(self, field: str) -> int:
        total = 0
        for name in os.listdir(self.workdir):
            if name.startswith("progress-") and name.endswith(".json"):
                try:
                    with open(os.path.join(self.workdir, name),
                              encoding="utf-8") as f:
                        total += int(json.load(f).get(field, 0))
                except (OSError, ValueError):
                    pass
        return total

    def _log_tail(self, i: int, nbytes: int = 4096) -> str:
        path = os.path.join(self.workdir, f"pod{i}.log")
        try:
            with open(path, "rb") as f:
                f.seek(0, os.SEEK_END)
                f.seek(max(0, f.tell() - nbytes))
                return f.read().decode("utf-8", "replace")
        except OSError:
            return ""

    # -- flight + digest -----------------------------------------------

    def _flight_dump(self, err: BaseException) -> None:
        from raftsql_tpu_torch.obs.flight import FlightRecorder
        bundle: dict = {"plan": self.plan.describe(),
                        "plan_digest": self.plan.digest(),
                        "report": dict(self.report), "logs": {},
                        "wal_dirs": {}}
        for i in range(self.plan.procs):
            bundle["logs"][i] = self._log_tail(i)
            d = os.path.join(self.workdir, f"h{i}")
            try:
                bundle["wal_dirs"][i] = sorted(
                    os.path.join(dp.replace(self.workdir, ""), f)
                    for dp, _dn, fs in os.walk(d) for f in fs)
            except OSError:
                bundle["wal_dirs"][i] = []
        FlightRecorder().dump(
            f"pod-seed{self.plan.seed}", repr(err), meta=bundle)

    def _verdict_digest(self) -> str:
        """What must reproduce across runs of one seed: the plan, the
        invariant verdicts, and which fault families fired (booleans —
        iteration counts are wall-clock-scheduled)."""
        r = self.report
        plan = self.plan
        doc = {
            "plan": plan.digest(),
            "invariants": dict(self.verdicts),
            "fired": {
                "noncoord_kill": r["noncoord_kills"] >= sum(
                    1 for k in plan.kills if k.proc != 0),
                "coord_kill": r["coord_kills"] >= sum(
                    1 for k in plan.kills if k.proc == 0),
                "cut_deferred": (r["cut_deferred"] > 0)
                == bool(plan.cuts),
                "pod_lost": (r["pod_lost_exits"] > 0)
                == bool(plan.kills),
                "crash_point": (r["crash_exits"] > 0)
                == (plan.crash_at >= 0),
                "unexpected_exits": r["unexpected_exits"] == 0,
            },
        }
        blob = json.dumps(doc, sort_keys=True,
                          separators=(",", ":")).encode()
        return hashlib.sha256(blob).hexdigest()[:16]

    def run(self) -> dict:
        try:
            n_fault = _fault_incarnations(self.plan)
            for inc in range(n_fault + 1):
                self._run_incarnation(inc)
            self._audit()
        except BaseException as e:
            self._flight_dump(e)
            raise
        return {"plan_digest": self.plan.digest(),
                "result_digest": self._verdict_digest(),
                "seed": self.plan.seed, **self.report}


# ======================================================================
# Child entry
# ======================================================================


def _child_main(argv) -> int:
    import argparse
    ap = argparse.ArgumentParser()
    ap.add_argument("--child", action="store_true")
    ap.add_argument("--proc-id", type=int, required=True)
    ap.add_argument("--coord", required=True)
    ap.add_argument("--workdir", required=True)
    ap.add_argument("--incarnation", type=int, required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    with open(os.path.join(args.workdir, "plan.json"),
              encoding="utf-8") as f:
        plan = _plan_from_doc(json.load(f))
    child = _PodChild(plan, args.proc_id, args.coord, args.workdir,
                      args.incarnation, device=args.device)
    return child.run()


if __name__ == "__main__":
    sys.exit(_child_main(sys.argv[1:]))
