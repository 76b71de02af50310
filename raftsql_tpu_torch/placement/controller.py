"""The placement controller: EWMA traffic in, leadership transfers out.

Copy of raftsql_tpu/placement/controller.py for the PyTorch port (pure
Python and numpy); the controller never touches device state, its
keyspace verbs (split-hottest, merge-coldest) included.

One pass (`evaluate()`, driven by a daemon thread at `interval_s`):

  1. Snapshot the per-group EWMA propose rates (GroupTraffic) and the
     current leader hints.  Groups whose leader is unknown are skipped —
     an election is already in progress and moving leadership would
     only add churn.
  2. Partition groups into balance DOMAINS: one per mesh group shard
     when the runtime shards groups (`_group_shard_of`), else one
     global domain.  Leadership can only move between peers, never
     between shards (a group's shard is a static device layout), so
     each shard's peer spread is balanced independently.
  3. In each domain, compute per-peer load = sum of rates of the groups
     that peer leads.  When the hottest peer carries more than
     `imbalance` times the coldest (+ the `min_rate` floor so an idle
     cluster never churns), pick the hottest group on the hot peer
     whose move IMPROVES the spread (rate ≤ half the gap — guards
     against ping-pong) and issue one transfer toward the coldest
     peer.
  4. Refused/failed transfers back off exponentially per group
     (`backoff_s` doubling to `backoff_cap_s`), so a learner-only
     target or a group mid-election cannot be hammered.

At most one transfer is issued per pass per domain; the engine's own
one-in-flight-per-group latch bounds concurrency below that.  The
controller never touches device state — it only calls the engine's
transfer_leadership, which validates and arms on the tick thread.
"""
from __future__ import annotations

import logging
import threading
import time
from collections import deque
from typing import Dict, List, Optional

import numpy as np

log = logging.getLogger("raftsql_tpu_torch.placement")


class PlacementController:
    """Balance leadership of hot groups across peers.

    `node` is any engine exposing `traffic` (GroupTraffic),
    `leader_of(g)`, `transfer_leadership(g, target)`, and (optionally)
    `_group_shard_of(g)` + `transfers_doc()` — i.e. the fused/mesh
    host plane, or a RaftNode when an external feed stamps its traffic.
    """

    def __init__(self, node, interval_s: float = 0.5,
                 imbalance: float = 2.0, min_rate: float = 1.0,
                 backoff_s: float = 2.0, backoff_cap_s: float = 30.0,
                 log_cap: int = 128):
        self.node = node
        self.interval_s = float(interval_s)
        self.imbalance = float(imbalance)
        self.min_rate = float(min_rate)
        self.backoff_s = float(backoff_s)
        self.backoff_cap_s = float(backoff_cap_s)
        self.decisions: deque = deque(maxlen=log_cap)
        self.issued = 0
        self.refused = 0
        self.last_imbalance = 0.0
        # Per-group retry state: group -> (not-before monotonic time,
        # current backoff seconds).
        self._backoff: Dict[int, tuple] = {}
        # Elastic-keyspace plane (raftsql_tpu_torch/reshard/plane.py),
        # attached by the server when both --placement and --reshard
        # are on: enables the split-hottest / merge-coldest verbs.
        self.reshard = None
        self.reshard_issued = 0
        self.reshard_refused = 0
        self._seen_outcome_tick = -1
        self._mu = threading.Lock()
        self._stop_evt = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- lifecycle ------------------------------------------------------

    def start(self) -> None:
        if self._thread is not None:
            return
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="placement")
        self._thread.start()

    def stop(self) -> None:
        self._stop_evt.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None

    def _run(self) -> None:
        while not self._stop_evt.wait(self.interval_s):
            try:
                self.evaluate()
            except Exception:                       # noqa: BLE001
                # The controller is an optimizer, never a liveness
                # dependency: a failed pass logs and the next runs.
                log.exception("placement pass failed")

    # -- one balancing pass ---------------------------------------------

    def _domains(self, G: int) -> Dict[int, List[int]]:
        shard_of = getattr(self.node, "_group_shard_of", None)
        if not callable(shard_of):
            return {0: list(range(G))}
        out: Dict[int, List[int]] = {}
        for g in range(G):
            out.setdefault(int(shard_of(g)), []).append(g)
        return out

    def _absorb_outcomes(self) -> None:
        """Stamp finished transfers' outcome + stall ticks back onto
        the issued decisions (flight-bundle attribution)."""
        fn = getattr(self.node, "transfers_doc", None)
        if fn is None:
            return
        for ev in fn().get("recent", ()):
            t = int(ev.get("tick", -1))
            if t <= self._seen_outcome_tick:
                continue
            for d in reversed(self.decisions):
                if (d["group"] == ev["group"] and d["to"] == ev["to"]
                        and d["outcome"] == "pending"):
                    d["outcome"] = ev["outcome"]
                    d["stall_ticks"] = ev.get("stall_ticks")
                    break
            self._seen_outcome_tick = max(self._seen_outcome_tick, t)

    def evaluate(self) -> Optional[dict]:
        """One balancing pass; returns the decision issued (or None).
        Thread-safe against concurrent passes (tests may drive it
        directly while the thread runs)."""
        with self._mu:
            return self._evaluate_locked()

    def _evaluate_locked(self) -> Optional[dict]:
        node = self.node
        traffic = getattr(node, "traffic", None)
        if traffic is None:
            return None
        self._absorb_outcomes()
        with traffic._mu:
            traffic._advance_rates_locked()
            rates = traffic._rate_p.copy()
        G = traffic.num_groups
        P = node.cfg.num_peers
        leaders = np.array([int(node.leader_of(g)) for g in range(G)])
        now = time.monotonic()
        decision = None
        pass_gap = 0.0
        for dom, groups in self._domains(G).items():
            loads = np.zeros(P)
            for g in groups:
                if leaders[g] >= 0:
                    loads[leaders[g]] += rates[g]
            hot_p = int(np.argmax(loads))
            sel = loads
            wit = getattr(node.cfg, "witness_set", frozenset())
            if wit:
                # A witness never leads, so it is always the idlest
                # slot — and never a legal transfer destination
                # (transfer_leadership would refuse it anyway; don't
                # even nominate it, or every pass burns a refusal).
                sel = loads.copy()
                sel[sorted(wit)] = np.inf
            cold_p = int(np.argmin(sel))
            if not np.isfinite(sel[cold_p]):
                continue            # every non-hot slot is a witness
            gap = loads[hot_p] - loads[cold_p]
            pass_gap = max(pass_gap, float(gap))
            if loads[hot_p] < self.min_rate \
                    or loads[hot_p] < self.imbalance * max(
                        loads[cold_p], self.min_rate / self.imbalance):
                continue
            # Hottest movable group on the hot peer whose rate fits
            # inside half the gap (the move must shrink the spread).
            cand = sorted((g for g in groups if leaders[g] == hot_p
                           and rates[g] > 0),
                          key=lambda g: -rates[g])
            for g in cand:
                nb = self._backoff.get(g)
                if nb is not None and now < nb[0]:
                    continue
                if rates[g] > gap / 2 + 1e-9:
                    continue
                decision = self._issue(g, hot_p, cold_p,
                                       float(rates[g]))
                break
            if decision is not None:
                break           # one transfer per pass
        self.last_imbalance = pass_gap
        return decision

    def _issue(self, g: int, frm: int, to: int, rate: float) -> dict:
        d = {"group": int(g), "from": frm + 1, "to": to + 1,
             "rate": round(rate, 3), "outcome": "pending",
             "stall_ticks": None, "at": time.time()}
        try:
            self.node.transfer_leadership(g, to)
            self.issued += 1
            self._backoff.pop(g, None)
        except Exception as e:                      # noqa: BLE001
            # Refused (in-flight, learner target, leadership moved
            # under us): exponential per-group backoff, try others.
            self.refused += 1
            d["outcome"] = f"refused: {e}"
            prev = self._backoff.get(g)
            b = min(prev[1] * 2 if prev else self.backoff_s,
                    self.backoff_cap_s)
            self._backoff[g] = (time.monotonic() + b, b)
        self.decisions.append(d)
        return d

    # -- elastic-keyspace verbs (raftsql_tpu_torch/reshard/) ------------------

    def _group_rates(self):
        """(rates ndarray, live group list) from the traffic EWMA and
        the reshard plane's keymap, or None without both planes."""
        traffic = getattr(self.node, "traffic", None)
        if traffic is None or self.reshard is None:
            return None
        with traffic._mu:
            traffic._advance_rates_locked()
            rates = traffic._rate_p.copy()
        live = sorted(self.reshard.keymap.live_groups())
        return rates, live

    def split_hottest(self) -> Optional[dict]:
        """Rebalance the KEYSPACE, not just leadership: carve half of
        the hottest group's hash slots out to the least-loaded group
        (preferring a retired group id, which re-enters service).
        Returns the enqueued verb doc, or None when nothing qualifies;
        refusals (verb in flight) count and return None."""
        got = self._group_rates()
        if got is None:
            return None
        rates, live = got
        km = self.reshard.keymap
        cand = [g for g in live if len(km.slots_of(g)) >= 2]
        if not cand:
            return None
        src = max(cand, key=lambda g: (float(rates[g]), -g))
        retired = sorted(km.retired)
        if retired:
            dst = retired[0]
        else:
            others = [g for g in live if g != src]
            if not others:
                return None
            dst = min(others, key=lambda g: (float(rates[g]), g))
        owned = km.slots_of(src)
        hits = getattr(self.reshard, "slot_hits", None)
        if hits and any(hits[s] for s in owned):
            # Traffic-weighted partition: halving by slot COUNT under a
            # skewed workload can hand the hot slots themselves to dst,
            # crowning it the new hottest group (the zipfian demo in
            # scripts/bench_reshard.py regresses exactly that way).
            # Greedy heaviest-first into the lighter of keep/move bins
            # splits the observed per-slot load instead; with >= 2
            # owned slots and a nonzero total both bins end non-empty.
            keep = [0, []]
            move = [0, []]
            for s in sorted(owned, key=lambda s: (-hits[s], s)):
                b = keep if keep[0] <= move[0] else move
                b[0] += hits[s]
                b[1].append(s)
            slots = move[1]
        else:
            # No per-slot signal (plane without counters, or a cold
            # group picked by the rate EWMA alone): halve by count.
            slots = owned[:len(owned) // 2]
        try:
            doc = self.reshard.enqueue("split", src, dst, slots)
            self.reshard_issued += 1
            return doc
        except Exception as e:                      # noqa: BLE001
            self.reshard_refused += 1
            log.info("split-hottest refused: %s", e)
            return None

    def merge_coldest(self) -> Optional[dict]:
        """Fold the coldest group's slots into the next-coldest live
        group and retire its id (shrink G under a fading keyspace)."""
        got = self._group_rates()
        if got is None:
            return None
        rates, live = got
        if len(live) < 2:
            return None
        src = min(live, key=lambda g: (float(rates[g]), g))
        rest = [g for g in live if g != src]
        dst = min(rest, key=lambda g: (float(rates[g]), g))
        try:
            doc = self.reshard.enqueue("merge", src, dst)
            self.reshard_issued += 1
            return doc
        except Exception as e:                      # noqa: BLE001
            self.reshard_refused += 1
            log.info("merge-coldest refused: %s", e)
            return None

    # -- exports --------------------------------------------------------

    def doc(self) -> dict:
        """Flight-bundle attachment: the recent decision log (group,
        from, to, outcome, stall ticks) plus issue counters."""
        with self._mu:
            self._absorb_outcomes()
            return {"issued": self.issued, "refused": self.refused,
                    "last_imbalance": round(self.last_imbalance, 3),
                    "decisions": [dict(d) for d in self.decisions]}

    def metrics_doc(self) -> dict:
        """Numeric gauges for /metrics (prom-renderable leaves only)."""
        return {"issued": self.issued, "refused": self.refused,
                "last_imbalance": round(self.last_imbalance, 3),
                "backoff_groups": len(self._backoff),
                "reshard_issued": self.reshard_issued,
                "reshard_refused": self.reshard_refused}
