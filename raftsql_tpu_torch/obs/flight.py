"""Chaos flight recorder: turn an invariant failure into a post-mortem.

The chaos harness already makes every failure REPRODUCIBLE (the seed
pins the schedule); this makes it READABLE: when an invariant trips,
the runner dumps the last N ticks of device-plane events plus the
host-plane spans — the exact per-tick timeline leading into the
violation — as one JSON artifact next to the failing seed, so whoever
reads the failure starts from a trace, not from a re-run under a
debugger.

The dump directory defaults to the current directory and is overridden
by RAFTSQL_FLIGHT_DIR (tests point it at a tmp dir).  Dump failures
never mask the invariant error — the recorder logs and returns None.
"""
from __future__ import annotations

import json
import logging
import os
import time
from typing import Optional

log = logging.getLogger("raftsql_tpu_torch.obs.flight")


class FlightRecorder:
    def __init__(self, directory: Optional[str] = None,
                 last_ticks: int = 64):
        self.directory = directory or os.environ.get(
            "RAFTSQL_FLIGHT_DIR", ".")
        self.last_ticks = last_ticks

    def dump(self, name: str, reason: str, tracer=None, ring=None,
             meta: Optional[dict] = None, node=None,
             ring_server=None, placement=None) -> Optional[str]:
        """Write flight-<name>.json; returns the path, or None if the
        write failed (never raises — the invariant error must win).

        `node` (a ClusterHostPlane) adds the SERVING-PLANE state the
        serving stack crashes with: the double-buffered overlap
        stash's status at crash time (was a durable phase in flight,
        and for which tick?), the WAL group-commit batch histogram,
        and the tick-phase profile — plus the transfer plane's
        in-flight latches and recent outcomes.  `ring_server`
        (runtime/ring.py RingServer) adds per-worker propose/completion
        ring cursors and depths.  `placement` (a PlacementController)
        attaches the controller's recent decision log (group, from, to,
        outcome, stall ticks), so a failed transfer invariant is
        attributable to the decision that caused it."""
        doc = {
            "reason": reason,
            "wall_time": time.strftime("%Y-%m-%dT%H:%M:%S"),
            "meta": meta or {},
            "device_events": [],
            "host_spans": {},
        }
        try:
            if ring is not None:
                ring.drain()
                doc["device_events"] = ring.rows(last=self.last_ticks)
            if tracer is not None:
                doc["host_spans"] = tracer.snapshot()
            if node is not None:
                doc["serving"] = self._serving_state(node)
            if ring_server is not None:
                doc.setdefault("serving", {})["rings"] = \
                    ring_server.flight_doc()
            if placement is not None:
                doc["placement"] = placement.doc()
        except Exception as e:      # noqa: BLE001 - diagnostics only
            doc["collect_error"] = repr(e)
        path = os.path.join(self.directory, f"flight-{name}.json")
        try:
            os.makedirs(self.directory, exist_ok=True)
            with open(path, "w", encoding="utf-8") as f:
                json.dump(doc, f, sort_keys=True)
        except OSError as e:
            log.warning("flight-recorder dump to %s failed: %s", path, e)
            return None
        log.warning("flight-recorder dump: %s (%s)", path, reason)
        return path

    @staticmethod
    def _serving_state(node) -> dict:
        """Serving-plane snapshot off a ClusterHostPlane (every field
        getattr-guarded: older/foreign engines just contribute less)."""
        out: dict = {}
        stash = getattr(node, "_stash", None)
        overlap = {"enabled": bool(getattr(node, "_overlap", False)),
                   "stashed": stash is not None}
        if stash is not None:
            try:
                _infos, staged, stick = stash
                overlap["stash_tick"] = int(stick)
                # Entries whose durable phase had NOT yet retired — the
                # exact set a crash at this instant would lose.
                overlap["stash_entries"] = int(sum(
                    len(per_peer[4]) for step in staged
                    for per_peer in step))
            except Exception:       # noqa: BLE001 - diagnostics only
                pass
        out["overlap"] = overlap
        gcw = getattr(node, "_gcwal", None)
        if gcw is not None:
            out["wal_group_commit"] = {
                "group_commits": gcw.group_commits,
                "batch_hist": {str(k): v for k, v in
                               sorted(gcw.batch_hist.items())}}
        prof = getattr(node, "prof", None)
        if prof is not None:
            out["phase_profile"] = prof.snapshot()
        traffic = getattr(node, "traffic", None)
        if traffic is not None:
            xg = getattr(node, "transferring_groups", None)
            out["group_traffic"] = traffic.doc(
                leader_of=getattr(node, "leader_of", None),
                transferring=xg() if callable(xg) else None)
        xfers = getattr(node, "transfers_doc", None)
        if callable(xfers):
            out["transfers"] = xfers()
        return out
