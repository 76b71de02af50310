"""Reshard journal: verb steps as ordinary replicated log entries.

Every step of a reshard verb is journaled by proposing a marker entry
through the SOURCE group's raft log (the "split entry" of the paper
sketch): `RJ!{json}`.  The journal is therefore exactly as durable and
as ordered as the data it governs — there is no side file that can
disagree with the logs after a crash.  A restarted coordinator folds
the applied journal records back into (keymap, active-verb) and resumes
the verb from its last journaled step, or aborts it if the copy phase
never completed.

Record shape (all fields ints except strings noted):
  {"id": verb-id (monotone), "verb": "split"|"merge"|"migrate",
   "step": "begin"|"copied"|"shipped"|"flip"|"done"|"abort",
   "src": group, "dst": group-or-peer, "slots": [slot...],
   "nslots": ring size}

The companion `RD!{json}` record is a range-delete command: the group
applying it deletes every key whose slot is listed (cleanup on the
source after a flip, or undo of partial copies on the destination
after an abort).

Copy of raftsql_tpu/reshard/journal.py: the record strings are the
JAX package's, byte for byte.
"""
from __future__ import annotations

import json
from typing import Dict, Iterable, Optional, Tuple

from .keymap import KeyMap

JOURNAL_PREFIX = "RJ!"
RDEL_PREFIX = "RD!"

# Step vocabulary, in verb order.  "copied" is only journaled once the
# destination group has APPLIED every copied row — journaling it is the
# durability fence the router flip waits behind.
STEPS = ("begin", "copied", "shipped", "flip", "done", "abort")
TERMINAL = ("done", "abort")


class JournalRecord(dict):
    """A journal record is a plain dict; this subclass only exists to
    give isinstance checks a name."""


def encode_record(rec: Dict) -> str:
    return JOURNAL_PREFIX + json.dumps(rec, sort_keys=True,
                                       separators=(",", ":"))


def decode_record(payload) -> Optional[Dict]:
    """Parse an `RJ!` journal payload; None if it is not one."""
    if isinstance(payload, (bytes, bytearray)):
        try:
            payload = payload.decode("utf-8")
        except UnicodeDecodeError:
            return None
    if not isinstance(payload, str) or not payload.startswith(JOURNAL_PREFIX):
        return None
    try:
        rec = json.loads(payload[len(JOURNAL_PREFIX):])
    except ValueError:
        return None
    return rec if isinstance(rec, dict) and "step" in rec else None


def encode_rdel(slots: Iterable[int], nslots: int, verb_id: int) -> str:
    return RDEL_PREFIX + json.dumps(
        {"id": int(verb_id), "slots": sorted(int(s) for s in slots),
         "nslots": int(nslots)},
        sort_keys=True, separators=(",", ":"))


def decode_rdel(payload) -> Optional[Dict]:
    if isinstance(payload, (bytes, bytearray)):
        try:
            payload = payload.decode("utf-8")
        except UnicodeDecodeError:
            return None
    if not isinstance(payload, str) or not payload.startswith(RDEL_PREFIX):
        return None
    try:
        doc = json.loads(payload[len(RDEL_PREFIX):])
    except ValueError:
        return None
    return doc if isinstance(doc, dict) and "slots" in doc else None


def fold_records(records: Iterable[Dict], num_groups: int,
                 nslots: int) -> Tuple[KeyMap, Optional[Dict]]:
    """Fold applied journal records into (keymap, active_verb).

    `records` may arrive in any order and contain duplicates (a nervous
    coordinator re-proposes idempotently); the fold sorts by (id, step
    rank) and collapses repeats.  `active_verb` is the latest verb with
    no terminal record — the verb a restarted coordinator must resume
    or abort — as {"id", "verb", "src", "dst", "slots", "steps": set}.
    """
    by_id: Dict[int, Dict] = {}
    for rec in records:
        if rec is None or "id" not in rec:
            continue
        vid = int(rec["id"])
        slot = by_id.setdefault(vid, {"id": vid, "steps": set()})
        slot["steps"].add(rec["step"])
        for k in ("verb", "src", "dst", "slots"):
            if k in rec:
                slot.setdefault(k, rec[k])
    km = KeyMap.initial(num_groups, nslots)
    km.epoch = 0
    active: Optional[Dict] = None
    for vid in sorted(by_id):
        v = by_id[vid]
        steps = v["steps"]
        if "flip" in steps:
            km.move(v.get("slots", ()), int(v["dst"]))
            if v.get("verb") == "merge":
                try:
                    km.retire(int(v["src"]))
                except ValueError:
                    pass        # src re-acquired slots in a later verb
        if not steps & set(TERMINAL):
            active = v          # at most one in flight; latest wins
    if active is not None and "flip" not in active["steps"] \
            and active.get("verb") != "migrate":
        km.freeze(active.get("slots", ()))
    return km, active
