"""Elastic keyspace: split/merge/migrate over the fixed device plane.

The compiled [P, G] device kernels keep a boot-time G; elasticity lives
one layer up.  Keys hash onto a fixed ring of slots and a versioned
`KeyMap` (slot -> group, epoch-stamped) decides which raft group owns
each slot.  The reshard coordinator moves slots between groups with
three multi-step verbs — SPLIT, MERGE, MIGRATE — journaled through the
raft logs themselves, so a coordinator killed at any step resumes (or
aborts cleanly) from the journal fold, never half-applies.

Port of raftsql_tpu/reshard/ (pure Python; no module of the plane
touches device state).  Slot numbers, keymap documents and journal
strings are the JAX package's byte for byte: they are replicated
through the raft logs and stored in each group's `_reshard_journal`
table, a format both packages' data dirs share.
"""
from .keymap import KeyMap, slot_of
from .journal import (JournalRecord, decode_record, encode_record,
                      fold_records)
from .coordinator import ReshardCoordinator, ReshardRefused
from .fork import fork_by_slots
from .plane import FrozenSlot, ReshardPlane, WrongEpoch

__all__ = [
    "KeyMap", "slot_of",
    "JournalRecord", "encode_record", "decode_record", "fold_records",
    "ReshardCoordinator", "ReshardRefused",
    "fork_by_slots",
    "ReshardPlane", "WrongEpoch", "FrozenSlot",
]
