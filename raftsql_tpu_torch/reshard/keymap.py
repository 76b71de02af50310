"""Versioned key->group mapping: the router state of the elastic keyspace.

Keys hash onto a fixed ring of NSLOTS slots (crc32, Redis-cluster
style); the KeyMap assigns each slot to a raft group and stamps every
change with a monotonically increasing epoch.  The map itself is
DERIVED state: it can always be rebuilt by folding the reshard journal
records out of the raft logs (journal.fold_records), which is what
makes the coordinator crash-recoverable — the router never holds truth
the logs don't.

Consumers fail closed on epoch mismatch: a client or shm reader that
pinned epoch E refuses to serve a key once the published epoch moved,
and refreshes from /healthz instead of guessing.

Copy of raftsql_tpu/reshard/keymap.py: `slot_of` and the keymap
document are the JAX package's, byte for byte.
"""
from __future__ import annotations

import zlib
from typing import Dict, Iterable, List, Set

DEFAULT_NSLOTS = 64


def slot_of(key: str, nslots: int = DEFAULT_NSLOTS) -> int:
    """Stable hash slot for a key (crc32 mod nslots)."""
    return zlib.crc32(key.encode("utf-8")) % nslots


class KeyMap:
    """slot -> group assignment with an epoch that bumps on every change.

    Mutating verbs (`move`, `retire`) bump the epoch; `freeze` /
    `unfreeze` mark slots whose ownership is in flight (intake refused)
    without bumping it — freezing is coordinator-local hygiene, not a
    routing change.
    """

    def __init__(self, nslots: int, slots: List[int], epoch: int = 0,
                 retired: Iterable[int] = ()):
        if len(slots) != nslots:
            raise ValueError("slot table length != nslots")
        self.nslots = int(nslots)
        self.slots = list(int(g) for g in slots)
        self.epoch = int(epoch)
        self.retired: Set[int] = set(int(g) for g in retired)
        self.frozen: Set[int] = set()

    # -- construction ------------------------------------------------
    @classmethod
    def initial(cls, num_groups: int, nslots: int = DEFAULT_NSLOTS) -> "KeyMap":
        """Boot-time map: slot s -> group s mod G (uniform stripe)."""
        return cls(nslots, [s % num_groups for s in range(nslots)], epoch=0)

    def copy(self) -> "KeyMap":
        km = KeyMap(self.nslots, self.slots, self.epoch, self.retired)
        km.frozen = set(self.frozen)
        return km

    # -- routing -----------------------------------------------------
    def slot_of(self, key: str) -> int:
        return slot_of(key, self.nslots)

    def group_of(self, key: str) -> int:
        return self.slots[self.slot_of(key)]

    def slots_of(self, group: int) -> List[int]:
        return [s for s, g in enumerate(self.slots) if g == group]

    def is_frozen(self, key: str) -> bool:
        return self.slot_of(key) in self.frozen

    def live_groups(self) -> List[int]:
        return sorted(set(self.slots) - self.retired)

    # -- mutation (coordinator only) ---------------------------------
    def move(self, slots: Iterable[int], dst: int) -> int:
        """Reassign `slots` to group `dst`; returns the new epoch."""
        for s in slots:
            self.slots[int(s)] = int(dst)
        self.retired.discard(int(dst))
        self.epoch += 1
        return self.epoch

    def retire(self, group: int) -> int:
        """Mark a group as holding no slots (post-merge).  The device
        plane keeps ticking the group; the router just never sends it
        keys until a future split revives it."""
        if any(g == group for g in self.slots):
            raise ValueError("cannot retire a group that still owns slots")
        self.retired.add(int(group))
        self.epoch += 1
        return self.epoch

    def freeze(self, slots: Iterable[int]) -> None:
        self.frozen.update(int(s) for s in slots)

    def unfreeze(self, slots: Iterable[int]) -> None:
        self.frozen.difference_update(int(s) for s in slots)

    # -- wire form ---------------------------------------------------
    def to_doc(self) -> Dict:
        return {
            "epoch": self.epoch,
            "nslots": self.nslots,
            "slots": list(self.slots),
            "retired": sorted(self.retired),
            "frozen": sorted(self.frozen),
        }

    @classmethod
    def from_doc(cls, doc: Dict) -> "KeyMap":
        km = cls(int(doc["nslots"]), [int(g) for g in doc["slots"]],
                 epoch=int(doc["epoch"]), retired=doc.get("retired", ()))
        km.frozen = set(int(s) for s in doc.get("frozen", ()))
        return km
