"""In-memory key-value state machine.

A second state-machine family behind models.base.StateMachine: no SQLite,
no disk — used by benchmarks (apply cost ≈ 0 isolates consensus
throughput) and by chaos tests that compare replica states directly.

Commands:  ``SET <key> <value>`` / ``DEL <key>``
Queries:   ``GET <key>`` → value or empty; ``KEYS`` → sorted keys.
"""
from __future__ import annotations

import threading
from typing import Dict, Optional


class KVStateMachine:
    # _applied is volatile: a restart loses it, so it must never be used
    # as a WAL-compaction floor (runtime/db.py gates on this flag).
    has_durable_snapshot = False

    def __init__(self, path: str = ""):
        self._data: Dict[str, str] = {}
        self._lock = threading.Lock()
        self._applied = 0   # volatile — KV has no durable snapshot

    def applied_index(self) -> int:
        return self._applied

    def apply(self, command: str, index: int = 0) -> Optional[Exception]:
        parts = command.split(" ", 2)
        with self._lock:
            if index and index <= self._applied:
                return None     # already covered (e.g. by an install)
            try:
                if parts[0] == "SET" and len(parts) == 3:
                    self._data[parts[1]] = parts[2]
                elif parts[0] == "DEL" and len(parts) == 2:
                    self._data.pop(parts[1], None)
                else:
                    return ValueError(f"bad command: {command!r}")
                return None
            except Exception as e:     # pragma: no cover - defensive
                return e
            finally:
                if index:
                    self._applied = index

    def apply_batch(self, items) -> list:
        """Batched apply: one lock hold for [(command, index), ...] in
        commit order — the apply layer's group-commit path (runtime/db.py
        _apply_run prefers this; per-item apply() paid a lock round trip
        per entry at durable-bench saturation)."""
        errs = []
        with self._lock:
            data = self._data
            applied = self._applied
            for command, index in items:
                if index and index <= applied:
                    errs.append(None)
                    continue
                parts = command.split(" ", 2)
                if parts[0] == "SET" and len(parts) == 3:
                    data[parts[1]] = parts[2]
                    errs.append(None)
                elif parts[0] == "DEL" and len(parts) == 2:
                    data.pop(parts[1], None)
                    errs.append(None)
                else:
                    errs.append(ValueError(f"bad command: {command!r}"))
                if index:
                    applied = index
            self._applied = applied
        return errs

    def query(self, q: str) -> str:
        parts = q.split(" ", 1)
        with self._lock:
            if parts[0] == "GET" and len(parts) == 2:
                return self._data.get(parts[1], "")
            if parts[0] == "KEYS":
                return "\n".join(sorted(self._data))
        raise ValueError(f"bad query: {q!r}")

    def snapshot(self) -> Dict[str, str]:
        with self._lock:
            return dict(self._data)

    def serialize(self) -> bytes:
        import json
        with self._lock:
            return json.dumps(self._data).encode()

    def serialize_with_index(self):
        import json
        with self._lock:
            return self._applied, json.dumps(self._data).encode()

    def install(self, blob: bytes, index: int) -> None:
        import json
        with self._lock:
            self._data = json.loads(blob.decode())
            self._applied = index

    def close(self) -> None:
        pass
