"""ctypes wrapper for the C++ KV apply plane (native/wal.cc kv_*).

The Python-resident durable path tops out on per-entry object handling:
every committed payload becomes a bytes object, a decoded str, a tuple,
and a dict op.  The native plane applies committed RANGES directly from
the native payload log — commands are parsed and applied inside one C
call per publish, and Python only moves [ranges]-shaped numpy columns.

Grammar parity with models/kv_sm.py KVStateMachine.apply ("SET <key>
<value>" / "DEL <key>", exactly-once via the per-group applied index) is
pinned by tests/test_torch_native_kv.py, which races this plane against
both packages' KVStateMachine on the same command stream.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import numpy as np


class NativeKV:
    has_durable_snapshot = False

    def __init__(self, num_groups: int, lib):
        """`lib` is the handle from native.build.load_native_plog()
        (the kv_* entry points share the WAL shared object)."""
        self._lib = lib
        self._h = lib.kv_new(num_groups)
        if not self._h:
            raise MemoryError("kv_new failed")
        self.num_groups = num_groups
        self.bad_commands = 0
        self.total_applied = 0    # sum of apply_plog return values

    def apply_plog(self, plog_handle, groups, starts, counts) -> int:
        """Apply entries [starts[r], starts[r]+counts[r]) of groups[r]
        read in place from the native payload log; returns the number
        applied (non-empty, not-yet-applied).  Bad commands accumulate
        in self.bad_commands (KV parity: per-entry error, batch goes
        on)."""
        n = len(groups)
        if n == 0:
            return 0
        ga = np.asarray(groups, np.uint32)
        sa = np.asarray(starts, np.uint64)
        ca = np.asarray(counts, np.uint32)
        bad = ctypes.c_uint64(0)
        done = self._lib.kv_apply_plog(
            self._h, plog_handle, n,
            ga.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
            sa.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
            ca.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
            ctypes.byref(bad))
        self.bad_commands += bad.value
        if done == 0xFFFFFFFFFFFFFFFF:
            # Same fault and same contract as the Python publish path:
            # a committed index has no payload-log backing.  applied[]
            # reflects the pre-fault work, so nothing double-applies.
            raise RuntimeError("native KV: payload log shorter than "
                               "commit")
        self.total_applied += int(done)
        return int(done)

    def applied_index(self, group: int) -> int:
        return int(self._lib.kv_applied(self._h, group))

    def count(self, group: int) -> int:
        return int(self._lib.kv_count(self._h, group))

    def get(self, group: int, key: str) -> Optional[str]:
        kb = key.encode("utf-8")
        cap = 256
        while True:
            buf = (ctypes.c_uint8 * cap)()
            ln = self._lib.kv_get(self._h, group, kb, len(kb), buf, cap)
            if ln < 0:
                return None
            if ln <= cap:
                return bytes(buf[:ln]).decode("utf-8")
            cap = ln  # buffer was too small; retry at the exact size

    def query(self, group: int, q: str) -> str:
        """GET-<key> query parity for tests (KEYS is not exported by the
        C plane; replica comparison uses count() + spot gets)."""
        parts = q.split(" ", 1)
        if parts[0] == "GET" and len(parts) == 2:
            return self.get(group, parts[1]) or ""
        raise ValueError(f"bad query: {q!r}")

    def close(self) -> None:
        if self._h:
            self._lib.kv_free(self._h)
            self._h = None

    def __del__(self):  # pragma: no cover - GC ordering
        try:
            self.close()
        except Exception:
            pass


def new_native_kv(num_groups: int) -> Optional[Tuple[NativeKV, object]]:
    """(NativeKV, lib); None under RAFTSQL_TPU_NATIVE=0.  A failed build
    or load of the native plane raises (native/build.py)."""
    from raftsql_tpu_torch.native.build import load_native_plog
    lib = load_native_plog()
    if lib is None:
        return None
    return NativeKV(num_groups, lib), lib
