"""The port's C++ KV apply plane (native/wal.cc kv_*, models/kv_native.py)
— the port's copy of tests/test_native_kv.py (parity with the Python
KVStateMachine and end-to-end behaviour on the fused runtime), plus the
command-grammar race of the port's NativeKV against the JAX package's
KVStateMachine and the port's own."""
import random

import pytest
import torch

from raftsql_tpu.models.kv_sm import KVStateMachine as JKVStateMachine
from raftsql_tpu_torch.models.kv_sm import KVStateMachine

torch.set_num_threads(1)


@pytest.fixture()
def nat():
    from raftsql_tpu_torch.native.build import load_native_plog
    lib = load_native_plog()
    assert lib is not None          # a failed build raises instead
    return lib


def _mk_plog(lib, num_groups):
    from raftsql_tpu_torch.storage.log import NativePayloadLog
    return NativePayloadLog(num_groups, lib)


class TestKvParity:
    def test_command_grammar_matches_python_sm(self, nat):
        """Race the two planes over a randomized command stream —
        including the grammar edges (empty values/keys, extra spaces,
        bad commands) — and compare final states key by key."""
        from raftsql_tpu_torch.models.kv_native import NativeKV

        rng = random.Random(7)
        cmds = []
        for i in range(400):
            r = rng.random()
            if r < 0.5:
                cmds.append(f"SET k{rng.randrange(40)} v{i} with spaces")
            elif r < 0.65:
                cmds.append(f"SET k{rng.randrange(40)} ")   # empty value
            elif r < 0.8:
                cmds.append(f"DEL k{rng.randrange(40)}")
            elif r < 0.85:
                cmds.append("SET onlykey")                  # bad
            elif r < 0.9:
                cmds.append("DEL two tokens")               # bad
            elif r < 0.95:
                cmds.append("NOP whatever")                 # bad
            else:
                cmds.append("SET  leading")   # empty key, value ok

        py = KVStateMachine()
        n_bad = 0
        for i, c in enumerate(cmds):
            if py.apply(c, i + 1) is not None:
                n_bad += 1

        plog = _mk_plog(nat, 1)
        plog.put(0, 1, [c.encode() for c in cmds], [1] * len(cmds))
        kv = NativeKV(1, nat)
        done = kv.apply_plog(plog.handle, [0], [1], [len(cmds)])
        assert kv.bad_commands == n_bad
        assert done == len(cmds) - n_bad
        snap = py.snapshot()
        assert kv.count(0) == len(snap)
        for k, v in snap.items():
            assert kv.get(0, k) == v, k
        kv.close()
        plog.close()

    def test_exactly_once_on_overlapping_ranges(self, nat):
        from raftsql_tpu_torch.models.kv_native import NativeKV

        plog = _mk_plog(nat, 2)
        plog.put(1, 1, [b"SET a 1", b"SET a 2", b"", b"SET b 3"],
                 [1, 1, 1, 1])
        kv = NativeKV(2, nat)
        assert kv.apply_plog(plog.handle, [1], [1], [4]) == 3
        assert kv.applied_index(1) == 4
        # Re-applying the same (or a prefix) range is a no-op.
        assert kv.apply_plog(plog.handle, [1], [1], [4]) == 0
        assert kv.apply_plog(plog.handle, [1], [2], [2]) == 0
        assert kv.get(1, "a") == "2" and kv.get(1, "b") == "3"
        # Empty payloads (no-op entries) advance applied, apply nothing.
        assert kv.count(1) == 2
        kv.close()
        plog.close()

    def test_out_of_window_raises_like_python_path(self, nat):
        """A committed index with no payload-log backing is a fault,
        not a silent truncation: the wrapper raises (the Python publish
        path's 'payload log shorter than commit' contract) and the work
        done before the fault is recorded, so a repaired retry does not
        double-apply."""
        from raftsql_tpu_torch.models.kv_native import NativeKV

        plog = _mk_plog(nat, 2)
        plog.put(0, 1, [b"SET a 1", b"SET a 2"], [1, 1])
        kv = NativeKV(2, nat)
        with pytest.raises(RuntimeError):
            kv.apply_plog(plog.handle, [0, 1], [1, 1], [5, 1])
        # Entries 1-2 applied before the fault; applied[] reflects it.
        assert kv.applied_index(0) == 2
        assert kv.get(0, "a") == "2"
        assert kv.total_applied == 0      # faulted batch not counted
        # Repair the log and retry the batch: only the new entries run.
        plog.put(0, 3, [b"SET a 3", b"", b"SET b 9"], [1, 1, 1])
        plog.put(1, 1, [b"SET c 7"], [1])
        assert kv.apply_plog(plog.handle, [0, 1], [1, 1], [5, 1]) == 3
        assert kv.get(0, "a") == "3" and kv.get(0, "b") == "9"
        assert kv.get(1, "c") == "7"
        kv.close()
        plog.close()

    def test_long_values_round_trip(self, nat):
        from raftsql_tpu_torch.models.kv_native import NativeKV

        plog = _mk_plog(nat, 1)
        big = "x" * 5000
        plog.put(0, 1, [f"SET big {big}".encode()], [1])
        kv = NativeKV(1, nat)
        assert kv.apply_plog(plog.handle, [0], [1], [1]) == 1
        assert kv.get(0, "big") == big      # > first 256-byte buffer
        assert kv.get(0, "absent") is None
        kv.close()
        plog.close()


class TestFusedNativeApply:
    def test_fused_runtime_applies_through_c_plane(self, nat, tmp_path):
        """End to end on the fused durable runtime: proposals committed
        by consensus land in the C KV store without any Python-side
        consumer, and the values match what was proposed."""
        from raftsql_tpu_torch.config import RaftConfig
        from raftsql_tpu_torch.models.kv_native import NativeKV
        from raftsql_tpu_torch.runtime.fused import FusedClusterNode

        import os
        os.environ["RAFTSQL_FUSED_NATIVE_PLOG"] = "1"
        try:
            cfg = RaftConfig(num_groups=3, num_peers=3, log_window=64,
                             max_entries_per_msg=4, tick_interval_s=0.0)
            node = FusedClusterNode(cfg, str(tmp_path / "data"),
                                    device="cpu")
            assert hasattr(node.plogs[0], "handle")
            kv = NativeKV(3, node._plog_lib)
            node.native_kv = kv
            node.publish_peers = {0}
            for t in range(400):
                node.tick()
                if t > 10 and (node._hints >= 0).all():
                    break
            assert (node._hints >= 0).all()
            for g in range(3):
                node.propose_many(g, [f"SET g{g}k{i} val{i}".encode()
                                      for i in range(6)])
            for _ in range(30):
                node.tick()
                if all(kv.applied_index(g) >= 6 for g in range(3)):
                    break
            for g in range(3):
                for i in range(6):
                    assert kv.get(g, f"g{g}k{i}") == f"val{i}", (g, i)
            node.stop()
            kv.close()
        finally:
            del os.environ["RAFTSQL_FUSED_NATIVE_PLOG"]


def test_native_kv_races_jax_and_port_state_machines(nat):
    """The port's NativeKV against the JAX package's KVStateMachine and
    the port's, group by group, on one seeded stream over 4 groups with
    the grammar's edges (empty keys and values, extra spaces, bad
    commands), applied in ranges that overlap what was already applied:
    the same values, counts, applied indexes and bad-command count."""
    import numpy as np

    from raftsql_tpu_torch.models.kv_native import NativeKV
    rng = np.random.default_rng(3)
    G, N = 4, 300
    forms = ["SET k{} v{} tail", "SET k{} ", "DEL k{}", "SET onlykey",
             "DEL two tokens", "NOP x", "SET  lead{}", "", "SET k{} {}"]
    streams = [[forms[int(f)].format(int(rng.integers(30)), i)
                for i, f in enumerate(rng.integers(0, len(forms), N))]
               for _ in range(G)]
    plog = _mk_plog(nat, G)
    for g, cmds in enumerate(streams):
        plog.put(g, 1, [c.encode() for c in cmds], [1] * N)
    kv = NativeKV(G, nat)
    jsms = [JKVStateMachine() for _ in range(G)]
    tsms = [KVStateMachine() for _ in range(G)]
    bad = 0
    # Ranges that restart below what was applied: exactly-once applies.
    for lo, hi in ((1, 120), (60, 200), (1, 250), (240, N)):
        kv.apply_plog(plog.handle, list(range(G)), [lo] * G,
                      [hi - lo + 1] * G)
        for g, cmds in enumerate(streams):
            items = [(c, i) for i, c in enumerate(cmds[lo - 1: hi], lo)
                     if c]
            errs = jsms[g].apply_batch(items)
            terrs = [tsms[g].apply(c, i) for c, i in items]
            assert [e is None for e in terrs] == [e is None for e in errs]
            bad += sum(e is not None for e in errs)
    assert kv.bad_commands == bad > 0
    for g in range(G):
        want = jsms[g].snapshot()
        assert tsms[g].snapshot() == want
        assert kv.count(g) == len(want) > 0
        for k, v in want.items():
            assert kv.get(g, k) == v, (g, k)
        assert kv.applied_index(g) == N
        assert jsms[g].applied_index() == tsms[g].applied_index() \
            == max(i for i, c in enumerate(streams[g], 1) if c)
    kv.close()
    plog.close()
