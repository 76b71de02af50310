"""The port's distributed runtime (runtime/node.py RaftNode) beside the
JAX package's, in lockstep, on the CPU.

Both sides run the same cluster: P RaftNodes over their package's
LoopbackHub (every batch round-trips through the wire codec), ticked
manually in id order, with the same scripted proposals made from one
seed.  Envelope ids come from a counter on both sides, so the WAL bytes
are comparable too.  After every tick the packed info each node's step
returned, its hard state, its device state leaf for leaf and its commit
stream must be equal: consensus state is int32/bool, the tolerance is
zero.  At the end every node's WAL directory must hold the same files
with the same bytes.

The JAX side runs under an installed (rule-free) storage injector,
which selects its Python WAL backend, and the port's side on its default
native backend: the two backends write the same bytes.  Where a test
replays REC_CONF baselines, which neither package's native backend
writes, the port's side runs under its own injector too.
"""
import itertools
import json
import os

import numpy as np
import pytest
import torch

from raftsql_tpu.config import RaftConfig as JConfig
from raftsql_tpu.membership import MembershipError as JMembershipError
from raftsql_tpu.runtime import envelope as jenv
from raftsql_tpu.runtime.db import _expand_commit_item as j_expand
from raftsql_tpu.runtime.node import RaftNode as JNode
from raftsql_tpu.runtime.node import TransferRefused as JRefused
from raftsql_tpu.storage import fsio as jfsio
from raftsql_tpu.transport.loopback import LoopbackHub as JHub
from raftsql_tpu.transport.loopback import LoopbackTransport as JTransport
from raftsql_tpu_torch import convert
from raftsql_tpu_torch.config import LEADER
from raftsql_tpu_torch.config import RaftConfig as TConfig
from raftsql_tpu_torch.core.step import INFO_FIELDS
from raftsql_tpu_torch.membership import MembershipError as TMembershipError
from raftsql_tpu_torch.ops import pallas_quorum as pq
from raftsql_tpu_torch.runtime import envelope as tenv
from raftsql_tpu_torch.runtime.db import _expand_commit_item as t_expand
from raftsql_tpu_torch.runtime.node import RaftNode as TNode
from raftsql_tpu_torch.runtime.node import TransferRefused as TRefused
from raftsql_tpu_torch.transport.loopback import LoopbackHub as THub
from raftsql_tpu_torch.transport.loopback import \
    LoopbackTransport as TTransport

torch.set_num_threads(1)

JAX = dict(Node=JNode, Config=JConfig, Hub=JHub, Transport=JTransport,
           expand=j_expand, errors=(JMembershipError, JRefused), kw={})
PORT = dict(Node=TNode, Config=TConfig, Hub=THub, Transport=TTransport,
            expand=t_expand, errors=(TMembershipError, TRefused),
            kw={"device": "cpu"})


class Side:
    """One package's lockstep cluster, with a per-node KV state machine
    behind the snapshot hooks (the chaos snapshot runner's)."""

    def __init__(self, pkg, cfg_kw, root):
        self.pkg = pkg
        self.cfg = pkg["Config"](**cfg_kw)
        self.P = self.cfg.num_peers
        self.root = root
        self.hub = pkg["Hub"]()
        self.nodes = [None] * self.P
        G = self.cfg.num_groups
        self.sm = [[{} for _ in range(G)] for _ in range(self.P)]
        self.applied = np.zeros((self.P, G), np.int64)
        self.infos = {}

    def boot(self, p):
        pkg = self.pkg
        n = pkg["Node"](p + 1, self.P, self.cfg,
                        pkg["Transport"](self.hub),
                        os.path.join(self.root, f"n{p}"), **pkg["kw"])
        n.snapshot_provider = lambda g, p=p: (
            int(self.applied[p, g]),
            json.dumps(sorted(self.sm[p][g].items())).encode())
        n.snapshot_installer = lambda g, idx, blob, p=p: self._install(
            p, g, idx, blob)
        wal_phase = n._wal_phase

        def spy(info, p=p):
            self.infos[p] = np.concatenate(
                [np.stack([np.asarray(getattr(info, f), np.int64)
                           for f in INFO_FIELDS], 1),
                 np.asarray(info.next_idx, np.int64)], 1)
            return wal_phase(info)

        n._wal_phase = spy
        n.start(threaded=False)
        G = self.cfg.num_groups
        self.sm[p] = [{} for _ in range(G)]
        self.applied[p] = 0
        self.nodes[p] = n
        return self.drain(p)

    def _install(self, p, g, idx, blob):
        self.sm[p][g] = dict(json.loads(blob.decode()))
        self.applied[p, g] = idx

    def drain(self, p):
        """Every commit-stream item so far, expanded to (g, idx, sql),
        applied to node p's state machine."""
        n, out = self.nodes[p], []
        while not n.commit_q.empty():
            item = n.commit_q.get_nowait()
            if item is None:
                out.append("replayed")
                continue
            for g, idx, sql in self.pkg["expand"](item, n):
                out.append((g, idx, sql))
                parts = sql.split(" ")
                if len(parts) == 3 and parts[0] == "SET":
                    self.sm[p][g][parts[1]] = parts[2]
                self.applied[p, g] = max(self.applied[p, g], idx)
        return out

    def stop(self, p):
        self.nodes[p].stop()
        self.nodes[p] = None

    def leader(self, g):
        for p, n in enumerate(self.nodes):
            if n is not None and n._last_role[g] == LEADER:
                return p
        return None

    def call(self, p, fn, *a):
        """An admin call, its refusal recorded by class name."""
        try:
            return getattr(self.nodes[p], fn)(*a)
        except self.pkg["errors"] as e:
            return type(e).__name__

    def state(self, p):
        st = self.nodes[p].state
        if self.pkg is PORT:
            return convert.to_numpy(st)
        return {k: np.asarray(v) for k, v in st._asdict().items()}

    def wal_bytes(self):
        out = {}
        for p in range(self.P):
            d = os.path.join(self.root, f"n{p}")
            for name in sorted(os.listdir(d)):
                with open(os.path.join(d, name), "rb") as f:
                    out[(p, name)] = f.read()
        return out


@pytest.fixture
def counted_ids(monkeypatch):
    """Envelope ids from a counter on both sides (the WAL holds them)."""
    monkeypatch.setattr(jenv, "new_id", itertools.count(1).__next__)
    monkeypatch.setattr(tenv, "new_id", itertools.count(1).__next__)


def _tick_both(sides, t, incs=None):
    """One lockstep tick of every live node on both sides; then every
    observable must be equal."""
    for s in sides:
        s.infos = {}
        for p, n in enumerate(s.nodes):
            if n is not None:
                n.tick(timer_inc=1 if incs is None else incs[p])
    j, tt = sides
    for p in range(j.P):
        assert (j.nodes[p] is None) == (tt.nodes[p] is None)
        if j.nodes[p] is None:
            continue
        where = f"tick {t} node {p}"
        np.testing.assert_array_equal(j.infos[p], tt.infos[p],
                                      err_msg=f"info at {where}")
        np.testing.assert_array_equal(j.nodes[p]._hard_np,
                                      tt.nodes[p]._hard_np,
                                      err_msg=f"hard state at {where}")
        assert j.nodes[p]._timer_margin == tt.nodes[p]._timer_margin, where
        a, b = j.state(p), tt.state(p)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k],
                                          err_msg=f"{k} at {where}")
        assert j.drain(p) == tt.drain(p), f"commit stream at {where}"


def _propose(sides, rng, t, rate=0.6):
    """One seeded proposal (or none) at a random live node, both sides."""
    if rng.random() >= rate:
        return
    j = sides[0]
    alive = [p for p, n in enumerate(j.nodes) if n is not None]
    src = alive[int(rng.integers(0, len(alive)))]
    g = int(rng.integers(0, j.cfg.num_groups))
    for s in sides:
        s.nodes[src].propose(g, f"SET k{g} v{t}".encode())


CASES = [pytest.param(dict(num_groups=G, num_peers=P, commit_rule=r),
                      id=f"G{G}-P{P}-{r}")
         for (G, P) in ((8, 3), (64, 5)) for r in ("point", "pallas")]


@pytest.mark.parametrize("kw", CASES)
def test_lockstep_cluster_equal(tmp_path, counted_ids, kw):
    """~120 ticks of elections, proposals (at leaders and followers:
    forwarding), timer skew and one partition window."""
    cfg = dict(log_window=32, max_entries_per_msg=4, election_ticks=10,
               heartbeat_ticks=1, tick_interval_s=0.0, **kw)
    with jfsio.installed(jfsio.StorageFaultInjector()):
        sides = (Side(JAX, cfg, str(tmp_path / "jax")),
                 Side(PORT, cfg, str(tmp_path / "port")))
        P = sides[0].P
        for p in range(P):
            assert sides[0].boot(p) == sides[1].boot(p) == ["replayed"]
        rng = np.random.default_rng(11)
        pq.reset_launches()
        for t in range(120):
            for s in sides:
                s.hub.faults.heal()
                if 50 <= t < 70:
                    s.hub.faults.isolate(1, range(1, P + 1))
            _propose(sides, rng, t)
            incs = [1 + (p == 2 and 30 <= t < 40) for p in range(P)]
            _tick_both(sides, t, incs)
        assert sum(s.applied.sum() for s in sides) > 0
        for s in sides:
            for p in range(P):
                s.stop(p)
        assert sides[0].wal_bytes() == sides[1].wal_bytes()
    # On the CPU the wrappers take their plain versions: no launch.
    assert pq.launches["pallas_quorum_commit_index"] == 0


def test_entry_points_default_to_the_card(tmp_path, monkeypatch):
    """RaftNode, RaftPipe.create and build_node step on cuda unless told
    otherwise, and without a card they raise: no CPU fallback."""
    from raftsql_tpu_torch.runtime.pipe import RaftPipe
    from raftsql_tpu_torch.server.main import build_node
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.chdir(tmp_path)
    cfg = TConfig(num_groups=2, num_peers=3)
    with pytest.raises(RuntimeError, match="cuda"):
        TNode(1, 3, cfg, TTransport(THub()), str(tmp_path / "n"))
    with pytest.raises(RuntimeError, match="cuda"):
        RaftPipe.create(1, 3, cfg, TTransport(THub()), str(tmp_path / "p"))
    with pytest.raises(RuntimeError, match="cuda"):
        build_node("http://127.0.0.1:1,http://127.0.0.1:2,"
                   "http://127.0.0.1:3", 1)
