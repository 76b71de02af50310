"""The cases of tests/test_staging.py, on the port (raftsql_tpu_torch,
every RaftNode stepping on the CPU).  The reference file's docstring
follows.

Inbox staging arbitration across the two delivery forms.

A peer may speak columnar (ColRecs) and record (AppendRec) forms in any
mix; the staging contract is "newest message per (group, src, slot)
wins" regardless of form, and the ReadIndex seq echo must be bound to
the request the device actually processes (never to a response's seq,
which lives in the SENDER's tick numberspace).  These are regression
tests for a leadership-churn hazard: a columnar RESP landing in the
same staging window as the same peer's record REQ must not leave the
inbox answering the REQ while echoing the RESP's (much larger) seq —
that inflates the peer's _resp_echo past rounds it ever sent and lets
read_ready() confirm a ReadIndex with no real quorum round.
"""
import numpy as np
import pytest

from raftsql_tpu_torch.config import MSG_REQ, MSG_RESP, RaftConfig
from raftsql_tpu_torch.core.step import unpack_inbox
from raftsql_tpu_torch.runtime.node import RaftNode
from raftsql_tpu_torch.transport.base import AppendRec, ColRecs, TickBatch
from raftsql_tpu_torch.transport.loopback import LoopbackHub, LoopbackTransport

import torch

torch.set_num_threads(1)


def build_inbox(node):
    """node._build_inbox(), unpacked to the named Inbox view (the build
    returns the packed [G, P, IB_NCOLS+E] array — core/step.py)."""
    packed, apps = node._build_inbox()
    return unpack_inbox(packed), apps


@pytest.fixture
def node(tmp_path):
    cfg = RaftConfig(num_groups=2, num_peers=3, tick_interval_s=1.0,
                     election_ticks=10, log_window=32,
                     max_entries_per_msg=4)
    n = RaftNode(1, 3, cfg, LoopbackTransport(LoopbackHub()),
                 data_dir=str(tmp_path / "raftsql-1"), device="cpu")
    yield n
    n.stop()


def col_resp(group: int, seq: int, term: int = 7) -> ColRecs:
    c = ColRecs()
    c.a_group = np.array([group], np.int32)
    c.a_type = np.array([MSG_RESP], np.int32)
    c.a_term = np.array([term], np.int32)
    c.a_prev_idx = np.zeros(1, np.int32)
    c.a_prev_term = np.zeros(1, np.int32)
    c.a_commit = np.zeros(1, np.int32)
    c.a_success = np.ones(1, np.int32)
    c.a_match = np.array([3], np.int32)
    c.a_seq = np.array([seq], np.int64)
    return c


def col_req(group: int, seq: int, term: int = 7) -> ColRecs:
    c = col_resp(group, seq, term)
    c.a_type = np.array([MSG_REQ], np.int32)
    c.a_success = np.zeros(1, np.int32)
    c.a_match = np.zeros(1, np.int32)
    return c


def rec_req(group: int, seq: int, term: int = 7) -> AppendRec:
    return AppendRec(group=group, type=MSG_REQ, term=term, prev_idx=2,
                     prev_term=term, ent_terms=[term],
                     payloads=[b"x"], seq=seq)


def test_record_req_then_columnar_resp_resp_wins(node):
    """Record REQ staged first, columnar RESP arrives later for the same
    slot: the RESP (newer) must win the inbox, and its seq must NOT leak
    into the echo array (the old code answered the REQ with the RESP's
    seq — the stale-linearizable-read hazard)."""
    src = 2  # node_id 2 -> slot 1
    node._deliver(src, TickBatch(appends=[rec_req(0, seq=5)]))
    node._deliver(src, TickBatch(cols=col_resp(0, seq=999)))
    inbox, apps = build_inbox(node)
    assert int(np.asarray(inbox.a_type)[0, 1]) == MSG_RESP
    # The displaced record is gone from the WAL-phase dict too.
    assert (0, 1) not in apps
    # No REQ in the slot => nothing to echo.
    assert int(node._tick_seq[0, 1]) == 0


def test_columnar_resp_then_record_req_req_and_its_seq_win(node):
    """Columnar RESP first, record REQ later: the REQ wins, and the echo
    seq must be the REQ's own (5), not the response's 999."""
    src = 2
    node._deliver(src, TickBatch(cols=col_resp(0, seq=999)))
    node._deliver(src, TickBatch(appends=[rec_req(0, seq=5)]))
    inbox, apps = build_inbox(node)
    assert int(np.asarray(inbox.a_type)[0, 1]) == MSG_REQ
    assert (0, 1) in apps
    assert int(node._tick_seq[0, 1]) == 5
    # The RESP's ReadIndex bookkeeping still registered (independent of
    # slot arbitration).
    assert int(node._resp_echo[0, 1]) == 999


def test_columnar_resp_seq_never_enters_echo_array(node):
    """A columnar RESP alone must leave the seq-echo array untouched:
    only REQ rows may set the echo binding."""
    node._deliver(2, TickBatch(cols=col_resp(1, seq=4242)))
    build_inbox(node)
    assert int(node._tick_seq[1, 1]) == 0


def test_columnar_req_seq_binds(node):
    node._deliver(2, TickBatch(cols=col_req(1, seq=17)))
    inbox, _ = build_inbox(node)
    assert int(np.asarray(inbox.a_type)[1, 1]) == MSG_REQ
    assert int(node._tick_seq[1, 1]) == 17


def test_record_req_then_newer_columnar_heartbeat_wins(node):
    """Same-form semantics preserved across forms: a newer columnar
    heartbeat REQ displaces an older record REQ (and its entries)."""
    src = 3  # slot 2
    node._deliver(src, TickBatch(appends=[rec_req(0, seq=5)]))
    node._deliver(src, TickBatch(cols=col_req(0, seq=6)))
    inbox, apps = build_inbox(node)
    assert int(np.asarray(inbox.a_type)[0, 2]) == MSG_REQ
    assert int(np.asarray(inbox.a_n)[0, 2]) == 0      # heartbeat, no ents
    assert (0, 2) not in apps
    assert int(node._tick_seq[0, 2]) == 6


def test_windows_reset_between_ticks(node):
    node._deliver(2, TickBatch(cols=col_req(0, seq=17)))
    build_inbox(node)
    inbox, apps = build_inbox(node)
    assert int(np.asarray(inbox.a_type)[0, 1]) == 0
    assert not apps
    assert int(node._tick_seq[0, 1]) == 0
