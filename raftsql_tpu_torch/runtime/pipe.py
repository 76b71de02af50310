"""RaftPipe — the propose/commit/error facade (QuorumBackend seam).

The reference's 17-line `raftPipe` (reference raftpipe.go:3-17) bundles
{ProposeC, CommitC, ErrorC}: everything above consensus sees "strings in,
totally ordered strings out".  SURVEY.md §1 marks this as THE seam where
the TPU backend plugs in; here it is the same triple, batched with group
ids, backed by a RaftNode (runtime/node.py, stepping on `device`).

close() mirrors the reference contract (raftpipe.go:14-17): stop accepting
proposals, shut the node down, and return the terminal error (None on a
clean shutdown).
"""
from __future__ import annotations

from typing import Optional

from raftsql_tpu_torch.runtime.node import RaftNode


class RaftPipe:
    def __init__(self, node: RaftNode):
        self.node = node
        # Items: (group, index, sql) per-entry (replay), or the RAW
        # batch form (group, base_idx, [bytes, ...]) from the live
        # publish phase (one put per group per tick; entries still
        # enveloped — unwrap/dedup/decode happens on the CONSUMER
        # thread); None = replay-done sentinel, CLOSED = stream end.
        # Consumers normalize via runtime.db._expand_commit_item(item,
        # node).
        self.commit_q = node.commit_q

    @classmethod
    def create(cls, node_id: int, num_nodes: int, cfg, transport,
               data_dir: str, device="cuda") -> "RaftPipe":
        """Boot a RaftNode on `device` (CUDA by default; raises without
        a card), start its tick thread, and wrap it."""
        node = RaftNode(node_id, num_nodes, cfg, transport, data_dir,
                        device=device)
        pipe = cls(node)
        node.start()
        return pipe

    def propose(self, group: int, payload: bytes,
                pid: Optional[int] = None,
                t_parsed: Optional[float] = None) -> None:
        self.node.propose(group, payload, pid, t_parsed=t_parsed)

    @property
    def error(self) -> Optional[Exception]:
        return self.node.error

    def close(self) -> Optional[Exception]:
        self.node.stop()
        return self.node.error
