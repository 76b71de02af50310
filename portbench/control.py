"""The control and the planted faults: a run with the program broken
underneath, which the comparison must call not correct.

    python3 -m portbench.control --fault ack_at_propose \
        --workload etcd-put.g1 --seed 11 --seconds 30

runs portbench/run.py's whole run with `--fault` planted in the program
as the window opens, and prints the run's line (each check
with its reading).  The benchmark's own runs never plant anything.

The control, `ack_at_propose`, breaks the guarantee the configurations
state for writes: a PUT is answered as soon as it is proposed, before
its entry is committed and applied.  The faults:

  state_unchanged  the device step hands back the state it was given
  half_batch       the apply plane applies every other statement of a
                   batch and acknowledges all of them
  answer_altered   a read's answer altered where it is produced
  write_altered    a statement altered where it is applied
  stale_read       linearizable reads answered from a cache of answers
                   kept STALE_S seconds, about two ticks of YCSB-A on
                   199 groups
"""
from __future__ import annotations

import argparse
import sys
import time

STALE_S = 0.2


def ack_at_propose(rdb) -> None:
    propose = rdb.propose

    def early(query, group=0, *a, **kw):
        fut = propose(query, group, *a, **kw)
        fut.set(None)
        return fut
    rdb.propose = early


def state_unchanged(rdb) -> None:
    node = rdb.pipe.node
    step = node._device_step

    def unchanged(prop_n, timer_inc=None):
        states, inboxes = node.states, node.inboxes
        out = step(prop_n, timer_inc)
        node.states, node.inboxes = states, inboxes
        return out
    node._device_step = unchanged


def _each_sm(rdb, wrap) -> None:
    for sm in rdb._sms.values():
        wrap(sm)


def half_batch(rdb) -> None:
    def wrap(sm):
        apply_batch = sm.apply_batch

        def half(items):
            items = list(items)
            errs = apply_batch(items[::2])
            out = [None] * len(items)
            out[::2] = errs
            last = max((i for _c, i in items), default=0)
            if last:
                sm._applied = max(sm._applied, last)
            return out
        sm.apply_batch = half
    _each_sm(rdb, wrap)


def answer_altered(rdb) -> None:
    def wrap(sm):
        query = sm.query

        def altered(q):
            out = query(q)
            return out.replace("|", "|x", 1) if out else out
        sm.query = altered
    _each_sm(rdb, wrap)


def write_altered(rdb) -> None:
    def wrap(sm):
        apply_batch = sm.apply_batch

        def altered(items):
            return apply_batch([(c.replace("'c", "'x", 1), i)
                                for c, i in items])
        sm.apply_batch = altered
    _each_sm(rdb, wrap)


def stale_read(rdb) -> None:
    def wrap(sm):
        query = sm.query
        kept = {}                       # query -> (time, answer)

        def stale(q):
            now = time.monotonic()
            got = kept.get(q)
            if got is not None and now - got[0] < STALE_S:
                return got[1]
            out = query(q)
            kept[q] = (now, out)
            return out
        sm.query = stale
    _each_sm(rdb, wrap)


FAULTS = {f.__name__: f for f in (ack_at_propose, state_unchanged,
                                  half_batch, answer_altered,
                                  write_altered, stale_read)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--fault", choices=sorted(FAULTS), required=True)
    args, rest = ap.parse_known_args(argv)
    from portbench import run
    return run.main(rest, patch=FAULTS[args.fault])


if __name__ == "__main__":
    sys.exit(main())
