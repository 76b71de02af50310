"""The plain reference's linearizability check on reads, on records
made by hand."""
import pytest

from portbench.reference import check as ref


def rec(op, t0, t1, body=b"", index=0, status=None):
    st = status if status is not None else (200 if op == ref.OP_READ
                                            else 204)
    return ref.Rec(op, 2, st, 0, t0, t1, "user1", "", body, index)


def wrong_reads(reads, writes, versions):
    chk = ref.Checker([], "", 1, 3, "usertable", "YCSB_KEY",
                      lambda g: "", {0: 10})
    chk._writes = {(0, "user1"): writes}
    chk._check_reads(0, reads, {"user1": versions})
    return chk.n["wrong_answers"]


# One update (log index 5) sent at t = 100 and acknowledged only at
# t = 1000; the key's versions: "old" from the mix's start, "new" from 5.
WRITE = [rec(ref.OP_UPDATE, 100, 1000, index=5)]
VERSIONS = [(0, b"old"), (5, b"new")]


@pytest.mark.parametrize("bodies, wrong", [
    ((b"old", b"old"), 0),
    ((b"old", b"new"), 0),
    ((b"new", b"new"), 0),
    # The second read is sent after the first's reply saw "new": going
    # back to "old" is stale, though no write was acknowledged between.
    ((b"new", b"old"), 1),
])
def test_a_read_sees_no_older_version_than_an_earlier_read(bodies, wrong):
    reads = [rec(ref.OP_READ, 200, 300, bodies[0]),
             rec(ref.OP_READ, 400, 500, bodies[1])]
    assert wrong_reads(reads, WRITE, VERSIONS) == wrong


def test_overlapping_reads_may_see_either_order():
    reads = [rec(ref.OP_READ, 200, 500, b"new"),
             rec(ref.OP_READ, 300, 600, b"old")]
    assert wrong_reads(reads, WRITE, VERSIONS) == 0


@pytest.mark.parametrize("t0, body, wrong", [
    (1100, b"old", 1),     # sent after the write's acknowledgement
    (1100, b"new", 0),
    (50, b"new", 1),       # answered before the write was sent
])
def test_a_read_is_bounded_by_the_writes(t0, body, wrong):
    t1 = t0 + 40
    assert wrong_reads([rec(ref.OP_READ, t0, t1, body)], WRITE,
                       VERSIONS) == wrong


def test_an_answer_of_no_version_is_wrong():
    assert wrong_reads([rec(ref.OP_READ, 200, 300, b"other")], WRITE,
                       VERSIONS) == 1
