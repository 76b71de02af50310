"""The port's wire codec (transport/codec.py) against the JAX package's.

Seeded random TickBatches (vote, append and snapshot records, forwarded
proposals, and the columnar section) are built once as plain values and
then as each package's record objects.  Both encoders must produce the
same bytes, flat and CRC-framed; each decoder must read the other's
frames back to the same records; and a frame with one flipped byte must
raise FrameCorruptError on both sides.
"""
import dataclasses

import numpy as np
import pytest

from raftsql_tpu.transport import base as jbase
from raftsql_tpu.transport import codec as jcodec
from raftsql_tpu_torch.transport import base as tbase
from raftsql_tpu_torch.transport import codec as tcodec

REQ, RESP = 1, 2


def _values(seed):
    """One random batch as plain dicts (no package's types)."""
    rng = np.random.default_rng(seed)
    ri = lambda hi: int(rng.integers(0, hi))  # noqa: E731
    out = {"votes": [], "appends": [], "proposals": [], "snapshots": [],
           "cols": None}
    for _ in range(ri(4)):
        out["votes"].append(dict(group=ri(1 << 20), type=1 + ri(4),
                                 term=ri(1 << 40), last_idx=ri(1 << 33),
                                 last_term=ri(1 << 30),
                                 granted=bool(ri(2))))
    for _ in range(ri(5)):
        typ = REQ if ri(2) else RESP
        n = ri(5)
        out["appends"].append(dict(
            group=ri(1 << 16), type=typ, term=ri(1 << 35),
            prev_idx=ri(1 << 33), prev_term=ri(99),
            ent_terms=[ri(1 << 31) for _ in range(n)],
            payloads=([bytes(rng.integers(0, 256, ri(40), np.uint8))
                       for _ in range(n)] if typ == REQ else []),
            commit=ri(1 << 33), success=bool(ri(2)), match=ri(1 << 33),
            seq=ri(1 << 50)))
    for _ in range(ri(3)):
        out["proposals"].append(dict(
            group=ri(1 << 10),
            payload=bytes(rng.integers(0, 256, ri(64), np.uint8))))
    for _ in range(ri(2)):
        out["snapshots"].append(dict(
            group=ri(100), last_idx=ri(1 << 33), last_term=ri(50),
            term=ri(60), blob=bytes(rng.integers(0, 256, ri(300),
                                                 np.uint8))))
    if ri(3):
        nv, na = ri(6), ri(9)
        cols = {}
        for f in jcodec._COL_V:
            cols[f] = rng.integers(-5, 1 << 30, nv).astype(np.int32) \
                if nv else None
        for f in jcodec._COL_A:
            dt = np.int64 if f == "a_seq" else np.int32
            cols[f] = rng.integers(-5, 1 << 30, na).astype(dt) \
                if na else None
        out["cols"] = cols
    return out


def _batch(base, v):
    cols = None if v["cols"] is None else base.ColRecs(**v["cols"])
    return base.TickBatch(
        votes=[base.VoteRec(**d) for d in v["votes"]],
        appends=[base.AppendRec(**d) for d in v["appends"]],
        proposals=[base.ProposalRec(**d) for d in v["proposals"]],
        snapshots=[base.SnapshotRec(**d) for d in v["snapshots"]],
        cols=cols)


def _plain(batch):
    """A decoded batch as comparable plain values."""
    d = {k: [dataclasses.asdict(r) for r in getattr(batch, k)]
         for k in ("votes", "appends", "proposals", "snapshots")}
    c = batch.cols
    d["cols"] = None if c is None else {
        f: (None if getattr(c, f) is None
            else (getattr(c, f).dtype.str, getattr(c, f).tolist()))
        for f in jcodec._COL_V + jcodec._COL_A}
    return d


@pytest.mark.parametrize("seed", range(40))
def test_frames_byte_identical_and_cross_decodable(seed):
    v = _values(seed)
    jb, tb = _batch(jbase, v), _batch(tbase, v)
    assert jcodec.encode_batch(jb) == tcodec.encode_batch(tb)
    jf, tf = jcodec.encode_batch_framed(jb), tcodec.encode_batch_framed(tb)
    assert jf == tf
    want = _plain(jcodec.decode_batch_framed(jf))
    assert _plain(tcodec.decode_batch_framed(jf)) == want
    assert _plain(jcodec.decode_batch_framed(tf)) == want
    assert _plain(tcodec.decode_batch(tcodec.encode_batch(tb))) == want
    assert jb.empty() == tb.empty()


@pytest.mark.parametrize("seed", range(12))
def test_corrupt_frames_raise_on_both_sides(seed):
    v = _values(seed)
    frame = tcodec.encode_batch_framed(_batch(tbase, v))
    rng = np.random.default_rng(1000 + seed)
    for _ in range(8):
        i = int(rng.integers(0, len(frame)))
        bad = frame[:i] + bytes([frame[i] ^ 0x5A]) + frame[i + 1:]
        with pytest.raises(jcodec.FrameCorruptError):
            jcodec.decode_batch_framed(bad)
        with pytest.raises(tcodec.FrameCorruptError):
            tcodec.decode_batch_framed(bad)
    for cut in (0, 3):
        with pytest.raises(tcodec.FrameCorruptError):
            tcodec.decode_batch_framed(frame[:cut])
        with pytest.raises(jcodec.FrameCorruptError):
            jcodec.decode_batch_framed(frame[:cut])


def test_truncated_flat_frames_rejected_alike():
    """decode_batch bounds-checks every declared count and length: a
    flat frame cut short fails on both sides, never decodes short."""
    v = _values(7)
    flat = tcodec.encode_batch(_batch(tbase, v))
    for cut in range(1, len(flat), max(1, len(flat) // 25)):
        outcomes = []
        for codec in (jcodec, tcodec):
            try:
                outcomes.append(("ok", _plain(codec.decode_batch(
                    flat[:cut]))))
            except Exception as e:                     # noqa: BLE001
                outcomes.append(("err", type(e).__name__))
        assert outcomes[0] == outcomes[1], cut
