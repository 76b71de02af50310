"""Signature tripwire: the runtime falsifier for jit-stability.

The port's counterpart of raftsql_tpu/analysis/tripwire.py.  The JAX
package counts trace-cache entries of its jitted entry points; the port
runs eager and has no cache, so its ground truth is the call signatures
its four step entry points see (core/signature.py: `(shape, dtype,
device)` of every tensor leaf, the type of every Python scalar, None,
and the static arguments by value).  That is the key a CUDA graph of
the step is captured under: a steady-state run that calls an entry
point with a second signature would re-capture mid-run, under the
leader's election timer, whatever the static pass thought of the call
sites.

Armed by the chaos fast tier (chaos/run.py prints the verdict OUTSIDE
the digested reports — signatures are host-side facts, not consensus
results) and by tests/test_torch_raftlint.py.
"""
from __future__ import annotations

from typing import Dict, Iterable, Optional, Set

from raftsql_tpu_torch.core import signature


class SignatureTripwire:
    """Records the call signatures of the step entry points from arming
    (construction) until `disarm()`; `compiles()` counts them per entry
    point, with the JAX class's API (`baseline`, `compiles`,
    `offenders`, `check`)."""

    def __init__(self, entries: Optional[Iterable[str]] = None):
        self.entries = tuple(entries) if entries is not None \
            else tuple(signature.ENTRY_POINTS)
        self._seen: Dict[str, Set[tuple]] = {}
        signature.ARMED.append(self._seen)

    def disarm(self) -> None:
        """Stop recording (what was recorded stays readable)."""
        if self._seen in signature.ARMED:
            signature.ARMED.remove(self._seen)

    def __enter__(self) -> "SignatureTripwire":
        return self

    def __exit__(self, *exc) -> None:
        self.disarm()

    def baseline(self, name: str) -> Optional[int]:
        """Programs the entry point already had when armed: always 0 for
        a known entry point (the port's steps run eager and cache no
        program), None for an unknown name."""
        return 0 if name in self.entries else None

    def signatures(self, name: str) -> Set[tuple]:
        """The distinct signature keys `name` was called with."""
        return set(self._seen.get(name, ()))

    def compiles(self) -> Dict[str, int]:
        """Per-entry distinct call signatures since arming (0: never
        called) — what a graph cache keyed by signature would capture."""
        return {name: len(self._seen.get(name, ()))
                for name in self.entries}

    def offenders(self, limit: int = 1) -> Dict[str, int]:
        """Entry points called with MORE than `limit` signatures since
        arming."""
        return {name: n for name, n in self.compiles().items()
                if n > limit}

    def check(self, limit: int = 1) -> None:
        """Raise if any entry point saw more than `limit` signatures —
        one signature per entry point is the invariant."""
        bad = self.offenders(limit)
        if bad:
            raise AssertionError(
                f"signature tripwire: signatures past limit={limit}: "
                f"{bad} — a second call signature reached a "
                f"steady-state step entry point: "
                f"{ {n: sorted(map(repr, self.signatures(n))) for n in bad} }")
