"""raftlint for the port — the project-invariant static-analysis suite.

The port's copy of raftsql_tpu/analysis/ (stdlib `ast`, no JAX, nothing
of `raftsql_tpu`), with the JAX package's rule ids and `# raftlint:`
annotation grammar and the port's own registry (analysis/config.py).
Its passes encode the invariants the project learned the hard way:

  * jit-stability   — step entry points must keep ONE call signature
                      after boot (a second one is a recompile in the
                      JAX package and a graph re-capture here, under
                      the leader's election timer);
  * determinism     — no wall-clock / unseeded randomness (torch's
                      global generator included) in digest-relevant
                      modules;
  * thread-ownership— cross-thread attribute writes must hold the
                      attribute's declared lock;
  * fail-closed     — annotated read-serving functions must terminate
                      every path in an explicit return or raise;
  * memory-model    — seqlock code must carry its hardware-ordering
                      assumption as a machine-visible annotation
                      (runtime/shm.py's x86-TSO dependence);
  * the five classic vet rules (unused imports, duplicate defs,
    mutable defaults, tuple asserts, bare excepts).

Run it:  `python -m raftsql_tpu_torch.analysis [paths...]` (`--list`
names the rules).  Suppress one finding: `# raftlint: disable=<rule>`
on (or one line above) the offending line; project-wide intentional
exceptions live in `analysis/config.py` ALLOWLIST with one-line
justifications.  The runtime falsifier of jit-stability is
`analysis/tripwire.py` `SignatureTripwire`.
"""
from raftsql_tpu_torch.analysis.core import (Finding, SourceUnit,
                                             all_checkers, run_suite)

__all__ = ["Finding", "SourceUnit", "all_checkers", "run_suite"]
