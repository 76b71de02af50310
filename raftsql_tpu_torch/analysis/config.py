"""raftlint project configuration for the port: what the passes enforce
WHERE.

The port's counterpart of raftsql_tpu/analysis/config.py, and the
port's invariant registry.  Checkers read it via the `config` argument
(tests substitute a stub), so every path scope, required annotation,
and intentional exception is reviewable in one place.

Every ALLOWLIST entry carries a one-line justification; an entry
without a living call site is dead weight — delete it when the code it
covers goes.
"""
from __future__ import annotations

# ---------------------------------------------------------------------
# Default target set for `python -m raftsql_tpu_torch.analysis`.  Paths
# with `*` are glob patterns (analysis/core.py iter_py expands them).
# ---------------------------------------------------------------------
DEFAULT_PATHS = ["raftsql_tpu_torch", "chip_smoke.py",
                 "tests/test_torch_*.py"]

# ---------------------------------------------------------------------
# determinism: modules whose behavior feeds chaos digests must not read
# the wall clock or unseeded RNGs (torch's global generator included).
# Path prefixes (posix).
# ---------------------------------------------------------------------
DETERMINISM_PATHS = [
    "raftsql_tpu_torch/",    # whole port tree (exceptions below)
]

# ---------------------------------------------------------------------
# jit-stability: the port's step entry points, whose call signature
# must be FIXED after boot (core/signature.py records it; a CUDA graph
# of the step is captured per signature, as a jit trace is in the JAX
# package).  The checker flags (a) literal/non-literal mixes across
# call sites of one entry point, (b) `x if c else <literal>` feeding an
# argument, and (c) a CUDA graph, torch.compile or TorchScript callable
# (or jax.jit) built inside a loop body.  The JAX package's
# `cluster_step_jit` and `peer_step_jit` have no counterpart here.
# ---------------------------------------------------------------------
JIT_ENTRY_POINTS = {
    "cluster_step_host",
    "cluster_multistep_host",
    "cluster_run",
    "peer_step_packed",
}

# The JAX package's static_argnums positions (and their keyword
# spellings): these are MEANT to vary as Python values — a new cfg or
# step count is a deliberate new program, not the mid-flight class.
JIT_STATIC_ARGS = {
    "cluster_step_host": {0, "cfg"},
    "cluster_multistep_host": {0, 3, "cfg", "steps"},
    "cluster_run": {0, 3, "cfg", "num_ticks"},
    "peer_step_packed": {0, "cfg"},
}

# Call sites under these prefixes are excluded from the CROSS-SITE
# mixing rule only: a test deliberately probing both the scalar and
# the vector form is coverage, not a production signature switch.
# (The conditional-literal and build-in-loop rules still apply there.)
JIT_SKIP_MIXING_PREFIXES = ("tests/",)

# ---------------------------------------------------------------------
# thread-ownership: shared attributes are declared AT the attribute
# (`# raftlint: guarded-by=<lock>` on the __init__ assignment); writes
# anywhere else in the class must hold `with self.<lock>`.  Methods
# that run strictly on the attribute's owning thread opt out with
# `# raftlint: owner=<thread> -- why`.  The table below pins the
# registry: these classes MUST declare at least these guarded
# attributes — deleting the source annotation is itself a finding.
#   (relpath suffix, class name) -> {attr: lock}
# ---------------------------------------------------------------------
OWNERSHIP_REQUIRED = {
    ("runtime/hostplane.py", "ClusterHostPlane"): {
        "_props": "_prop_lock",      # HTTP/client threads extend,
        "_queued": "_prop_lock",     # tick thread pops/re-routes
        "_xfer_req": "_xfer_lock",   # client validate/enqueue vs tick
        "_xfers": "_xfer_lock",      # thread arming the device latch
    },
    ("runtime/db.py", "RaftDB"): {
        "_q2cb": "_mu",              # proposer threads vs apply thread
    },
    ("runtime/ring.py", "RingServer"): {
        "_tokens": "_tok_mu",        # retry-token LRU: drain threads
    },
    ("reshard/coordinator.py", "ReshardCoordinator"): {
        "_cur": "_mu",               # enqueue/doc threads vs the
        "_steps": "_mu",             # step() driver thread
        "_next_id": "_mu",
        "events": "_mu",
        "counters": "_mu",
    },
}

# ---------------------------------------------------------------------
# fail-closed: read-serving functions that must terminate EVERY path
# in an explicit return or raise (the ring fallback is `return None`;
# an implicit fall-through or a swallowed exception is a silent serve).
# Annotated in source with `# raftlint: fail-closed`; the table pins
# the registry so erasing an annotation is a finding.
# `# raftlint: seqlock` marks torn-read-retry protocol code, which
# additionally requires a file-level `assumes=<memory-model>`
# annotation (runtime/shm.py's x86-TSO store-ordering dependence).
#   relpath suffix -> {"fail-closed": [names], "seqlock": [names]}
# ---------------------------------------------------------------------
FAILCLOSED_REQUIRED = {
    "runtime/shm.py": {
        "fail-closed": ["_snapshot_table", "_catch_up", "try_read",
                        "leader_of"],
        "seqlock": ["_snapshot_table", "_publish_locked"],
    },
    # The router flip is the one place a reshard can lose acked writes
    # (flip before the copy fence) or serve a moved key from the wrong
    # group: every path must end in an explicit publish/return.
    "reshard/coordinator.py": {
        "fail-closed": ["_flip_router"],
    },
    # Overload decisions: a fall-through in admit/check_deadline is a
    # silently unbounded queue; one in brownout_read_path is a silent
    # stale-mode serve.
    "overload/admission.py": {
        "fail-closed": ["admit", "check_deadline",
                        "brownout_read_path"],
    },
    # The replica's write-fallback budget: a fall-through here admits
    # a redirect lookup past the cap.
    "replica/node.py": {
        "fail-closed": ["_admit_write"],
    },
}

# ---------------------------------------------------------------------
# Intentional exceptions, each with a one-line justification.  Keys:
#   rule      rule id the exception applies to
#   path      substring of the file's relpath
#   contains  optional substring of the finding message
#   why       REQUIRED human justification
# ---------------------------------------------------------------------
ALLOWLIST = [
    {
        "rule": "wall-clock",
        "path": "raftsql_tpu_torch/placement/controller.py",
        "contains": "time.time()",
        "why": "placement is a wall-clock plane: decision timestamps "
               "are operator-facing epoch times, never digested",
    },
    {
        "rule": "unseeded-random",
        "path": "raftsql_tpu_torch/api/client.py",
        "contains": "random.Random()",
        "why": "client retry jitter is intentionally per-process "
               "nondeterministic; deterministic harnesses inject a "
               "seeded rng via the constructor",
    },
]

# Back-compat alias consumed by core._allowlisted.
allowlist = ALLOWLIST
