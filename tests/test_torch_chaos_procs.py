"""The cases of tests/test_chaos_procs.py, on the port (every server
child a `raftsql_tpu_torch.server.main` process stepping on the CPU),
plus the process plan's digests held to the JAX package's.  The
reference file's docstring follows.

Process-plane chaos tests (chaos/proc.py + the seams it rides).

Fast tier: seeded-plan determinism, the RAFTSQL_FSIO_FAULTS grammar,
the retry-token exactly-once path, one full nemesis run over 3 real
server processes (every fault family: leader SIGKILL, random SIGKILL,
leader SIGSTOP/SIGCONT, rolling-restart storm, env-injected ENOSPC and
exit-at-fsync), and the SIGSTOP satellite: a stalled leader must be
deposed while frozen, rejoin as a follower, and lose nothing acked.

The slow tier sweeps more seeds and proves the verdict-digest
reproducibility claim by running one seed twice.
"""
import dataclasses
import time

import pytest
import torch

from raftsql_tpu.chaos import schedule as JS
from raftsql_tpu_torch.api.client import RaftSQLClient
from raftsql_tpu_torch.chaos.proc import ProcChaosRunner, ProcCluster
from raftsql_tpu_torch.chaos.schedule import generate_procs
from raftsql_tpu_torch.storage import fsio

torch.set_num_threads(1)


# ---------------------------------------------------------------------------
# seeded plans + env grammar (no processes)

def test_proc_plan_is_deterministic_per_seed():
    for seed in (0, 1, 17):
        a, b = generate_procs(seed), generate_procs(seed)
        assert a == b and a.digest() == b.digest()
    assert generate_procs(0).digest() != generate_procs(1).digest()


def test_proc_plan_has_every_fault_family():
    plan = generate_procs(3)
    assert len(plan.kills) >= 2
    assert any(k.peer == -2 for k in plan.kills)   # leader-targeted
    assert len(plan.stalls) >= 1 and len(plan.storms) >= 1
    specs = " ".join(f.spec for f in plan.fsio)
    assert "enospc@" in specs and "exit_fsync@" in specs
    assert plan.ticks >= max(s.tick for s in plan.storms)


def test_fsio_env_spec_grammar():
    rules = fsio.parse_env_spec(
        "raftsql-2:enospc@12;raftsql-1:exit_fsync@9:stall@4x3x50")
    assert rules[0] == {"substring": "raftsql-2",
                       "enospc_write_at": [12]}
    assert rules[1]["exit_at"] == [9]
    assert rules[1]["stall_at"] == [4, 5, 6]
    assert rules[1]["stall_s"] == 0.05
    assert fsio.parse_env_spec("") == []
    for bad in ("nocolon", ":enospc@1", "raftsql-1:enospc",
                "raftsql-1:bogus@3", "raftsql-1:stall@1x2"):
        with pytest.raises(ValueError):
            fsio.parse_env_spec(bad)


def test_fsio_install_from_env_round_trip():
    inj = fsio.install_from_env("raftsql-9:enospc@2")
    try:
        assert fsio.active() and inj is fsio.injector()
        assert inj.rules[0].enospc_write_at == {2}
    finally:
        fsio.uninstall()
    assert fsio.install_from_env("") is None and not fsio.active()


# ---------------------------------------------------------------------------
# the nemesis over real processes

def test_proc_chaos_seeded_run_all_families(tmp_path):
    """One full seeded nemesis run over 3 real server processes: every
    scripted fault family fires, no child dies of anything unscripted,
    every invariant holds (violations raise out of run()), and no
    acked write is lost (the convergence + post-mortem gates inside
    run())."""
    plan = dataclasses.replace(generate_procs(0, ticks=48),
                               tick_s=0.2, heal_ticks=25)
    r = ProcChaosRunner(plan, str(tmp_path), device="cpu").run()
    assert r["schedule_digest"] == plan.digest()
    assert r["kills"] >= len(plan.kills)
    assert r["stalls"] >= len(plan.stalls)
    assert r["storm_restarts"] >= plan.peers * len(plan.storms)
    assert r["fsio_exits"] >= 1, r       # exit_fsync crash point fired
    assert r["fatal_exits"] >= 1, r      # env ENOSPC killed its child
    assert r["unexpected_exits"] == 0, r
    assert r["acked"] > 10, r            # the workload made progress


@pytest.mark.slow
def test_proc_chaos_verdict_digest_reproduces(tmp_path):
    """The `chaos.run --procs` determinism contract: one seed, two runs,
    identical schedule + verdict digests (committed histories differ —
    real kernel scheduling — the VERDICT is what must reproduce)."""
    plan = dataclasses.replace(generate_procs(1, ticks=48),
                               tick_s=0.2, heal_ticks=25)
    a = ProcChaosRunner(plan, str(tmp_path / "a"), device="cpu").run()
    b = ProcChaosRunner(plan, str(tmp_path / "b"), device="cpu").run()
    assert (a["schedule_digest"], a["result_digest"]) \
        == (b["schedule_digest"], b["result_digest"])


@pytest.mark.slow
def test_proc_chaos_seed_sweep(tmp_path):
    for seed in (2, 3):
        plan = dataclasses.replace(generate_procs(seed, ticks=48),
                                   tick_s=0.2, heal_ticks=25)
        r = ProcChaosRunner(plan, str(tmp_path / f"s{seed}"),
                            device="cpu").run()
        assert r["unexpected_exits"] == 0, r


# ---------------------------------------------------------------------------
# the SIGSTOP satellite: stall == GC pause / VM freeze, not death

def _role(doc, g="0"):
    return doc["groups"][g]["role"] if doc else None


def _term(doc, g="0"):
    return doc["groups"][g]["term"] if doc else 0


def test_sigstopped_leader_is_deposed_and_rejoins_as_follower(tmp_path):
    """A SIGSTOPped leader is indistinguishable from a dead one to its
    peers — they must elect a successor — but the process is NOT dead:
    on SIGCONT it wakes believing it still leads, must step down on
    first contact with the higher term, and every write acked before
    (and during) the stall must survive on every node."""
    c = ProcCluster(str(tmp_path), peers=3, tick=0.02, device="cpu")
    cli = RaftSQLClient([f"127.0.0.1:{p}" for p in c.http_ports],
                        timeout_s=3.0)
    try:
        for i in range(3):
            c.spawn(i)
        for i in range(3):
            cli.wait_healthy(i, deadline_s=60.0)
        cli.put("CREATE TABLE t (v text)", deadline_s=60.0)
        for k in range(5):
            cli.put(f"INSERT INTO t (v) VALUES ('w{k}')",
                    deadline_s=30.0)

        # Find the current leader of group 0.
        deadline = time.monotonic() + 30.0
        leader, old_term = None, 0
        while leader is None:
            assert time.monotonic() < deadline, "no leader emerged"
            for i in range(3):
                doc = cli.health(i)
                if _role(doc) == "leader":
                    leader, old_term = i, _term(doc)
                    break
            time.sleep(0.2)

        c.sigstop(leader)
        others = [i for i in range(3) if i != leader]
        # The survivors must depose the frozen leader: a new leader in
        # a STRICTLY higher term.
        deadline = time.monotonic() + 30.0
        new_term = 0
        while not new_term:
            assert time.monotonic() < deadline, \
                "no successor elected while leader was stalled"
            for i in others:
                doc = cli.health(i)
                if _role(doc) == "leader" and _term(doc) > old_term:
                    new_term = _term(doc)
                    break
            time.sleep(0.2)
        # A write acked DURING the stall (the client routes around the
        # frozen node) — it must survive the old leader's return.
        cli.put("INSERT INTO t (v) VALUES ('during-stall')",
                deadline_s=30.0)

        c.sigcont(leader)
        # The woken leader must abandon its old reign: its term must
        # catch up to the successor's, and it must pass through (and,
        # with a live leader heartbeating, stay in) the follower role.
        deadline = time.monotonic() + 30.0
        saw_follower = False
        while True:
            doc = cli.health(leader)
            if doc is not None and _term(doc) >= new_term:
                if _role(doc) == "follower":
                    saw_follower = True
                    break
            assert time.monotonic() < deadline, \
                f"stalled ex-leader never rejoined as follower: {doc}"
            time.sleep(0.2)
        assert saw_follower

        # Nothing acked before or during the stall may be lost —
        # including on the ex-leader itself.
        want = "".join(f"|{v}|\n" for v in
                       sorted(["during-stall"] + [f"w{k}"
                                                  for k in range(5)]))
        for i in range(3):
            cli.get_until("SELECT v FROM t ORDER BY v", want, node=i,
                          deadline_s=60.0)
    finally:
        c.stop_all()


# ---------------------------------------------------------------------------
# the plan against the JAX package's (pure numpy: equal for any seed)

@pytest.mark.parametrize("seed", [0, 1, 2, 3])
@pytest.mark.parametrize("ticks", [40, 48, 60, 80])
def test_proc_plan_digest_equals_jax(seed, ticks):
    got, want = generate_procs(seed, ticks=ticks), \
        JS.generate_procs(seed, ticks=ticks)
    assert got.describe() == want.describe()
    assert got.digest() == want.digest()


def test_proc_entry_points_need_the_card_by_default(tmp_path):
    """No fallback: the runners default to device="cuda" and raise
    without a card instead of quietly stepping on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is served")
    with pytest.raises(RuntimeError, match="cuda"):
        ProcChaosRunner(generate_procs(0), str(tmp_path))
