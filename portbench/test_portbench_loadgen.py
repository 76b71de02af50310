"""The load generator's seeded key and op generators (no network)."""
import collections
import json
import os
import subprocess

import pytest

from portbench.loadgen import build

HERE = os.path.dirname(os.path.abspath(__file__))


def dump(tmp_path, traffic, config, seed, n, **over):
    cfg = json.load(open(os.path.join(HERE, "configs", config)))
    mix = json.load(open(os.path.join(HERE, "traffic", traffic)))
    mix.update(over)
    space = cfg["recordcount"] if mix["key_space"] == "recordcount" \
        else mix["key_space"]
    p = tmp_path / f"params-{seed}"
    p.write_text("".join(f"{k} {v}\n" for k, v in {
        "seed": seed, "groups": cfg["groups"], "table": cfg["table"],
        "key_column": cfg["key_column"], "fields": ",".join(cfg["fields"]),
        "field_length": cfg["fieldlength"], "key_kind": cfg["key_kind"],
        "key_dist": mix["key_dist"],
        "zipf_constant": mix.get("zipf_constant", 0), "key_space": space,
        "read": mix["read"], "update": mix["update"],
        "upsert": mix["upsert"], "conns": mix["connections"]}.items()))
    out = subprocess.run([build.build(), str(p), "--dump", str(n)],
                         capture_output=True, text=True, check=True).stdout
    return [(int(o), k, int(g)) for o, k, g in
            (ln.split() for ln in out.splitlines())]


def test_ycsb_a_mix_and_scrambled_zipfian(tmp_path):
    ops = dump(tmp_path, "ycsb-a.json", "fused-g199.json", 2**31 + 5, 200_000)
    kinds = collections.Counter(o for o, _k, _g in ops)
    assert set(kinds) == {2, 3}
    assert abs(kinds[2] / len(ops) - 0.5) < 0.01      # 50 % reads
    hits = collections.Counter(k for _o, k, _g in ops)
    top = hits.most_common(1)[0][1] / len(ops)
    # YCSB's scrambled zipfian (constant 0.99, 10^10 items hashed onto
    # 100,000 keys): the hottest key takes ~3.8 %, and the keys touched
    # are well under the keyspace.
    assert 0.03 < top < 0.05
    assert 50_000 < len(hits) < 100_000
    assert all(k.startswith("user") for k in hits)
    assert {g for _o, _k, g in ops} == set(range(199))


def test_hot_keys_do_not_follow_the_seed(tmp_path):
    a = dump(tmp_path, "ycsb-a.json", "fused-g199.json", 1, 50_000)
    b = dump(tmp_path, "ycsb-a.json", "fused-g199.json", 4_000_000_000, 50_000)
    assert a != b
    top = lambda ops: [k for k, _ in collections.Counter(  # noqa: E731
        k for _o, k, _g in ops).most_common(3)]
    assert top(a) == top(b)


def test_same_seed_same_requests(tmp_path):
    assert dump(tmp_path, "ycsb-a.json", "fused-g199.json", 99, 5000) == \
        dump(tmp_path, "ycsb-a.json", "fused-g199.json", 99, 5000)


def test_etcd_put_sequential_keys(tmp_path):
    ops = dump(tmp_path, "etcd-put.json", "fused-g1.json", 3, 100_050)
    assert {o for o, _k, _g in ops} == {4}
    keys = [k for _o, k, _g in ops]
    assert keys[:3] == ["00000000", "00000001", "00000002"]
    assert keys[100_000] == "00000000"                 # wraps at 100,000
    assert len(set(keys)) == 100_000 and all(len(k) == 8 for k in keys)
    assert {g for _o, _k, g in ops} == {0}


@pytest.mark.parametrize("constant", ["0.9", "1.2"])
def test_zipfian_refuses_other_constants(tmp_path, constant):
    with pytest.raises(subprocess.CalledProcessError):
        dump(tmp_path, "ycsb-a.json", "fused-g199.json", 1, 10,
             zipf_constant=constant)
