"""95th percentile of the client's latency of every acknowledged
linearizable GET sent in the window (the load generator's send and
receive times)."""
from portbench.metrics._common import latencies_ms, p95
from portbench.reference.check import OP_READ


def read(snap: dict):
    return p95(latencies_ms(snap, (OP_READ,), 200))
