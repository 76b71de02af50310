"""Observability for the port: device-plane event ring, host-plane span
tracing, Chrome-trace (Perfetto) export, the chaos flight recorder and
the tick-phase profiler.

Port of raftsql_tpu/obs/.  Two planes, matching the engine's own split:

  * DEVICE plane (`device_ring.py`): a tick-indexed event ring — a
    fixed-shape [depth, P, G, NEV] int32 tensor on the node's device
    the fused runtime writes one slot per tick, drained to the host in
    whole-ring batches (one device-to-host copy per `depth` ticks).
  * HOST plane (`spans.py`): a span tracer following each proposal
    through its lifecycle (propose → WAL append → replicate → commit →
    apply → ack) with monotonic timestamps, plus a timeline-event ring
    for WAL fsyncs and anything else the host planes want on the trace.

Exports (`export.py`): Chrome trace-event JSON loadable in Perfetto
(`GET /trace`), raw event JSON (`GET /events`).  The chaos runner wires
both planes into a flight recorder (`flight.py`): an invariant failure
dumps the last N ticks of device events plus the host spans next to
the failing seed.

TRACING is OFF by default: the engine's `tracer`/`ring` attributes are
None until `enable_tracing()` is called, and every hook is gated on
them.  The TELEMETRY plane (`prof.py`, per-phase tick wall-time
percentiles) is ON by default.  Trace segments
(`export.TraceSegmentWriter`) stay inert until the `--workers` serving
plane is ported.
"""
from raftsql_tpu_torch.obs.device_ring import EVENT_FIELDS, DeviceEventRing
from raftsql_tpu_torch.obs.export import (TraceSegmentWriter, chrome_trace,
                                          collect_segments,
                                          validate_chrome_trace)
from raftsql_tpu_torch.obs.flight import FlightRecorder
from raftsql_tpu_torch.obs.prof import PROF_PHASES, TickPhaseProfiler
from raftsql_tpu_torch.obs.spans import SpanTracer

__all__ = ["EVENT_FIELDS", "DeviceEventRing", "SpanTracer",
           "chrome_trace", "validate_chrome_trace", "FlightRecorder",
           "TickPhaseProfiler", "PROF_PHASES", "TraceSegmentWriter",
           "collect_segments"]
