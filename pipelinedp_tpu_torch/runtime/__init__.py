"""Runtime of the port (pipelinedp_tpu/runtime/, the parts ported so far):
the streamed ingest's overlapped encode and device row buffers
(pipeline.py), and what the multi-tenant service runs on: the metrics
registry (telemetry.py), span tracing (trace.py), per-job health
(health.py), the deadline watchdog (watchdog.py), the CRC-verified record
journal (journal.py), the budget odometer, memory watermarks and
Prometheus text (observability.py), and the lock-discipline declaration
(concurrency.py)."""
