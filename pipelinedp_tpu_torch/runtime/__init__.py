"""Runtime of the port: the streamed ingest's overlapped encode and device
row buffers (pipeline.py)."""
