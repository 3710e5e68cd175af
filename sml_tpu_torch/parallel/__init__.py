"""Host-side pipelining of the port (`parallel/pipeline.py`)."""
