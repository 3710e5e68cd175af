"""Micro-batch structured streaming (`stream.py`): MLE 00's deployment
path on the port's frame."""

from .stream import (DataStreamReader, DataStreamWriter, StreamManager,
                     StreamingDataFrame, StreamingQuery)

__all__ = ["DataStreamReader", "DataStreamWriter", "StreamManager",
           "StreamingDataFrame", "StreamingQuery"]
