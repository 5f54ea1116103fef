"""The JSON wire format and columnar response assembly."""

from .assemble import WireColumn, WireTable, anomaly_table, index_wire_keys, prediction_table
from .json_codec import (
    Frame,
    FrameError,
    decode_frame,
    dumps,
    encode_fleet_response,
    encode_lean_entry,
    encode_response,
    encode_table,
    verify_frame,
)

__all__ = [
    "Frame",
    "FrameError",
    "WireColumn",
    "WireTable",
    "anomaly_table",
    "decode_frame",
    "dumps",
    "encode_fleet_response",
    "encode_lean_entry",
    "encode_response",
    "encode_table",
    "index_wire_keys",
    "prediction_table",
    "verify_frame",
]
