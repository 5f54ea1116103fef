"""The wire formats: JSON, the Arrow IPC stream and its fleet container,
content negotiation, and columnar response assembly."""

from .arrow_codec import (
    ARROW_CONTENT_TYPE,
    ArrowDecodeError,
    ArrowIndex,
    arrow_enabled,
    decode_frames,
    decode_response,
    encode_request,
    frame_from_columns,
    pack_streams,
    unpack_streams,
)
from .arrow_codec import encode_table as encode_arrow_table
from .assemble import WireColumn, WireTable, anomaly_table, index_wire_keys, lean_table, prediction_table
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
    "ARROW_CONTENT_TYPE",
    "ArrowDecodeError",
    "ArrowIndex",
    "Frame",
    "FrameError",
    "WireColumn",
    "WireTable",
    "anomaly_table",
    "arrow_enabled",
    "decode_frame",
    "decode_frames",
    "decode_response",
    "dumps",
    "encode_arrow_table",
    "encode_fleet_response",
    "encode_lean_entry",
    "encode_request",
    "encode_response",
    "encode_table",
    "frame_from_columns",
    "index_wire_keys",
    "lean_table",
    "pack_streams",
    "prediction_table",
    "unpack_streams",
    "verify_frame",
]
