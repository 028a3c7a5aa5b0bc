"""Reference-artifact interop (the port's copy of ``paddle_tpu.compat``).

Loads models and checkpoints saved by the reference framework — binary
protobuf ``ProgramDesc`` program files plus raw per-variable tensor
streams — into the port's Program + torch tensors on the caller's place,
and exports the port's inference programs in those formats, so trained
artifacts migrate, not just scripts.
"""
from .reference_format import (export_reference_inference_model,
                               load_reference_inference_model,
                               load_reference_persistables,
                               parse_program_desc, read_lod_tensor_stream,
                               serialize_program_desc,
                               write_lod_tensor_stream)

__all__ = [
    "export_reference_inference_model",
    "load_reference_inference_model", "load_reference_persistables",
    "parse_program_desc", "read_lod_tensor_stream",
    "serialize_program_desc", "write_lod_tensor_stream",
]
