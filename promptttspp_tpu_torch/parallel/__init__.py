"""Parallelism of the port: data parallelism across processes in training,
frame parallelism across the devices of one process in serving."""

from promptttspp_tpu_torch.parallel.distributed import (
    DataGroup, host_batches, init_distributed, mesh_process_rows,
    process_slice)
from promptttspp_tpu_torch.parallel.mesh import (
    Mesh, make_mesh, pad_batch_to_multiple, pad_batch_to_rows)
from promptttspp_tpu_torch.parallel.sp import (
    FrameShardedDenoiser, decode_frames_sharded)

__all__ = [
    "DataGroup",
    "FrameShardedDenoiser",
    "Mesh",
    "decode_frames_sharded",
    "host_batches",
    "init_distributed",
    "make_mesh",
    "mesh_process_rows",
    "pad_batch_to_multiple",
    "pad_batch_to_rows",
    "process_slice",
]
