"""Parallelism of the port: data, tensor and pipeline parallelism across
processes in training, frame and pipeline parallelism across the devices of
one process in serving."""

from promptttspp_tpu_torch.parallel.distributed import (
    DataGroup, ModelGroup, host_batches, init_distributed, mesh_process_rows,
    process_groups, process_slice)
from promptttspp_tpu_torch.parallel.mesh import (
    Mesh, make_mesh, pad_batch_to_multiple, pad_batch_to_rows)
from promptttspp_tpu_torch.parallel.pp import (
    StageDevices, StageGroup, denoise_pipelined)
from promptttspp_tpu_torch.parallel.sp import (
    FrameShardedDenoiser, decode_frames_sharded)
from promptttspp_tpu_torch.parallel.tp import (
    gather_state_dict, local_state_dict, param_partition_spec, shard_module)

__all__ = [
    "DataGroup",
    "FrameShardedDenoiser",
    "Mesh",
    "ModelGroup",
    "StageDevices",
    "StageGroup",
    "decode_frames_sharded",
    "denoise_pipelined",
    "gather_state_dict",
    "host_batches",
    "init_distributed",
    "local_state_dict",
    "make_mesh",
    "mesh_process_rows",
    "pad_batch_to_multiple",
    "pad_batch_to_rows",
    "param_partition_spec",
    "process_groups",
    "process_slice",
    "shard_module",
]
