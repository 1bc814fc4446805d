from promptttspp_tpu_torch.utils.host import (
    make_non_pad_mask,
    make_pad_mask,
    pad_list,
    repeat_by_durations,
    seed_everything,
)
from promptttspp_tpu_torch.utils.progress import progress_map

__all__ = [
    "make_non_pad_mask",
    "make_pad_mask",
    "pad_list",
    "repeat_by_durations",
    "seed_everything",
    "progress_map",
]
