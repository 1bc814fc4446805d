"""Frame-parallel diffusion decoding: one request's frames spread over
devices.

Counterpart of ``promptttspp_tpu/parallel/sp.py::decode_frames_sharded``.
JAX shards the frame axis over the mesh's data axis and XLA exchanges the
halos inside every step of the compiled loop. The port keeps the sampler
(the ancestral or PLMS loop, and ``fill_draws``' noise, drawn before the
loop) on the primary device and replaces only the denoiser call: each step
splits x_t into one frame block per device of the data axis, each with a
halo of the DiffNet's receptive radius (the sum over its dilated
convolutions of the frames one reads beyond its centre: 5 * (1 + 2 + 4 +
8) = 75 at the flagship), runs the DiffNet on each block on its device,
and gathers the blocks' interiors. A block at a true end of the sequence
has no halo there, so its convolutions pad as the unsharded ones do ("SAME"
zeros; a zero halo would not be the same, because of the biases and the
conditioner). The interiors then equal the unsharded denoiser's output up
to the order of the convolutions' sums, and the draws are the unsharded
decode's bit for bit. The conditioner projections are split once per
request. The decode runs eagerly.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch
import torch.nn as nn

from promptttspp_tpu_torch.parallel.mesh import replicas


def receptive_radius(denoise_fn) -> int:
    """Frames that one DiffNet call reads on either side of a frame: the
    sum of its dilated convolutions' "SAME" paddings (the 1x1 convolutions
    read none)."""
    radius = 0
    for block in denoise_fn.residual_layers:
        conv = block.dilated_conv
        total = (conv.kernel_size[0] - 1) * conv.dilation[0]
        radius += total - total // 2
    return radius


class FrameShardedDenoiser(nn.Module):
    """A DiffNet whose calls split the frame axis into one block per entry
    of ``devices`` (a device may repeat; its blocks then run one after the
    other), with one replica of ``denoise_fn`` per distinct device. It
    takes the place of ``GaussianDiffusion.denoise_fn``:
    ``precompute_cond`` splits the conditioner projections into the
    blocks' windows on their devices, ``forward`` returns the epsilon
    prediction on x's device."""

    def __init__(self, denoise_fn: nn.Module, devices: Sequence):
        super().__init__()
        self.devices = [torch.device(d) for d in devices]
        self.radius = receptive_radius(denoise_fn)
        self.primary = denoise_fn
        self.replicas = replicas(denoise_fn, self.devices)

    def windows(self, T: int) -> List[Tuple[int, int, int, int]]:
        """(lo, hi, a, b) per block: the window [lo, hi) of frames it reads
        and its interior [a, b) within the window."""
        n = len(self.devices)
        if T % n:
            raise ValueError(f"frame axis {T} not divisible by the data "
                             f"axis {n}")
        size, out = T // n, []
        for i in range(n):
            s, e = i * size, (i + 1) * size
            lo, hi = max(0, s - self.radius), min(T, e + self.radius)
            out.append((lo, hi, s - lo, e - lo))
        return out

    def precompute_cond(self, cond, io_dtype=None):
        projs = self.primary.precompute_cond(cond, io_dtype)
        return [([p[:, lo:hi].to(d) for p in projs], (lo, hi, a, b))
                for d, (lo, hi, a, b) in zip(self.devices,
                                             self.windows(cond.shape[1]))]

    def forward(self, x, diffusion_step, cond_projs):
        outs = []
        for d, (projs, (lo, hi, a, b)) in zip(self.devices, cond_projs):
            eps = self.replicas[d](x[:, lo:hi].to(d), diffusion_step.to(d),
                                   projs)
            outs.append(eps[:, a:b].to(x.device))
        return torch.cat(outs, dim=1)


def decode_frames_sharded(mesh, decoder, cond, x_T=None,
                          zero_noise: bool = False, generator=None,
                          denoiser: FrameShardedDenoiser = None):
    """``decoder.inference(cond, x_T, zero_noise, generator)`` with every
    denoiser call split over ``mesh``'s data axis (``denoiser``: a
    ``FrameShardedDenoiser`` of ``decoder.denoise_fn`` over those devices,
    built here when not given). cond [B, Tf, C] on the primary device; Tf
    must divide by the data axis."""
    devices = mesh.data_devices
    if cond.shape[1] % len(devices):
        raise ValueError(f"frame axis {cond.shape[1]} not divisible by the "
                         f"data axis {len(devices)}")
    if denoiser is None:
        denoiser = FrameShardedDenoiser(decoder.denoise_fn, devices)
    return decoder.clone(denoise_fn=denoiser).inference(
        cond, x_T=x_T, zero_noise=zero_noise, generator=generator)
