"""Device-side preprocessing: normalize and spike-encode uint8 frames.

- ``preprocess_video``: (B, T, H, W, 3) uint8 -> time-major (T, B, H, W, 3)
  in [0, 1]. The transpose runs on the uint8 bytes, ``/255`` is computed in
  fp32 and rounded once to the compute dtype.
- ``encode_direct``: repeat a frame at every timestep (constant-current
  encoding).
- ``encode_rate``: Bernoulli spikes with p = pixel intensity per timestep,
  drawn from an explicit ``torch.Generator`` (other bits than
  ``jax.random`` gives for the same seed; the same distribution).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def preprocess_video(
    images_u8: torch.Tensor,
    out_hw: tuple[int, int] | None = None,
    dtype: torch.dtype = torch.bfloat16,
) -> torch.Tensor:
    """(B, T, H, W, 3) uint8 -> (T, B, H', W', 3) ``dtype`` in [0, 1]."""
    x = images_u8.permute(1, 0, 2, 3, 4)  # (T, B, H, W, 3) uint8
    xf = x.float() * (1.0 / 255.0)
    if out_hw is not None and tuple(out_hw) != tuple(x.shape[2:4]):
        # Resize BEFORE the output-dtype cast (no double rounding).
        t, b, h, w, c = xf.shape
        xf = F.interpolate(
            xf.reshape(t * b, h, w, c).permute(0, 3, 1, 2),
            size=tuple(out_hw), mode="bilinear", align_corners=False,
            antialias=True,  # jax.image.resize antialiases a downscale
        ).permute(0, 2, 3, 1).reshape(t, b, out_hw[0], out_hw[1], c)
    return xf.to(dtype).contiguous()


def encode_direct(
    image_u8: torch.Tensor,
    timesteps: int,
    out_hw: tuple[int, int] | None = None,
    dtype: torch.dtype = torch.bfloat16,
) -> torch.Tensor:
    """(B, H, W, 3) uint8 -> (T, B, H', W', 3) in ``dtype``, the frame
    repeated T times."""
    x = preprocess_video(image_u8[:, None], out_hw, dtype)  # (1, B, H', W', 3)
    return x.repeat(timesteps, 1, 1, 1, 1)


def encode_rate(
    image_u8: torch.Tensor,
    generator: torch.Generator,
    timesteps: int,
    out_hw: tuple[int, int] | None = None,
    dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """(B, H, W, 3) uint8 -> (T, B, H', W', 3) Bernoulli spike trains in
    ``dtype``. ``generator`` must live on the image's device. Spikes are
    exactly 0/1, so the cast is lossless; the threshold compare is fp32."""
    x = preprocess_video(image_u8[:, None], out_hw, torch.float32)[0]
    u = torch.rand((timesteps, *x.shape), generator=generator, device=x.device,
                   dtype=torch.float32)
    return (u < x[None]).to(dtype)
