"""Plain PyTorch version of the fused zigzag + bit-plane shuffle.

Encode maps each quant code to its zigzag distance from the bin radius
(near-prediction codes become small unsigned values whose high bit planes
are all zero; the OUTLIER code 0 lands on nbins−1), then transposes each
chunk into P = bitlength(nbins−1) bit planes of chunk/32 uint32 words:

  planes[c, p, w] bit l  =  bit p of zigzag(codes[c, 32·w + l])

Decode is the exact bitwise inverse.  Planes are `torch.uint32` tensors;
the arithmetic runs on int64 in [0, 2^32), because PyTorch on the CPU has
no uint32 shifts.
"""
from __future__ import annotations

import torch

from repro_torch.core import huffman as hf


def nplanes(nbins: int) -> int:
    """Bit planes needed for the zigzag code domain [0, nbins)."""
    return max(1, int(nbins - 1).bit_length())


def zigzag(codes: torch.Tensor, nbins: int) -> torch.Tensor:
    """int32 codes -> zigzag(code − nbins/2) as int64 values in [0, 2^32),
    computed in int32 as the reference does."""
    d = codes.to(torch.int32) - nbins // 2
    v = (d << 1) ^ (d >> 31)
    return v.to(torch.int64) & 0xFFFFFFFF


def encode_planes_ref(codes2: torch.Tensor, nbins: int) -> torch.Tensor:
    """[nc, chunk] int32 codes in [0, nbins) -> [nc, P, chunk/32] uint32."""
    nc, chunk = codes2.shape
    if chunk % 32:
        raise ValueError(f"chunk {chunk} is not a multiple of 32")
    vw = zigzag(codes2, nbins).reshape(nc, chunk // 32, 32)
    lane = torch.arange(32, dtype=torch.int64, device=codes2.device)
    planes = torch.stack([(((vw >> p) & 1) << lane).sum(-1)
                          for p in range(nplanes(nbins))], dim=1)
    return hf.as_u32(planes)


def decode_planes_ref(planes: torch.Tensor, nbins: int) -> torch.Tensor:
    """[nc, P, W] uint32 planes -> [nc, 32·W] int32 codes."""
    nc, p_count, w = planes.shape
    words = hf.u32_values(planes)                     # [nc, P, W] int64
    lane = torch.arange(32, dtype=torch.int64, device=planes.device)
    v = torch.zeros((nc, w, 32), dtype=torch.int64, device=planes.device)
    for p in range(p_count):
        v |= ((words[:, p, :, None] >> lane) & 1) << p
    vi = v.reshape(nc, w * 32).to(torch.int32)
    d = (vi >> 1) ^ -(vi & 1)                          # un-zigzag
    return d + nbins // 2
