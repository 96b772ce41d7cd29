"""Bit-plane shuffle encoder with zero-plane elision (FZ-GPU, arXiv
2304.12557) behind the `Encoder` stage protocol.

Where Huffman pays for a histogram, a host codebook build and a deflate,
this stage is one fused kernel (zigzag-map the quant codes and transpose
each chunk into bit planes) plus a nonzero reduction.  The device payload
stays fixed-shape (dense [nc, P, W] planes + a per-(chunk, plane) nonzero
flag); `pack_payload` drops the all-zero planes on the host at the
storage boundary, which is where the ratio comes from: near-prediction
codes have small zigzag values, so the high planes of well-predicted
chunks vanish.

Decode needs no host preparation: the dense planes invert in one kernel.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels.bitshuffle import ops as bitshuffle_ops
from repro_torch.kernels.bitshuffle.ref import nplanes

from . import stages


class BitshuffleEncoder(stages.Encoder):
    name = "bitshuffle"
    kernels = ("bitshuffle.encode", "bitshuffle.decode")
    payload_keys = ("planes", "plane_nz")

    def encode(self, codes, cfg, pp):
        flat = codes.reshape(-1)
        chunk = int(cfg.chunk_size)
        n = flat.shape[0]
        nc = -(-n // chunk)
        pad = nc * chunk - n
        if pad:
            # pad with the zigzag-zero code (= radius): it adds only zero
            # bits, so it never un-elides a plane
            flat = torch.cat([flat, torch.full((pad,), cfg.nbins // 2,
                                               dtype=torch.int32,
                                               device=flat.device)])
        planes = bitshuffle_ops.encode_planes(
            flat.reshape(nc, chunk), cfg.nbins,
            impl=pp.for_kernel("bitshuffle.encode"))
        # a plane word is nonzero iff its int32 view is
        nz = (planes.view(torch.int32) != 0).any(dim=-1).to(torch.int32)
        return {"planes": planes, "plane_nz": nz}

    def decode(self, payload, aux, static_meta, cfg, pp):
        return bitshuffle_ops.decode_planes(
            payload["planes"], cfg.nbins,
            impl=pp.for_kernel("bitshuffle.decode")).reshape(-1)

    def pack_payload(self, payload):
        planes = np.asarray(payload["planes"])
        nz = np.asarray(payload["plane_nz"]).astype(bool)
        kept = planes[nz]                       # [K, W] nonzero planes only
        return {
            "planes_packed": kept.reshape(-1).astype(np.uint32),
            "plane_nz": np.packbits(nz.reshape(-1)),
            "n_chunks": np.int32(planes.shape[0]),
            "chunk_words": np.int32(planes.shape[2]),
        }

    def unpack_payload(self, packed, cfg, n_sym):
        nc = int(packed["n_chunks"])
        w = int(packed["chunk_words"])
        p_count = nplanes(int(cfg.nbins))
        nz = np.unpackbits(np.asarray(packed["plane_nz"], np.uint8),
                           count=nc * p_count).astype(bool).reshape(
                               nc, p_count)
        planes = np.zeros((nc, p_count, w), np.uint32)
        planes[nz] = np.asarray(packed["planes_packed"],
                                np.uint32).reshape(-1, w)
        return {"planes": planes, "plane_nz": nz.astype(np.int32)}

    def stored_nbytes(self, packed):
        # kept plane words + the elision bitmap + O(1) shape scalars
        return (np.asarray(packed["planes_packed"]).nbytes
                + np.asarray(packed["plane_nz"]).nbytes + 8)


stages.register_encoder("bitshuffle", BitshuffleEncoder)
