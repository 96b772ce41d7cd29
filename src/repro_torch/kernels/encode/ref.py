"""Plain PyTorch version of the encode kernel (= core.huffman.encode)."""
from repro_torch.core import huffman as hf


def encode_ref(codes, cb: hf.Codebook):
    return hf.encode(codes, cb)
