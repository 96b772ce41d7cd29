"""Plain PyTorch version of the deflate kernel (= core.huffman.deflate)."""
from repro_torch.core import huffman as hf


def deflate_ref(cw, bw, chunk_size: int, sub_size: int = hf.SUBCHUNK):
    return hf.deflate(cw, bw, chunk_size, sub_size)
