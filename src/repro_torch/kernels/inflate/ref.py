"""Plain PyTorch version of the inflate kernel (= core.huffman.inflate_gap):
the same n_sub lockstep subchunk cursors per chunk, `sub_size` sequential
steps each."""
from repro_torch.core import huffman as hf


def inflate_gap_ref(words, n_valid, gap_bits, table: hf.DecodeTable,
                    sub_size: int):
    return hf.inflate_gap(words, n_valid, gap_bits, table, sub_size)
