"""cuSZ core in PyTorch: dual-quantization, canonical Huffman coding, the
predictor/encoder stages, the compressor and the quality metrics.

The public compression contract is the `repro_torch.codecs` registry
(`codecs.get("cusz").encode/decode`); these modules are its engines."""
