"""Optimizers of the port: AdamW with optional int8 block-quantized
moments (`adamw`)."""
