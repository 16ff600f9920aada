"""Quantizers, presets, PTQ and compression (port of
`tensorrt_model_optimizer_tpu.quant`)."""
