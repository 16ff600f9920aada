"""Numerics and kernels (port of `tensorrt_model_optimizer_tpu.ops`)."""
