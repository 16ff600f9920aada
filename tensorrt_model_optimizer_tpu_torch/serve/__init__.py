"""Serving engine and sampling (port of `tensorrt_model_optimizer_tpu.serve`)."""
