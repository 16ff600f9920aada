"""Unified HF checkpoint export (port of `tensorrt_model_optimizer_tpu.export`)."""
