"""Typed YAML recipes (port of `tensorrt_model_optimizer_tpu.recipes`)."""
