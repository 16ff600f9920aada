"""Utilities (port of `tensorrt_model_optimizer_tpu.utils`): the synthetic
language of the trained anchors."""
