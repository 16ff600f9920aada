"""Utilities (port of `tensorrt_model_optimizer_tpu.utils`): datasets and
evaluation, the synthetic language of the trained anchors, logging, device
memory, timers and run tracking."""
