"""Sparsity (port of `tensorrt_model_optimizer_tpu.sparsity`): attention
sparsity (skip-softmax, VSA) and its RULER calibration."""
