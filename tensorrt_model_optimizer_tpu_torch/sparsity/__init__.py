"""Sparsity (port of `tensorrt_model_optimizer_tpu.sparsity`): N:M weight
sparsity by magnitude or SparseGPT (`magnitude`, `sparsegpt`, `sparsify`),
and attention sparsity (skip-softmax, VSA) with its RULER calibration."""
