"""Heterogeneous block-substitution NAS (port of `tensorrt_model_optimizer_tpu.puzzletron`)."""
