"""Model definitions and loaders (port of `tensorrt_model_optimizer_tpu.models`)."""
