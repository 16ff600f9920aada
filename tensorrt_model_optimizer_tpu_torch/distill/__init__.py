"""Knowledge distillation and QAD (port of `tensorrt_model_optimizer_tpu.distill`)."""
