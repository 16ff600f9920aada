"""LoRA adapters and QLoRA (port of `tensorrt_model_optimizer_tpu.peft`)."""
