"""Diffusion acceleration (port of `tensorrt_model_optimizer_tpu.fastgen`):
DMD2's losses and discriminator (`dmd`), flow matching, the deterministic
sampler, few-step distillation and EMA (`trainers`), over the DiT."""
