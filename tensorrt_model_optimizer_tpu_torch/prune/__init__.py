"""Structured pruning (port of `tensorrt_model_optimizer_tpu.prune`):
Minitron width / depth pruning of Llama (`minitron`), expert pruning of the
routed-MoE families (`minitron_moe`) and Mamba-head / width / depth pruning
of the hybrid Mamba2 stacks (`minitron_hybrid`)."""
