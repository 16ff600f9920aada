"""Structured pruning (port of `tensorrt_model_optimizer_tpu.prune`):
Minitron width / depth pruning of Llama (`minitron`) and expert pruning of
the routed-MoE families (`minitron_moe`). `minitron_hybrid` (it needs the
mamba models) is not ported."""
