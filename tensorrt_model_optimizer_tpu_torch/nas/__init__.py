"""Neural architecture search (port of `tensorrt_model_optimizer_tpu.nas`):
AutoNAS and FastNAS over Llama width / depth subnets (`autonas`), and
FastNAS / GradNAS channel pruning of a small ConvNet (`cv`)."""
