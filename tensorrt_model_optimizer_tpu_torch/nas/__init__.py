"""Neural architecture search (port of `tensorrt_model_optimizer_tpu.nas`):
AutoNAS and FastNAS over Llama width / depth subnets (`autonas`). `cv` (it
needs the unet model) is not ported."""
