"""Hand-written CUDA kernels for Hopper and their wrappers (counterpart of
`tensorrt_model_optimizer_tpu.ops.pallas`). Importing builds nothing: each
kernel is compiled at its first launch (`_build.py`)."""
