"""Speculative decoding: the tree verifier, Medusa, EAGLE-1 / EAGLE-3 and
DFlash drafters with their training steps (port of
`tensorrt_model_optimizer_tpu.speculative`)."""
