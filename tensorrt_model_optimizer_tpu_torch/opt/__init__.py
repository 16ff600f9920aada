"""Replayable optimization state, save / restore and the QAT trainer (port of
`tensorrt_model_optimizer_tpu.opt`: `mode`, `state`, `trainer`)."""
