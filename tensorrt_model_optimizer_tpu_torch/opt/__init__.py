"""Replayable optimization state, save / restore, the QAT trainer and the
search framework (port of `tensorrt_model_optimizer_tpu.opt`: `mode`,
`state`, `trainer`, `hparam`, `searcher`, `dependency`)."""
