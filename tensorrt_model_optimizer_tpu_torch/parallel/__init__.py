"""Multi-GPU parallelism (port of `parallel/`): the mesh of named axes over
`torch.distributed` process groups and its collectives (`mesh.py`), ring
attention over a context axis (`ring_attention.py`) and the GPipe forward
over a pipe axis (`pipeline.py`)."""
