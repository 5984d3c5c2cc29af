"""Data, Megatron tensor and GPipe pipeline parallelism over
``torch.distributed`` (port of ``rajni_tpu/parallel``): :mod:`.mesh` (the
rank grid, the sharded params, DP and TP forwards), :mod:`.multihost`
(process-sharded evaluation), :mod:`.pipeline` (GPipe), :mod:`.launch`
(spawning the ranks of one machine)."""
