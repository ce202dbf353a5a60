"""Parallelism on ``torch.distributed`` (``l3ac_tpu/parallel``): the
(dp, sp, tp) layout (``mesh``), process start-up (``distributed``),
sequence parallelism with halo exchange (``sp``, ``halo``), tensor
parallelism (``tp``, its split rules ``sharding``) and the collectives
they share (``comm``)."""
