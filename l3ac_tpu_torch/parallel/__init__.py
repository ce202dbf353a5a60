"""Parallelism on ``torch.distributed`` (``l3ac_tpu/parallel``): the
(dp, sp, tp) layout (``mesh``), process start-up (``distributed``) and
sequence parallelism with halo exchange (``sp``, ``halo``)."""
