"""Host-side runtime: checkpoint conversion and files, chunked streaming and
the C++ stream framer (``l3ac_tpu/runtime``)."""
