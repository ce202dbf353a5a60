"""l3ac_tpu_torch — the L3AC codec in PyTorch with hand-written CUDA kernels
for the NVIDIA H100 (``sm_90a``).

A port of the JAX package ``l3ac_tpu``, which stays the reference it is held
against. This package imports neither JAX nor ``l3ac_tpu``. Its entry points
run on CUDA unless the caller passes ``device="cpu"``.

Ported so far: the encode and decode paths (``models.zoo.get_model(name)``,
``encode_audio``, ``decode_audio``, ``roundtrip``), int8 weight-only
inference (``ops.quantized``), the chunked ``extract_unit`` / ``decode_unit``,
``get_model_info``, checkpoints (``runtime.convert``: the reference's
``.pt`` files, never downloaded; ``runtime.checkpoint``: JAX's ``.npz``),
``runtime.streaming.StreamCodec`` with the C++ framer (``runtime.native``),
WAV I/O and metrics (``utils``) and the CLI (``python -m l3ac_tpu_torch``).
"""

from .config import get_config, list_models  # noqa: F401
from .models.zoo import L3AC, get_model, get_model_info  # noqa: F401
