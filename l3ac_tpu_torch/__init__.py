"""l3ac_tpu_torch — the L3AC codec in PyTorch with hand-written CUDA kernels
for the NVIDIA H100 (``sm_90a``).

A port of the JAX package ``l3ac_tpu``, which stays the reference it is held
against. This package imports neither JAX nor ``l3ac_tpu``. Its entry points
run on CUDA unless the caller passes ``device="cpu"``.

Ported so far: the encode path (audio -> FSQ indices),
``models.zoo.get_model(name).encode_audio(audio)``.
"""

from .config import get_config, list_models  # noqa: F401
from .models.zoo import L3AC, get_model  # noqa: F401
