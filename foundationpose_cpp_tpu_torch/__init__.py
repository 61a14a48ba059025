"""foundationpose_cpp_tpu_torch: FoundationPose on PyTorch and CUDA (H100).

A port of ``foundationpose_cpp_tpu`` (JAX/XLA/Pallas), which stays beside it
as the reference: model-based Register (252 icosphere hypotheses -> render
and compare refine -> score -> argmax) and per-frame Track, for RGB-D input
and textured meshes. Its two hand-written CUDA kernels (``csrc/``) take the
place of the JAX package's Pallas kernels on the main path: the render
branch and the packed-qkv attention. Around them: size buckets, the
packed-frame tracker and the async tracker over a native frame ring
(``pipeline/``, ``native/``), the named-blob inference cores
(``create_refiner_core``, ``create_scorer_core``), the scanned-mesh ingest
(native PLY/OBJ parsers, decimation, adaptive subdivision: ``meshio/``),
the hypothesis split over several cards (``parallel/``), the demos and the
bench (``bench.py``). Entry points run on the
card unless the caller passes ``device="cpu"``. Nothing here imports JAX.

TF32 is switched off for matmuls and cuDNN convolutions: geometry and
render code run in f32, and under TF32 the clip transform, the edge
coefficients and the crop-window rounding move (the JAX package pins
``Precision.HIGHEST`` for the same reason). The nets run in bf16, which
TF32 does not touch.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

from foundationpose_cpp_tpu_torch.config import (  # noqa: E402
    DEFAULT_CONFIG,
    FoundationPoseConfig,
)
from foundationpose_cpp_tpu_torch.meshio.mesh_loader import (  # noqa: E402
    MeshAsset,
    load_mesh,
    make_mesh_asset,
)
from foundationpose_cpp_tpu_torch.models import networks  # noqa: E402
from foundationpose_cpp_tpu_torch.models.infer_core import (  # noqa: E402
    create_refiner_core,
    create_scorer_core,
)
from foundationpose_cpp_tpu_torch.pipeline.foundationpose import (  # noqa: E402
    FoundationPose,
    create_foundationpose_model,
)

__all__ = [
    "DEFAULT_CONFIG",
    "FoundationPoseConfig",
    "FoundationPose",
    "MeshAsset",
    "create_foundationpose_model",
    "create_refiner_core",
    "create_scorer_core",
    "load_mesh",
    "make_mesh_asset",
    "networks",
]

__version__ = "0.1.0"
