"""Layer-local optimization algorithms (`fastforward_tpu/algorithms/`): GPTQ
and the layer-wise loops that feed it calibration inputs."""

from fastforward_tpu_torch.algorithms.gptq import (
    calculate_hessian,
    gptq,
    gptq_quantize,
    invert_hessian,
)
from fastforward_tpu_torch.algorithms.layerwise import (
    layerwise_optimize,
    layerwise_optimize_staged,
)

__all__ = [
    "gptq",
    "gptq_quantize",
    "calculate_hessian",
    "invert_hessian",
    "layerwise_optimize",
    "layerwise_optimize_staged",
]
