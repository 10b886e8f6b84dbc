"""Range estimation (`fastforward_tpu/range_setting/`): the framework,
min-max and minimum-error estimators, and `estimate_ranges`."""

from fastforward_tpu_torch.range_setting.common import (
    RangeEstimator,
    RangeSettable,
    SimpleEstimatorStep,
    SupportsRangeBasedOperator,
    estimate_ranges,
)
from fastforward_tpu_torch.range_setting.min_error import (
    MinErrorGridRangeEstimator,
    min_error_grid,
    mse_error,
    mse_grid,
    uniform_search_grid,
)
from fastforward_tpu_torch.range_setting.minmax import (
    RunningMinMaxRangeEstimator,
    SmoothedMinMaxRangeEstimator,
    running_minmax,
    smoothed_minmax,
)

__all__ = [
    "estimate_ranges",
    "RangeEstimator",
    "RangeSettable",
    "SupportsRangeBasedOperator",
    "SimpleEstimatorStep",
    "SmoothedMinMaxRangeEstimator",
    "RunningMinMaxRangeEstimator",
    "smoothed_minmax",
    "running_minmax",
    "MinErrorGridRangeEstimator",
    "min_error_grid",
    "mse_grid",
    "mse_error",
    "uniform_search_grid",
]
