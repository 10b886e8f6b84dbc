"""`fastforward_tpu_torch.nn.functional` — alias of the quantized operator
namespace (`fastforward_tpu/nn/functional.py`): the same operators are
importable from both `fastforward_tpu_torch.ops` and here."""

from fastforward_tpu_torch.ops import *  # noqa: F401,F403
from fastforward_tpu_torch.ops import (  # noqa: F401
    OPERATOR_TABLE,
    get_operator,
    scaled_dot_product_attention,
    sdpa_upcast,
)
