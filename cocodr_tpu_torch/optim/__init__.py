from cocodr_tpu_torch.optim.lamb import Lamb  # noqa: F401
from cocodr_tpu_torch.optim.schedules import (  # noqa: F401
    warmup_constant,
    warmup_cosine,
    warmup_linear,
)
