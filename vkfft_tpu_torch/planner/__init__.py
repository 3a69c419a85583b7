from vkfft_tpu_torch.planner.factorize import (
    Algorithm,
    SizeDecomposition,
    decompose,
    is_prime,
    next_smooth,
    prime_factors,
)
from vkfft_tpu_torch.planner.plan import AxisPlan, Stage, build_stages, plan_axis
