from repro_torch.dp.accountant import (
    RDPAccountant, compute_rdp_sgm, rdp_to_eps, DEFAULT_ORDERS)
from repro_torch.dp.clip import per_example_clipped_grad_sum
from repro_torch.dp.noise import add_gaussian_noise
from repro_torch.dp.engine import validate_grad_mode

__all__ = [
    "RDPAccountant", "compute_rdp_sgm", "rdp_to_eps", "DEFAULT_ORDERS",
    "per_example_clipped_grad_sum", "add_gaussian_noise",
    "validate_grad_mode",
]
