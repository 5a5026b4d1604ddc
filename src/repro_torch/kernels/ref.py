"""The plain PyTorch versions of the seed kernels, under the names of the
reference's oracles (`repro.kernels.ref`): what each kernel is held to."""
from repro_torch.kernels.hinge_grad import hinge_grad_plain as hinge_grad_ref
from repro_torch.kernels.pdomd_update import (
    pdomd_update_plain as pdomd_update_ref)

__all__ = ["pdomd_update_ref", "hinge_grad_ref"]
