"""Nuclear gradients.

Counterpart of the JAX package's `grad/`:

- `fd`: finite-difference gradients of ground- and excited-state energies
  for every SCF kind and method driver;
- `analytic`: the analytic HF ground-state gradient from the derivative
  integrals, its two-electron term on K5 `eri_grad`;
- `lagrangian`: analytic excited-state (and ground-state) gradients of
  every method through a differentiable Lagrangian, its ERI derivative on
  K5 (`xcgrid`: the differentiable XC quadrature; `x2c_diff`: the
  differentiable sfX2C core Hamiltonian).
"""

from xtddft_tpu_torch.grad.analytic import hf_gradient
from xtddft_tpu_torch.grad.fd import fd_excited_gradient, fd_gradient
from xtddft_tpu_torch.grad.lagrangian import ExcitedGradients, scf_gradient

__all__ = ["fd_gradient", "fd_excited_gradient", "hf_gradient", "ExcitedGradients",
           "scf_gradient"]
