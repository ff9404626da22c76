"""Hand-written CUDA kernels of the main path, each beside its plain version.

| kernel        | replaces (JAX package)                      | module          |
|---------------|---------------------------------------------|-----------------|
| `df_exchange` | `response/sigma_df.py:399` `_jk`            | `df_exchange`   |
| `grid_rho1`   | `response/sigma_df.py:495` `_fxc.rho1`      | `grid_rho1`     |
| `grid_back`   | `response/sigma_df.py:525` `_fxc.back`      | `grid_back`     |

Every wrapper runs its plain torch version on CPU tensors, launches its
kernel on CUDA tensors (or raises), and counts its launches in the module's
``launches`` integer.
"""

from xtddft_tpu_torch.kernels import df_exchange, grid_back, grid_rho1

MODULES = (df_exchange, grid_rho1, grid_back)


def launch_counts() -> dict[str, int]:
    return {m.NAME: m.launches for m in MODULES}


def reset_launch_counts() -> None:
    for m in MODULES:
        m.launches = 0


def build_all() -> None:
    """Compile every kernel library (at first use this is what builds)."""
    from xtddft_tpu_torch.kernels import _cuda

    for m in MODULES:
        _cuda.load(m.NAME, m._ARGS)


__all__ = ["MODULES", "launch_counts", "reset_launch_counts", "build_all"]
