"""Result reporting and export (host numpy).

Counterpart of the JAX package's `props/export.py`, reading the port's
`ExcitationResult`:

- ``excitation_table``: the standardized results table every reference
  method prints (num/energy/wav_len/osc_str/rot_str/deltaS2,
  `xtddft/XTDA.py:442-446`)
- ``uv_spectrum`` / ``save_spectrum_csv``: Gaussian-broadened UV spectrum
  export (`xtddft/TDA.py:205-217` ``savedata``)
- ``save_results`` / ``load_results``: an ExcitationResult to and from
  .npz, in the JAX package's format (either package reads the other's)
"""

from __future__ import annotations

import numpy as np

from xtddft_tpu_torch import units


def excitation_table(result, title: str = "excitation results") -> str:
    e_eV = result.e * units.HA2EV
    n = len(e_eV)
    osc = result.osc if result.osc is not None else np.zeros(n)
    rot = result.rot if result.rot is not None else np.zeros(n)
    ds2 = result.ds2 if result.ds2 is not None else np.zeros(n)
    lines = [
        title,
        f'{"num":>4} {"energy":>9} {"wav_len":>9} {"osc_str":>9} '
        f'{"rot_str":>9} {"deltaS2":>9}',
    ]
    for k in range(n):
        wl = units.EV_X_NM / e_eV[k] if abs(e_eV[k]) > 1e-12 else np.inf
        lines.append(
            f"{k + 1:4d} {e_eV[k]:9.4f} {wl:9.2f} {osc[k]:9.4f} "
            f"{rot[k]:9.4f} {ds2[k]:9.4f}"
        )
    return "\n".join(lines)


def uv_spectrum(result, e_min_ev: float = 0.5, e_max_ev: float = 10.0,
                npts: int = 2000, fwhm_ev: float = 0.4):
    """(energies_eV, intensity) Gaussian-broadened absorption spectrum."""
    e_eV = result.e * units.HA2EV
    osc = result.osc if result.osc is not None else np.ones_like(e_eV)
    x = np.linspace(e_min_ev, e_max_ev, npts)
    sigma = fwhm_ev / (2.0 * np.sqrt(2.0 * np.log(2.0)))
    y = np.zeros_like(x)
    for ek, fk in zip(e_eV, osc):
        y += fk * np.exp(-0.5 * ((x - ek) / sigma) ** 2)
    return x, y


def save_spectrum_csv(result, path: str, **kw) -> None:
    x, y = uv_spectrum(result, **kw)
    np.savetxt(
        path,
        np.column_stack([x, units.EV_X_NM / x, y]),
        delimiter=",",
        header="energy_eV,wavelength_nm,intensity",
        comments="",
    )


def save_results(result, path: str) -> None:
    """Write an ExcitationResult (resume or analysis without re-solving)."""
    data = {"e": result.e, "v": result.v, "converged": np.array(result.converged)}
    for k in ("osc", "rot", "ds2"):
        val = getattr(result, k)
        if val is not None:
            data[k] = val
    np.savez(path, **data)


def load_results(path: str):
    from xtddft_tpu_torch.methods.drivers import ExcitationResult

    z = np.load(path)
    return ExcitationResult(
        e=z["e"],
        v=z["v"],
        osc=z["osc"] if "osc" in z else None,
        rot=z["rot"] if "rot" in z else None,
        ds2=z["ds2"] if "ds2" in z else None,
        converged=bool(z["converged"]),
    )
