"""XC functional registry: name -> components + hybrid/RSH coefficients.

Same table as the JAX package's `xc/registry.py`; mirrors the role of libxc's compound functionals + PySCF's
``rsh_and_hybrid_coeff`` (used throughout the reference, e.g.
`xtddft/TDA.py:91`, `xtddft/XSF_TDA.py:205`).

An :class:`XCSpec` holds
- ``components``: [(weight, functional_name)] evaluated on the grid
- ``hyb``: short-range/global HF exchange fraction
- ``alpha``: long-range HF exchange fraction (RSH; alpha=hyb when omega=0)
- ``omega``: range-separation parameter (0 = global hybrid)
- ``xc_type``: 'lda' | 'gga' | 'hf'
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class XCSpec:
    name: str
    components: tuple[tuple[float, str], ...]
    hyb: float = 0.0
    alpha: float = 0.0
    omega: float = 0.0
    xc_type: str = "gga"

    @property
    def is_hybrid(self) -> bool:
        return abs(self.hyb) > 1e-12 or abs(self.alpha) > 1e-12

    @property
    def needs_tau(self) -> bool:
        return self.xc_type == "mgga"


_REGISTRY: dict[str, XCSpec] = {}


def _reg(name, components, hyb=0.0, alpha=None, omega=0.0, xc_type="gga"):
    spec = XCSpec(
        name=name,
        components=tuple(components),
        hyb=hyb,
        alpha=hyb if alpha is None else alpha,
        omega=omega,
        xc_type=xc_type,
    )
    _REGISTRY[name] = spec
    return spec


_reg("hf", [], hyb=1.0, xc_type="hf")
_reg("lda", [(1.0, "slater")], xc_type="lda")
_reg("svwn", [(1.0, "slater"), (1.0, "vwn5")], xc_type="lda")
_reg("svwn3", [(1.0, "slater"), (1.0, "vwn3")], xc_type="lda")
_reg("blyp", [(1.0, "b88"), (1.0, "lyp")])
_reg("pbe", [(1.0, "pbe_x"), (1.0, "pbe_c")])
# B3LYP, libxc convention: VWN_RPA (VWN3) in the LDA correlation slot
_reg(
    "b3lyp",
    [(0.80, "slater"), (0.72, "b88_gc"), (0.19, "vwn3"), (0.81, "lyp")],
    hyb=0.20,
)
# B3LYP5: VWN5 variant
_reg(
    "b3lyp5",
    [(0.80, "slater"), (0.72, "b88_gc"), (0.19, "vwn5"), (0.81, "lyp")],
    hyb=0.20,
)
_reg("bhandhlyp", [(0.5, "b88"), (1.0, "lyp")], hyb=0.5)
_reg("bhhlyp", [(0.5, "b88"), (1.0, "lyp")], hyb=0.5)
_reg("pbe0", [(0.75, "pbe_x"), (1.0, "pbe_c")], hyb=0.25)
# CAM-B3LYP (Yanai et al., CPL 393, 51): HF exchange alpha + beta*erf
# with alpha=0.19, beta=0.46; the DFT-exchange complement is
# (1-alpha-beta)*B88 + beta*SR-B88(omega) with the ITYH attenuation
# (`xc/functionals.make_b88_sr`); correlation 0.19 VWN5 + 0.81 LYP.
_reg(
    "camb3lyp",
    [(0.35, "b88"), (0.46, "b88_sr@0.33"), (0.19, "vwn5"), (0.81, "lyp")],
    hyb=0.19,
    alpha=0.65,
    omega=0.33,
)
# meta-GGA (tau-dependent): TPSS and the 10%-exchange TPSSh hybrid
_reg("tpss", [(1.0, "tpss_x"), (1.0, "tpss_c")], xc_type="mgga")
_reg("tpssh", [(0.90, "tpss_x"), (1.0, "tpss_c")], hyb=0.10,
     xc_type="mgga")


def resolve(name: str) -> XCSpec:
    key = name.strip().lower().replace("-", "").replace("_", "")
    if key in _REGISTRY:
        return _REGISTRY[key]
    raise ValueError(f"unknown xc functional {name!r}; known: {sorted(_REGISTRY)}")
