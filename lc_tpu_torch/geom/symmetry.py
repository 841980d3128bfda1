"""Symmetric objects per BOP dataset (copy of the table in
lc_tpu/geom/symmetry.py; the symmetry-aware target selection arrives with the
training slice)."""

DATASET_SYMMETRIC_OBJ_IDS = {
    "lm": [3, 7, 10, 11],
    "lmo": [10, 11],
    "tless": list(range(1, 31)),
    "tudl": [],
    "tyol": [3, 4, 5, 6, 7, 8, 10, 11, 12, 13, 15, 16, 17, 18, 19, 21],
    "ruapc": [8, 9, 12, 13],
    "icmi": [1, 2, 6],
    "icbin": [1],
    "itodd": [2, 3, 4, 5, 7, 8, 9, 11, 12, 14, 17, 18, 19, 23, 24, 25, 27, 28],
    "hbs": [10, 12, 18, 29],
    "hb": [6, 10, 11, 12, 13, 14, 18, 24, 29],
    "ycbv": [1, 13, 14, 16, 18, 19, 20, 21],
    "ycbvposecnn": [13, 16, 19, 20, 21],
    "synthetic": [],
    "synthetic_sym": [1],
}
