"""Atomic data tables, read by path from the JAX package's ``data/`` folder.

The tables (``verner_photo.npz``, ``verner_rec.npz``, ``linecooling.npz``)
are published atomic data that ``cmacionize_tpu/data/`` already holds; the
port reads the same files with ``np.load`` instead of carrying a copy.  It
does not import ``cmacionize_tpu.data``: importing any module of that package
runs its ``__init__``, which imports JAX.
"""

from __future__ import annotations

import functools
from pathlib import Path

import numpy as np

DATA_DIR = Path(__file__).resolve().parent.parent / "cmacionize_tpu" / "data"


@functools.lru_cache(maxsize=None)
def load(name: str) -> dict:
    """The arrays of ``DATA_DIR/<name>`` as a dict of read-only numpy arrays."""
    with np.load(DATA_DIR / name) as archive:
        arrays = {key: archive[key] for key in archive.files}
    for array in arrays.values():
        array.setflags(write=False)
    return arrays


def verner_photo_tables():
    """(a_params [31,31,8,7], b_params [31,31,9], c_params [31,2])."""
    data = load("verner_photo.npz")
    return data["a_params"], data["b_params"], data["c_params"]


def verner_rec_tables():
    """(rrec [2,31,31], rnew [4,31,31], fe [3,14])."""
    data = load("verner_rec.npz")
    return data["rrec"], data["rnew"], data["fe"]


def linecooling_tables():
    """(five_A [10,10], five_E [10,10], five_invw [10,5], five_gamma [10,10,7],
    two_A [3], two_E [3], two_invw [3,2], two_gamma [3,7])."""
    d = load("linecooling.npz")
    return (
        d["five_A"], d["five_E"], d["five_invw"], d["five_gamma"],
        d["two_A"], d["two_E"], d["two_invw"], d["two_gamma"],
    )
