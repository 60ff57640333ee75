"""The dusty_galaxy deployment of the dust driver, and how its image is judged.

The reference's ``dusty_galaxy.param`` is not in the repository, so the
deployment is built in code with the command line's keys: the galaxy, band
and budget of ``cmacionize_tpu/cli.py:632-685``'s defaults (V band, n0 1
cm^-3, ISM 6 / 0.22 kpc, stars 5 / 0.6 kpc, B/T 0.2, 5e5 photons, a 200 x 200
CCD; 12 orders, DustConfig's default), the 201^3 grid and theta = 89.7 deg of
``benchmarks/RESULTS.md:187-188`` and the [-12 kpc, 12 kpc)^3 box of
``tests/test_dust.py:89``.  ``dust_simulation.dust_config_from_params(
ParameterFile(DUSTY_GALAXY_PARAMS))`` gives its configuration.
"""

from __future__ import annotations

import numpy as np

DUSTY_GALAXY_PARAMS = {
    "SimulationBox": {"anchor": "[-12. kpc, -12. kpc, -12. kpc]",
                      "sides": "[24. kpc, 24. kpc, 24. kpc]",
                      "periodicity": [False, False, False]},
    "DensityGrid": {"number of cells": [201, 201, 201]},
    "DensityFunction": {"central density": "1. cm^-3", "scale length ISM": "6. kpc",
                        "scale height ISM": "0.22 kpc"},
    "ContinuousPhotonSource": {"scale length stars": "5. kpc", "scale height stars": "0.6 kpc",
                               "bulge over total ratio": 0.2},
    "dust": {"band": "V"},
    "DustSimulation": {"number of photons": 500000},
    "CCDImage": {"image width": 200, "image height": 200, "view theta": "89.7 degrees",
                 "view phi": "0. degrees"},
}


def image_measures(reference: np.ndarray, image: np.ndarray) -> dict:
    """How far a CCD image is from a reference image of the same shape, by
    the image-level measures of ``benchmarks/compare_reference.py:compare_dusty``
    (Monte Carlo noise is large per pixel): the correlation of the two
    flux-normalized images, the largest difference of their flux centroids
    (pixels, per axis), the largest relative deviation of the azimuthally
    averaged radial profile around the reference's centroid over its bins
    above 1e-3 of the peak, and the relative difference of the total flux."""
    ref = np.asarray(reference, np.float64)
    img = np.asarray(image, np.float64)
    nref, nimg = ref / ref.sum(), img / img.sum()
    corr = float(np.corrcoef(nref.ravel(), nimg.ravel())[0, 1])
    iy, ix = np.indices(ref.shape)
    c_ref = np.array([(ix * nref).sum(), (iy * nref).sum()])
    c_img = np.array([(ix * nimg).sum(), (iy * nimg).sum()])
    rr = np.sqrt((ix - c_ref[0]) ** 2 + (iy - c_ref[1]) ** 2)
    edges = np.linspace(0, ref.shape[0] / 2.0, 20)
    which = np.digitize(rr, edges) - 1  # bin i holds edges[i] <= r < edges[i + 1]
    inside = (which >= 0) & (which < len(edges) - 1)
    counts = np.bincount(which[inside], minlength=len(edges) - 1)
    with np.errstate(invalid="ignore", divide="ignore"):
        prof_ref = np.bincount(which[inside], nref[inside], len(edges) - 1) / counts
        prof_img = np.bincount(which[inside], nimg[inside], len(edges) - 1) / counts
    ok = np.isfinite(prof_ref) & (prof_ref > 1e-3 * np.nanmax(prof_ref))
    return {
        "correlation": corr,
        "centroid_px": float(np.abs(c_ref - c_img).max()),
        "profile": float(np.max(np.abs(prof_img[ok] / prof_ref[ok] - 1.0))),
        "flux": float(img.sum() / ref.sum() - 1.0),
    }
