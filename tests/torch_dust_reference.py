"""Make tests/torch_dust_reference.npz: the JAX package's dusty_galaxy images.

Run from the root of the repository (a script, not a test; about ten
minutes on an 8-core CPU, where the first seed's run() and run_polarized()
take 52 s and 37 s):

    JAX_PLATFORMS=cpu python tests/torch_dust_reference.py

It builds the configuration of chip_smoke.py's dust phases
(cmacionize_torch/models/dusty_galaxy.py's DUSTY_GALAXY_PARAMS through
cmacionize_torch's dust_config_from_params,
handed field by field to cmacionize_tpu's DustConfig, so both packages run
the same numbers), and runs cmacionize_tpu's DustSimulation on it with
jax_enable_x64 off, as the production CLI runs: run() and run_polarized() at
six seeds.  The file holds, in float32 and compressed:

* ``params``: the parameter dict as JSON, ``seeds``;
* ``image_a``, ``image_b``: the intensity images of the first two seeds;
* ``pol_I_a``: the polarized run's I plane of the first seed;
* ``pol_QI``, ``pol_UI``: the image-integrated Q/I and U/I of every seed,
  ``pol_V``: max |V| / max I of every seed;
* ``measures_intensity``, ``measures_polarized_I``: the first two seeds'
  mutual measures (``cmacionize_torch.models.dusty_galaxy.image_measures``
  of the second seed's image against the first's), in the order of
  ``MEASURES``;
* ``pairs_intensity``, ``pairs_polarized_I``: the same measures for every
  pair of the six seeds ([15, 4]), from whose envelope chip_smoke.py takes
  its thresholds.

chip_smoke.py reads the file with numpy alone.
"""

import dataclasses
import json
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import jax  # noqa: E402

from cmacionize_torch.models.dust_simulation import dust_config_from_params  # noqa: E402
from cmacionize_torch.models.dusty_galaxy import (  # noqa: E402
    DUSTY_GALAXY_PARAMS,
    image_measures,
)
from cmacionize_torch.utils.params import ParameterFile  # noqa: E402
from cmacionize_tpu.models import dust_simulation as jax_dust  # noqa: E402
from cmacionize_tpu.models.grid import GridGeometry  # noqa: E402

DUST_REFERENCE = os.path.join(ROOT, "tests", "torch_dust_reference.npz")
SEEDS = (1, 2, 3, 4, 5, 6)
MEASURES = ("correlation", "centroid_px", "profile", "flux")


def jax_config():
    """The JAX DustConfig of DUSTY_GALAXY_PARAMS, field by field from the
    port's."""
    config = dust_config_from_params(ParameterFile(DUSTY_GALAXY_PARAMS))
    fields = dataclasses.asdict(config)
    geometry = GridGeometry(**fields.pop("geometry"))
    return jax_dust.DustConfig(geometry=geometry, **fields)


def main():
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", False)
    config = jax_config()
    images, polarized = [], []
    for seed in SEEDS:
        images.append(np.asarray(jax_dust.DustSimulation(config, seed=seed).run(), np.float32))
        polarized.append({k: np.asarray(v, np.float32) for k, v in
                          jax_dust.DustSimulation(config, seed=seed).run_polarized().items()})
        print(f"seed {seed}: flux {images[-1].sum():.6g}, polarized I {polarized[-1]['I'].sum():.6g}",
              flush=True)
    pairs = [(i, j) for i in range(len(SEEDS)) for j in range(i + 1, len(SEEDS))]
    pairs_int = np.asarray([[image_measures(images[i], images[j])[k] for k in MEASURES]
                            for i, j in pairs], np.float32)
    pairs_pol = np.asarray([[image_measures(polarized[i]["I"], polarized[j]["I"])[k]
                             for k in MEASURES] for i, j in pairs], np.float32)
    print("seed spread (first pair, then the envelope), intensity:", pairs_int[0],
          pairs_int.min(0), pairs_int.max(0))
    print("polarized I:", pairs_pol[0], pairs_pol.min(0), pairs_pol.max(0))
    np.savez_compressed(
        DUST_REFERENCE,
        params=np.asarray(json.dumps(DUSTY_GALAXY_PARAMS, sort_keys=True)),
        seeds=np.asarray(SEEDS),
        image_a=images[0], image_b=images[1], pol_I_a=polarized[0]["I"],
        pol_QI=np.asarray([p["Q"].sum() / p["I"].sum() for p in polarized], np.float32),
        pol_UI=np.asarray([p["U"].sum() / p["I"].sum() for p in polarized], np.float32),
        pol_V=np.asarray([np.abs(p["V"]).max() / p["I"].max() for p in polarized], np.float32),
        measures_intensity=pairs_int[0], measures_polarized_I=pairs_pol[0],
        pairs_intensity=pairs_int, pairs_polarized_I=pairs_pol,
    )
    print(f"wrote {DUST_REFERENCE} ({os.path.getsize(DUST_REFERENCE)} bytes)")


if __name__ == "__main__":
    main()
