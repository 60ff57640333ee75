"""cmacionize_torch parameter reader against the JAX package's, and the
port's import isolation.

The port reads parameter files with its own YAML-subset parser (no PyYAML);
on every benchmark file it must build the same tree as PyYAML's safe_load and
the same configurations as the JAX package's ``from_params``.
"""

import dataclasses
import glob
import os
import subprocess
import sys
import textwrap

import pytest
import yaml

from cmacionize_torch.models.grid import GridGeometry
from cmacionize_torch.models.ionization_simulation import HOnlyConfig
from cmacionize_torch.utils.params import ParameterFile, parse_yaml_subset
from cmacionize_tpu.models.grid import GridGeometry as JaxGridGeometry
from cmacionize_tpu.models.ionization_simulation import HOnlyConfig as JaxHOnlyConfig
from cmacionize_tpu.utils.params import ParameterFile as JaxParameterFile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PARAM_FILES = sorted(glob.glob(os.path.join(ROOT, "benchmarks", "*.param")))
BLOCK_FILES = sorted(glob.glob(os.path.join(ROOT, "benchmarks", "*.yml")))


def _ids(paths):
    return [os.path.basename(p) for p in paths]


def test_benchmark_files_found():
    names = _ids(PARAM_FILES)
    assert "stromgren.param" in names and len(names) >= 6


@pytest.mark.parametrize("path", PARAM_FILES + BLOCK_FILES, ids=_ids(PARAM_FILES + BLOCK_FILES))
def test_tree_matches_pyyaml(path):
    with open(path) as handle:
        text = handle.read()
    assert parse_yaml_subset(text) == yaml.safe_load(text)


@pytest.mark.parametrize("path", PARAM_FILES, ids=_ids(PARAM_FILES))
def test_from_params_matches_jax(path):
    port, ref = ParameterFile(path), JaxParameterFile(path)
    assert dataclasses.astuple(GridGeometry.from_params(port)) == dataclasses.astuple(
        JaxGridGeometry.from_params(ref)
    )
    config, jax_config = HOnlyConfig.from_params(port), JaxHOnlyConfig.from_params(ref)
    assert dataclasses.astuple(config) == dataclasses.astuple(jax_config)
    assert isinstance(config.n_photons, int) and isinstance(config.geometry.shape[0], int)


SCALAR_DOCS = {
    "sci_without_dot": "a: 1e6",  # YAML 1.1: a string, coerced on get_int
    "sci_signed": "a: 6.3e-18",
    "sci_dot_unsigned": "a: 1.e49",
    "float_dot": "a: 1.",
    "int": "a: -42",
    "bools": "a: [true, False, yes, off, On]",
    "null": "a: ~\nb: null\nc:",
    "quoted": "a: 'it''s # not a comment'\nb: \"x: y\"",
    "unit_list": "a: [-5. pc, 1.e+49 Hz, 0 m]",
    "comments": "# head\na: 3 # tail\nb: x#y\n  # indented comment\n",
    "nesting": "A:\n  B:\n    c: 1\n  d: [1, 2]\ne: f\n",
    "empty_list": "a: []",
    "keys_with_spaces": "Box:\n  number of cells: [64, 64, 64]\n",
    "special_floats": "a: [.inf, -.inf]",
    "block_sequence": "positions:\n  - ['0. pc', '1. pc']\n  - [2, 3]\nb:\n- x\n- 4.\n",
}


@pytest.mark.parametrize("text", SCALAR_DOCS.values(), ids=SCALAR_DOCS.keys())
def test_scalar_resolution_matches_pyyaml(text):
    assert parse_yaml_subset(text) == yaml.safe_load(text)


@pytest.mark.parametrize(
    "text",
    ["- a\n- b", "a: &x 1", "a: |\n  text", "a: {b: 1}", "a: 010", "a: [[1], 2]",
     "a:\n  b: 1\n c: 2", "a: 1\na: 2", "\ta: 1", "a:\n  - b: 1"],
    ids=["block_seq", "anchor", "literal", "flow_map", "octal", "nested_list",
         "bad_indent", "duplicate", "tab", "sequence_of_mappings"],
)
def test_unsupported_yaml_raises(text):
    with pytest.raises(ValueError):
        parse_yaml_subset(text)


def test_typed_getters_coerce_like_jax():
    tree = parse_yaml_subset(
        "S:\n  n: 1e6\n  b: [true, false, true]\n  v: [-5. pc, 0. pc, 5. pc]\n  q: 100. cm^-3\n"
    )
    port, ref = ParameterFile(tree), JaxParameterFile(yaml.safe_load(
        "S:\n  n: 1e6\n  b: [true, false, true]\n  v: [-5. pc, 0. pc, 5. pc]\n  q: 100. cm^-3\n"
    ))
    for getter, args in [
        ("get_int", ("S:n",)),
        ("get_bool_vector", ("S:b",)),
        ("get_physical_vector", ("S:v", "length")),
        ("get_physical_value", ("S:q", "number density")),
        ("get_int", ("S:missing", 7)),
        ("get_value", ("S:q",)),
    ]:
        assert getattr(port, getter)(*args) == getattr(ref, getter)(*args), getter
    with pytest.raises(KeyError):
        port.get_value("S:missing")
    with pytest.raises(KeyError):
        port.get_value("S:n:deeper")


def test_new_getters_match_jax():
    text = "S:\n  s: HLLC\n  n: 1.0001\n  b: true\n  y: yes\n  f: [a, b]\n"
    port, ref = ParameterFile(parse_yaml_subset(text)), JaxParameterFile(yaml.safe_load(text))
    for path in ("S:s", "S:n", "S:b", "S:y", "S:f", "S:missing", "S", "S:s:deeper"):
        assert port.has_value(path) == ref.has_value(path), path
    for getter, args in [
        ("get_string", ("S:s",)),
        ("get_string", ("S:n",)),
        ("get_string", ("S:missing", "reflective")),
        ("get_bool", ("S:b",)),
        ("get_bool", ("S:y",)),
        ("get_bool", ("S:missing", False)),
        ("get_bool", ("S:missing", "on")),
    ]:
        assert getattr(port, getter)(*args) == getattr(ref, getter)(*args), (getter, args)
    with pytest.raises(ValueError):
        port.get_bool("S:s")
    with pytest.raises(KeyError):
        port.get_string("S:missing")


def test_import_leaves_jax_out():
    # the port never imports JAX or the JAX package, even where
    # JAX_PLATFORMS is set (cmacionize_tpu/__init__.py imports jax then)
    code = textwrap.dedent(
        """
        import sys
        import cmacionize_torch
        import cmacionize_torch.device
        import cmacionize_torch.kernels.build
        import cmacionize_torch.models.ionization_simulation
        import cmacionize_torch.models.rhd_simulation
        import cmacionize_torch.kernels.hydro_step
        import cmacionize_torch.utils.params
        import cmacionize_torch.data
        import cmacionize_torch.models.multifreq_simulation
        import cmacionize_torch.models.reemission
        import cmacionize_torch.ops.temperature
        import cmacionize_torch.ops.line_cooling
        import cmacionize_torch.kernels.temperature
        import cmacionize_torch.kernels.trace_packets_spectral
        import cmacionize_torch.models.voronoi
        import cmacionize_torch.models.voronoi_hydro
        import cmacionize_torch.kernels.trace_voronoi
        import cmacionize_torch.kernels.trace_packets
        import cmacionize_torch.kernels.trace_voronoi_spectral
        import cmacionize_torch.kernels.voronoi_flux
        import cmacionize_torch.models.amr
        import cmacionize_torch.ops.amr_traversal
        import cmacionize_torch.kernels.trace_octree
        import cmacionize_torch.kernels.trace_octree_spectral
        import cmacionize_torch.kernels.leaf_of_positions
        import cmacionize_torch.ops.polarization
        import cmacionize_torch.models.dust_simulation
        import cmacionize_torch.models.dusty_galaxy
        import cmacionize_torch.ops.peel_off
        import cmacionize_torch.kernels.peel_off
        import cmacionize_torch.kernels.peel_off_polarized
        import cmacionize_torch.models.atmosphere_spectra
        import cmacionize_torch.models.trackers
        import cmacionize_torch.utils.diagnostics
        import cmacionize_torch.parallel.mesh
        import cmacionize_torch.parallel.domain
        import cmacionize_torch.parallel.domain3d
        import cmacionize_torch.parallel.drivers
        import cmacionize_torch.kernels.compact
        import cmacionize_torch.tools.experimental_emission_octa
        import cmacionize_torch.tools.experimental_cone_kernel
        import cmacionize_torch.tools.microbench_scatter
        import cmacionize_torch.kernels.trace_packets_cone
        import cmacionize_torch.kernels.gather
        import cmacionize_torch.kernels.probe_gather
        import cmacionize_torch.tools.probe_pallas_gather
        import cmacionize_torch.kernels.probe_deposit
        import cmacionize_torch.kernels.probe_cohort
        import cmacionize_torch.tools.probe_deposit
        import cmacionize_torch.tools.probe_deposit2
        import cmacionize_torch.tools.probe_cohort_kernel
        import cmacionize_torch.kernels.launch
        import cmacionize_torch.tools.launch_cost
        # the atomic tables are read by path, not through cmacionize_tpu.data
        import torch
        cmacionize_torch.data.load("verner_photo.npz")
        one = torch.ones(1, dtype=torch.float64)
        cmacionize_torch.ops.line_cooling.five_level_populations(8000.0 * one, 1e8 * one)
        cmacionize_torch.ops.line_cooling.five_level_populations(
            8000.0 * one.float(), 1e8 * one.float())
        cmacionize_torch.ops.temperature.solve_temperature_device(
            8000.0 * one, {name: 1e-8 * one for name in cmacionize_torch.models.ions.ION_NAMES},
            (1e-26 * one, 1e-26 * one), 1e8 * one, {"He": 0.1, "C": 2.2e-4, "N": 4e-5,
                                                    "O": 3.3e-4, "Ne": 5e-5, "S": 9e-6})
        bad = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "jaxlib", "cmacionize_tpu"))
        assert not bad, bad
        print("ok")
        """
    )
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=ROOT)
    proc = subprocess.run(
        [sys.executable, "-c", code], env=env, cwd=ROOT,
        capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"
