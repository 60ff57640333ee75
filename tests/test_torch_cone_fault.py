"""K10's and K13e's wrappers on the CPU, and the K10 fault of phase 33.

K10 (``kernels/trace_packets_cone.py``) and K13e (``kernels/probe_deposit.py``)
launch through ``kernels/launch.py``: the signature test of
``test_torch_launch.py`` holds their launchers against their sources, and
here importing them builds and binds nothing, CPU tensors run the plain
versions and K13e's checks name what is wrong.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cmacionize_torch import kernels
from cmacionize_torch.kernels import build
from cmacionize_torch.kernels import probe_deposit
from cmacionize_torch.kernels import trace_packets_cone as k10
from cmacionize_torch.tools import experimental_cone_kernel as cone

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))
import experimental_cone_kernel as jax_cone  # noqa: E402


def test_k10_and_k13e_launchers_bind_nothing_at_import():
    assert (k10._LAUNCH.library, k10._LAUNCH.symbol) == ("trace_packets_cone",
                                                          "cmi_trace_packets_cone")
    assert (probe_deposit._DDA_MATH.library, probe_deposit._DDA_MATH.symbol) == (
        "probe_deposit", "cmi_dda_math")
    code = (
        "from cmacionize_torch.kernels import build, probe_deposit, trace_packets_cone\n"
        "from cmacionize_torch.tools import experimental_cone_kernel, probe_deposit as tool\n"
        "assert not build._LIBRARIES\n"
        "assert trace_packets_cone._LAUNCH.function is None\n"
        "assert probe_deposit._DDA_MATH.function is None\n"
    )
    env = {"PATH": "/usr/bin:/bin", "CUDA_HOME": "/nonexistent"}  # no nvcc
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          env=env, cwd=build.CSRC_DIR.parent.parent, check=False)
    assert proc.returncode == 0, proc.stderr


def test_wrapper_constants_match_the_sources():
    cone_source = (build.CSRC_DIR / "trace_packets_cone.cu").read_text()
    assert f"constexpr int kC = {k10.CHUNK};" in cone_source
    assert f"constexpr int kS = {k10.SLAB};" in cone_source
    dda_source = (build.CSRC_DIR / "probe_deposit.cu").read_text()
    assert f"constexpr int kDdaThreads = {probe_deposit.DDA_THREADS};" in dda_source


def test_cpu_tensors_run_the_plain_versions():
    rng = np.random.default_rng(8)
    shape = (8, 8, 8)
    chi = torch.tensor(rng.uniform(0.0, 0.5, shape).astype(np.float32))
    pos = torch.tensor(rng.uniform(0.0, 8.0, (512, 3)).astype(np.float32))
    d = torch.tensor(rng.normal(size=(512, 3)).astype(np.float32))
    d = d / d.norm(dim=1, keepdim=True)
    pf, pi = cone.pack_packets(pos, d, torch.ones(512), torch.ones(512), shape)
    a = torch.tensor(rng.uniform(0.1, 0.9, 64).astype(np.float32))
    kernels.LAUNCHES.clear()
    out = cone.trace_packets_cone(chi, pf, pi, shape=shape)
    ref = cone.trace_packets_cone_reference(chi, pf, pi, shape=shape)
    assert all(torch.equal(x, y) for x, y in zip(out, ref))
    assert torch.equal(probe_deposit.dda_math(a, a * 0.5, 20),
                       probe_deposit.dda_math_reference(a, a * 0.5, 20))
    assert kernels.LAUNCHES["trace_packets_cone"] == kernels.LAUNCHES["dda_math"] == 0
    assert k10._LAUNCH.function is None and probe_deposit._DDA_MATH.function is None


def test_k10_check_refuses_tensors_off_the_card():
    t = torch.zeros((8, 8, 8))
    pf, pi = torch.zeros((512, 8)), torch.zeros((512, 8), dtype=torch.int32)
    with pytest.raises(ValueError, match="needs CUDA tensors, got cpu"):
        k10.trace_packets_cone_cuda(t, t.clone(), pf, pi, shape=(8, 8, 8), slab=8, chunk=512,
                                    max_phases=8)


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_k13e_check_refuses_tensors_off_the_card(device):
    a = torch.empty(1024, device=device)
    with pytest.raises(ValueError, match="dda_math: a must be a 1D torch.float32 tensor on a "
                                         f"CUDA device; got 1D torch.float32 on {device}"):
        probe_deposit.check_dda_math(a, a, 7808)


@pytest.mark.parametrize("shapes, nstep, message", [
    (((8, 128), (1024,)), 10, "a and b must have one shape"),
    (((2**31,), (2**31,)), 10, "sizes must fit int32"),
    (((1024,), (1024,)), -1, "nstep must lie in"),
    (((1024,), (1024,)), 2**31 - 128, "nstep must lie in"),
])
def test_k13e_check_refuses_shapes_and_steps(monkeypatch, shapes, nstep, message):
    monkeypatch.setattr(probe_deposit, "check_pair", lambda *args: 0)
    a, b = (torch.empty(s, device="meta") for s in shapes)
    with pytest.raises(ValueError, match=message):
        probe_deposit.check_dda_math(a, b, nstep)


@pytest.mark.parametrize("shape", [(8, 128), (1,), (2**31 - 1,)])
def test_k13e_check_gives_the_launch_device(monkeypatch, shape):
    monkeypatch.setattr(probe_deposit, "check_pair", lambda *args: 3)
    a = torch.empty(shape, device="meta")
    assert probe_deposit.check_dda_math(a, a, 7808) == (3,)


# -- phase 33's lane checks ------------------------------------------------------------------

DIAGONAL = 8 * 3**0.5


def _verdict_lanes():
    """Seven lanes along +x, each a case of phase 33's checks: K10's point
    and state, the plain version's point and state, and its records (the
    lane unplaced, the cells that held its tau_left, the first one's point)."""
    cases = [  # (k10 x, k10 state, plain x, plain state, unplaced, hits, first hit x)
        (12.25, 1, 12.25 + 5e-5, 1, False, 1, 0.0),  # placed, within 1e-4: passes
        (12.25, 1, 12.25 + 2e-4, 1, False, 1, 0.0),  # placed, 2e-4 apart: refused
        (16.0, 1, 10.5, 1, True, 0, 0.0),            # no cell held it, K10 5.5 ahead: passes
        (10.0, 1, 10.5, 1, True, 0, 0.0),            # no cell held it, K10 behind: refused
        (16.0, 1, 19.0, 1, True, 2, 16.0 + 5e-5),    # two cells, K10 at the first: passes
        (16.0, 1, 19.0, 1, True, 2, 17.0),           # two cells, K10 elsewhere: refused
        (16.0, 1, 15.0 - DIAGONAL, 1, True, 0, 0.0),  # more than a diagonal ahead: refused
    ]
    n = len(cases)
    pf_k, pf_r = torch.zeros((n, 8)), torch.zeros((n, 8))
    pi_k, pi_r = torch.zeros((n, 8), dtype=torch.int32), torch.zeros((n, 8), dtype=torch.int32)
    stats = {"unplaced": torch.zeros(n, dtype=torch.bool),
             "hits": torch.zeros(n, dtype=torch.int64), "first_hit": torch.zeros((n, 3))}
    for i, (xk, sk, xr, sr, unplaced, hits, first) in enumerate(cases):
        for pf, x in ((pf_k, xk), (pf_r, xr)):
            pf[i, :3] = torch.tensor([x, 4.5, 4.5])
            pf[i, 3] = 1.0
        pi_k[i, 3], pi_r[i, 3] = sk, sr
        stats["unplaced"][i], stats["hits"][i] = unplaced, hits
        stats["first_hit"][i] = torch.tensor([first, 4.5, 4.5])
    return (None, pf_k, pi_k), (None, pf_r, pi_r), stats


def test_lane_verdicts_hold_each_kind_of_lane():
    out_k, out_r, stats = _verdict_lanes()
    v = cone.lane_verdicts(out_k, out_r, stats, position_tol=1e-4, diagonal=DIAGONAL)
    assert v["refused"] == [1, 3, 5, 6]
    assert v["ahead"] == [5.5] and v["several"] == [-3.0, -3.0]
    assert v["unplaced"] == 5 and v["state_mismatch"] == 0
    assert v["pos_diff"] == pytest.approx(2e-4, rel=1e-2)


def test_lane_verdicts_refuse_a_point_off_the_ray():
    out_k, out_r, stats = _verdict_lanes()
    out_k[1][2, 1] += 1e-3  # the lane ahead, 1e-3 off its ray
    v = cone.lane_verdicts(out_k, out_r, stats, position_tol=1e-4, diagonal=DIAGONAL)
    assert v["refused"] == [1, 2, 3, 5, 6]


# -- the saved fault -------------------------------------------------------------------------

FAULT = os.path.join(os.path.dirname(__file__), "torch_cone_fault.npz")
# the two lanes that phase 33's check refused before it held several-hit
# lanes to their first cell: the phase and
# slab corner where every version absorbs each, and the number of cells that
# held its tau_left in torch's prefix scans (CPU and card) and in XLA's
# (the Pallas kernel in interpret mode)
FAULT_LANES = {136675: (3, (18, 32, 56), 2, 2), 867625: (2, (48, 19, 23), 2, 1)}


def _fault_chunk(saved, lane):
    k = list(saved["chunks"]).index(lane // 512)
    rows = slice(k * 512, (k + 1) * 512)
    return {key: saved[key][rows] for key in ("pf", "pi", "pf_k", "pi_k", "pf_r", "pi_r")}


def test_saved_fault_lanes_replay_three_ways():
    """The saved input (phase 32's final χ from a card run, the chunks of the
    two lanes that phase 33's check refused, drawn from parity seed 1242, and
    the card's K10 and plain outputs; ``cmacionize_torch/tools/turns.py
    k10-hunt``).  Every version absorbs each lane in the same phase and
    slab.  Where torch's prefix scans let two cells hold tau_left, the plain
    version (on the CPU and, as saved, on the card) adds both cells' times and
    leaves the lane beyond both; K10, which absorbs in the first cell its
    travel-order sum passes, sits exactly at the point that the first of
    them gives; the Pallas kernel in interpret mode does as torch does where
    XLA's scans hold two cells too, and places the lane at K10's point where
    they hold one."""
    saved = np.load(FAULT)
    chi = torch.tensor(saved["chi"])
    shape = tuple(chi.shape)
    assert sorted(int(x) for x in saved["lanes"]) == sorted(FAULT_LANES)
    for lane, (phase, corner, torch_hits, xla_hits) in FAULT_LANES.items():
        part = _fault_chunk(saved, lane)
        i = lane % 512
        stats = {}
        _, pf_r, pi_r = cone.trace_packets_cone_reference(
            chi, torch.tensor(part["pf"]), torch.tensor(part["pi"]), shape=shape, stats=stats,
            trace_lanes=[i])
        rows = stats["trace"][i]
        absorbing = [row for row in rows if row["absorbed"]]
        assert [(row["phase"], row["corner"], row["hits"]) for row in absorbing] == [
            (phase, corner, torch_hits)]
        # the two cells' prefix-scan intervals overlap at tau_left
        row = absorbing[0]
        entries = np.float32(row["cum"]) - np.float32(row["chiell"])
        tau = np.float32(row["tau"])
        held = (entries <= tau) & (tau < np.float32(row["cum"]))
        assert int(held.sum()) == torch_hits
        # the plain version as saved from the card, and K10 at the first hit
        np.testing.assert_array_equal(pf_r[i].numpy(), part["pf_r"][i])
        np.testing.assert_array_equal(pi_r[i].numpy(), part["pi_r"][i])
        np.testing.assert_array_equal(stats["first_hit"][i].numpy(), part["pf_k"][i, :3])
        assert part["pi_k"][i, 3] == 1 and bool(stats["unplaced"][i])
        # the Pallas kernel: still in flight after `phase` phases, absorbed in the next
        with jax.enable_x64(False):
            outs = [jax_cone.trace_packets_cone(
                jnp.asarray(saved["chi"]), jnp.asarray(part["pf"]), jnp.asarray(part["pi"]),
                shape=shape, max_phases=n, interpret=True) for n in (phase, phase + 1)]
        (_, _, before), (_, pf_j, after) = outs
        assert int(np.asarray(before)[i, 3]) == 0 and int(np.asarray(after)[i, 3]) == 1
        expected = part["pf_r"][i, :3] if xla_hits > 1 else part["pf_k"][i, :3]
        np.testing.assert_array_equal(np.asarray(pf_j)[i, :3], expected)


def test_saved_fault_lanes_pass_the_repaired_check():
    """With the card's K10 outputs as saved and the plain version replayed on
    the CPU, phase 33's lane checks refuse no lane of the two chunks; the two
    lanes count as several-hit lanes at their first hit's point."""
    saved = np.load(FAULT)
    chi = torch.tensor(saved["chi"])
    for lane in FAULT_LANES:
        part = _fault_chunk(saved, lane)
        stats = {}
        out_r = cone.trace_packets_cone_reference(chi, torch.tensor(part["pf"]),
                                                  torch.tensor(part["pi"]), shape=tuple(chi.shape),
                                                  stats=stats)
        out_k = (None, torch.tensor(part["pf_k"]), torch.tensor(part["pi_k"]))
        v = cone.lane_verdicts(out_k, out_r, stats, position_tol=1e-4, diagonal=DIAGONAL)
        assert v["refused"] == [] and len(v["several"]) == 1 and v["several"][0] < -1.0
        assert v["pos_diff"] <= 1e-4
