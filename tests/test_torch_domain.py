"""The port's domain decomposition (cmacionize_torch/parallel/) against the
JAX package's (cmacionize_tpu/parallel/), on conftest's 8 virtual CPU
devices and a LocalMesh of 8 CPU shards.

K9c (compact) and the exchange are pure data movement plus one f32 add, so
they must equal JAX's bit for bit in every lane.  The hydro halo exchange
must leave the port's step bit for bit its single-device step, which in turn
agrees with JAX's to f32 round-off.  The slab march of given packets must
give the single-device march's tally and counts.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import PartitionSpec as P

from cmacionize_torch.kernels.compact import compact_cuda, partition_cuda
from cmacionize_torch.ops import hydro, traversal
from cmacionize_torch.parallel import domain, domain3d
from cmacionize_torch.parallel.mesh import LocalMesh
from cmacionize_tpu.ops import hydro as jax_hydro
from cmacionize_tpu.parallel import domain as jax_domain
from cmacionize_tpu.parallel import domain3d as jax_domain3d
from cmacionize_tpu.parallel.mesh import make_mesh

CPU = [torch.device("cpu")]
N_SHARDS = 8


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def flush_denormals():
    """XLA runs its CPU programs with subnormals flushed to zero; the hydro
    comparisons flush in torch too (tests/test_torch_rhd.py)."""
    if not torch.set_flush_denormal(True):
        pytest.skip("this CPU cannot flush subnormals")
    yield
    torch.set_flush_denormal(False)


def _bits(a):
    a = np.asarray(a)
    return a.view(np.int32) if a.dtype == np.float32 else a


def _fields(rng, n):
    fields = [rng.standard_normal(n).astype(np.float32) for _ in range(8)]
    fields[0][: n // 10] = -0.0  # signed zeros travel as they are
    return fields


# ------------------------------------------------------------------ LocalMesh


def test_local_mesh_shard_unshard_and_collectives():
    mesh = LocalMesh((2, 2, 2), domain3d.AXES, CPU)
    a = torch.arange(4 * 6 * 8, dtype=torch.float32).reshape(4, 6, 8)
    blocks = mesh.shard(a, domain3d.AXES)
    assert [tuple(b.shape) for b in blocks] == [(2, 3, 4)] * 8
    assert torch.equal(mesh.unshard(blocks, domain3d.AXES), a)
    assert mesh.axis_index("dy") == [0, 0, 1, 1, 0, 0, 1, 1]
    values = [torch.tensor(float(i)) for i in range(8)]
    # psum over dx pairs shards i and i + 4; over all it is the total
    assert [float(v) for v in mesh.psum(values, "dx")] == [4.0, 6.0, 8.0, 10.0] * 2
    assert [float(v) for v in mesh.psum(values)] == [28.0] * 8
    assert [float(v) for v in mesh.pmin(values, ("dy", "dz"))] == [0.0] * 4 + [4.0] * 4
    # the shard at coordinate c receives from c - shift, circularly
    assert [float(v) for v in mesh.ppermute(values, "dz", 1)] == [1, 0, 3, 2, 5, 4, 7, 6]
    assert [float(v) for v in mesh.ppermute(values, "dx", -1)] == [4, 5, 6, 7, 0, 1, 2, 3]
    sums = mesh.psum(values)
    sums[1] += 1.0  # every member owns its result
    assert float(sums[0]) == 28.0


def test_local_mesh_places_shards_round_robin():
    mesh = LocalMesh((4,), ("x",), [torch.device("cpu"), torch.device("meta")])
    assert [d.type for d in mesh.devices] == ["cpu", "meta", "cpu", "meta"]
    with pytest.raises(ValueError):
        LocalMesh((2, 2), ("x",), CPU)


# -------------------------------------------------------------- K9c and K9p


@pytest.mark.parametrize("capacity", [300, 1000, 1777])
@pytest.mark.parametrize("share", [0.0, 0.35, 1.0])
def test_compact_equals_jax_bit_for_bit(capacity, share):
    rng = np.random.default_rng(7)
    n = 1000
    fields = _fields(rng, n)
    mask = rng.uniform(size=n) < share
    ref, ref_range, ref_over = jax_domain._compact(
        tuple(jnp.asarray(f) for f in fields), jnp.asarray(mask), capacity)
    out, in_range, over = domain.compact(
        tuple(torch.from_numpy(f) for f in fields), torch.from_numpy(mask), capacity)
    for a, b in zip(ref, out):
        np.testing.assert_array_equal(_bits(a), _bits(b.numpy()))
    np.testing.assert_array_equal(np.asarray(ref_range), in_range.numpy())
    assert int(ref_over) == int(over) == max(int(mask.sum()) - capacity, 0)


def test_partition_is_two_jax_compacts_with_the_frame_shift():
    rng = np.random.default_rng(8)
    n = 2000
    fields = _fields(rng, n)
    bucket = rng.integers(-1, 2, n).astype(np.int8)
    capacities, shifts = (400, 900), (16.0, -16.0)
    out = domain.partition(tuple(torch.from_numpy(f) for f in fields),
                           torch.from_numpy(bucket), capacities, shifts)
    for b, (capacity, shift) in enumerate(zip(capacities, shifts)):
        ref, ref_range, ref_over = jax_domain._compact(
            tuple(jnp.asarray(f) for f in fields), jnp.asarray(bucket == b), capacity)
        ref = (ref[0] + 16 * (1 - 2 * b),) + ref[1:]  # domain.py:246-247
        got, in_range, over = out[b]
        for a, c in zip(ref, got):
            np.testing.assert_array_equal(_bits(a), _bits(c.numpy()))
        np.testing.assert_array_equal(np.asarray(ref_range), in_range.numpy())
        assert int(ref_over) == int(over)
    # without a shift, field 0 travels untouched (no +0.0 on a -0.0)
    (plain, _, _), _ = domain.partition(
        tuple(torch.from_numpy(f) for f in fields), torch.from_numpy(bucket), (n, n))
    ref, _, _ = jax_domain._compact(
        tuple(jnp.asarray(f) for f in fields), jnp.asarray(bucket == 0), n)
    np.testing.assert_array_equal(_bits(ref[0]), _bits(plain[0].numpy()))


def test_cpu_tensors_take_the_plain_versions_and_the_kernels_refuse_them():
    fields = (torch.arange(5, dtype=torch.float32),)
    mask = torch.tensor([False, True, False, True, True])
    (out,), in_range, over = domain.compact(fields, mask, 4)
    assert out.tolist() == [1.0, 3.0, 4.0, 0.0]
    assert in_range.tolist() == [True, True, True, False] and int(over) == 0
    with pytest.raises(ValueError, match="CUDA"):
        compact_cuda(fields, mask, 4)
    with pytest.raises(ValueError, match="CUDA"):
        partition_cuda(fields, torch.zeros(5, dtype=torch.int8), (2, 2))


@pytest.mark.parametrize("capacity", [60, 4096])
def test_exchange_axis_equals_jax_bit_for_bit(capacity):
    rng = np.random.default_rng(9)
    n = 512
    fields = _fields(rng, N_SHARDS * n)
    mask = rng.uniform(size=N_SHARDS * n) < 0.4
    target = rng.integers(0, N_SHARDS, N_SHARDS * n).astype(np.int32)

    def device_exchange(*args):
        my = jax.lax.axis_index("x")
        out, out_mask, over = jax_domain3d._exchange_axis(
            tuple(args[:8]), args[8], args[9], my, N_SHARDS, "x", capacity)
        return (*out, out_mask, over.reshape(1))

    mesh = make_mesh(N_SHARDS, axis_names=("x",))
    ref = jax.jit(shard_map(device_exchange, mesh=mesh, in_specs=(P("x"),) * 10,
                            out_specs=(P("x"),) * 10, check_vma=False))(
        *(jnp.asarray(f) for f in fields), jnp.asarray(mask), jnp.asarray(target))

    local = LocalMesh((N_SHARDS,), ("x",), CPU)

    def cut(a):
        return [torch.from_numpy(a[i * n:(i + 1) * n]) for i in range(N_SHARDS)]

    per_field = [cut(f) for f in fields]
    out, out_mask, over = domain3d._exchange_axis(
        local, [tuple(f[i] for f in per_field) for i in range(N_SHARDS)],
        cut(mask), cut(target), "x", capacity)
    for k in range(8):
        got = np.concatenate([out[i][k].numpy() for i in range(N_SHARDS)])
        np.testing.assert_array_equal(_bits(ref[k]), _bits(got))
    np.testing.assert_array_equal(np.asarray(ref[8]), torch.cat(out_mask).numpy())
    np.testing.assert_array_equal(np.asarray(ref[9]), [int(o) for o in over])
    if capacity == 60:
        assert int(np.asarray(ref[9]).sum()) > 0  # the small buffers overflowed


# ------------------------------------------------------------------- hydro


def _hydro_state(seed, shape, periodic_flow=False):
    rng = np.random.default_rng(seed)
    rho = 1.0 + rng.uniform(size=shape)
    if periodic_flow:
        v = np.zeros(shape + (3,))
        v[..., 0] = 0.5
        p = np.ones(shape)
    else:
        v = 0.3 * rng.standard_normal(shape + (3,))
        p = 0.5 + rng.uniform(size=shape)
    w = [np.asarray(a, np.float32) for a in (rho, v[..., 0], v[..., 1], v[..., 2], p)]
    u_jax = jax_hydro.conserved_from_primitives(jax_hydro.Primitives(*map(jnp.asarray, w)))
    u_port = hydro.conserved_from_primitives(hydro.Primitives(*map(torch.from_numpy, w)))
    return u_jax, u_port


def _sharded_hydro(boundaries, shape, dt, seed, periodic_flow=False):
    mesh = make_mesh(N_SHARDS, axis_names=("x",))
    u_jax, u_port = _hydro_state(seed, shape, periodic_flow)
    step, sharding = jax_domain.make_domain_hydro_step(
        mesh, boundaries=boundaries, cell_size=(1.0, 1.0, 1.0))
    u_jax_sharded = jax.tree.map(lambda f: jax.device_put(f, sharding), u_jax)
    ref = step(u_jax_sharded, dt)

    local = LocalMesh((N_SHARDS,), ("x",), CPU)
    shards = [hydro.HydroState(*parts)
              for parts in zip(*(local.shard(f, ("x",)) for f in u_port))]
    out = domain.make_domain_hydro_step(
        local, boundaries=boundaries, cell_size=(1.0, 1.0, 1.0))(shards, dt)
    got = hydro.HydroState(*(local.unshard([u[k] for u in out], ("x",)) for k in range(5)))
    single = hydro.hydro_step(u_port, dt, boundaries=boundaries, cell_size=(1.0, 1.0, 1.0))
    return mesh, local, u_jax_sharded, shards, ref, got, single


def _assert_hydro_close(ref, got, single):
    for name, a, b, c in zip(got._fields, ref, got, single):
        # the halo exchange changes nothing: the single-device step's bits
        np.testing.assert_array_equal(b.numpy(), c.numpy(), err_msg=name)
        # against JAX: rtol 1e-6 with atol 1e-6 x the field's largest value
        # (the single-device steps differ by f32 round-off, up to 1.6e-7 of
        # a field's largest value where an XLA-fused flux term cancels; an
        # elementwise atol of 1e-8 fails one near-zero element of 2048)
        a = np.asarray(a)
        np.testing.assert_allclose(b.numpy(), a, rtol=1e-6,
                                   atol=1e-6 * np.abs(a).max(), err_msg=name)


def test_domain_hydro_step_and_cfl_match_jax(flush_denormals):
    boundaries = (
        (hydro.BC_REFLECTIVE, hydro.BC_OUTFLOW),
        (hydro.BC_PERIODIC, hydro.BC_PERIODIC),
        (hydro.BC_REFLECTIVE, hydro.BC_REFLECTIVE),
    )
    mesh, local, u_jax_sharded, shards, ref, got, single = _sharded_hydro(
        boundaries, (32, 8, 8), 0.05, 11)
    _assert_hydro_close(ref, got, single)
    dt_ref = float(jax_domain.domain_cfl_timestep(mesh, cell_size=(1.0,) * 3)(u_jax_sharded))
    dt = float(domain.domain_cfl_timestep(local, cell_size=(1.0,) * 3)(shards))
    assert dt == pytest.approx(dt_ref, rel=1e-6)


def test_domain_hydro_periodic_x_wraps_like_the_single_device_step(flush_denormals):
    boundaries = ((hydro.BC_PERIODIC, hydro.BC_PERIODIC),) * 3
    _, _, _, _, ref, got, single = _sharded_hydro(
        boundaries, (16, 4, 4), 0.04, 5, periodic_flow=True)
    _assert_hydro_close(ref, got, single)


# ------------------------------------------------------------------ photons


def _march_case(shape, source, n, seed):
    rng = np.random.default_rng(seed)
    x = np.indices(shape)[0]
    chi = np.where(x < 20, rng.uniform(0.01, 0.2, shape),
                   rng.uniform(0.1, 1.0, shape)).astype(np.float32)
    cos_t = rng.uniform(-1.0, 1.0, n)
    phi = rng.uniform(0.0, 2.0 * np.pi, n)
    sin_t = np.sqrt(1.0 - cos_t**2)
    direction = np.stack([sin_t * np.cos(phi), sin_t * np.sin(phi), cos_t], 1)
    tau = -np.log1p(-rng.uniform(size=n))
    return chi, direction, tau


@pytest.mark.parametrize("source", [(6.0, 8.0, 8.0), (16.0, 7.5, 8.25)])
def test_slab_march_of_given_packets_equals_the_single_device_march(source):
    shape, n = (32, 16, 16), 2**14
    chi, direction, tau = _march_case(shape, source, n, 3)
    position = np.asarray(source)[None, :] + 1e-4 * direction

    def t32(a):
        return torch.tensor(np.asarray(a, np.float32))

    packets = traversal.make_packets(t32(position), t32(direction), t32(tau),
                                     torch.ones(n), shape)
    ref_tally, ref_out = traversal.trace_packets(
        torch.from_numpy(chi.reshape(-1)), packets, torch.zeros(chi.size), shape=shape)
    n_absorbed = int(ref_out.absorbed.sum())

    local = LocalMesh((N_SHARDS,), ("x",), CPU)
    nx_loc = shape[0] // N_SHARDS
    src_dev = min(int(source[0]) // nx_loc, N_SHARDS - 1)
    w0 = min(max(src_dev - 1, 0), N_SHARDS - 3)
    n_loc = n // N_SHARDS

    def emit(i, count, window_position):
        # shard i launches its slice of the given packets, in the window frame
        part = slice(i * count, (i + 1) * count)
        p = position[part] - [w0 * nx_loc, 0.0, 0.0]
        return (*(t32(p[:, a]) for a in range(3)), *(t32(direction[part, a]) for a in range(3)),
                t32(tau[part]), torch.ones(count))

    chis = [c.reshape(-1) for c in local.shard(torch.from_numpy(chi), ("x",))]
    tallies, stats = domain._device_slab_mc_loop(
        local, chis, emit, axis="x", nx_loc=nx_loc, ny=shape[1], nz=shape[2],
        n_photons=n, source_gpos=source, capacity=domain.default_capacity(n),
        max_supersteps=256)
    assert n_loc * N_SHARDS == n
    tally = local.unshard([t.reshape(nx_loc, *shape[1:]) for t in tallies], ("x",)).reshape(-1)
    rel_l1 = float((tally - ref_tally).abs().sum() / ref_tally.abs().sum())
    assert rel_l1 <= 1e-5, rel_l1
    escaped = sum(int(e) for e in stats["n_escaped"])
    assert sum(int(o) for o in stats["buffer_overflow"]) == 0
    assert sum(int(t) for t in stats["truncated_live"]) == 0
    assert abs(escaped - (n - n_absorbed)) <= 1e-5 * n
    assert stats["supersteps"] > 1  # packets hopped across several slabs


def _transparent(shape, n_photons, source):
    return dict(global_shape=shape, n_photons=n_photons, sigma_dx=1e-30,
                source_gpos=source, jfac_scale=1.0, alpha=4e-19)


def _uniform(mesh, shape, spec, value):
    return mesh.shard(torch.full(shape, value, dtype=torch.float32), spec)


def test_slab_iteration_conserves_packets_in_a_transparent_medium():
    # every packet escapes; none is lost in the exchange
    shape, n_photons = (32, 8, 8), 4096
    local = LocalMesh((N_SHARDS,), ("x",), CPU)
    step = domain.make_domain_mc_iteration(local, **_transparent(shape, n_photons, (16.0, 4.0, 4.0)))
    generators = [torch.Generator().manual_seed(i) for i in range(N_SHARDS)]
    _, _, diag = step(domain.emit_from(generators), _uniform(local, shape, ("x",), 1e-6),
                      _uniform(local, shape, ("x",), 1e8))
    assert int(diag["n_escaped"]) == n_photons
    assert int(diag["buffer_overflow"]) == 0
    assert int(diag["truncated_live"]) == 0
    assert diag["supersteps"] >= 2  # the window's survivors cross the outer slabs


def test_3d_iteration_conserves_packets_in_a_transparent_medium():
    shape, n_photons = (16, 16, 16), 4096
    mesh = domain3d.make_mesh_3d((2, 2, 2), CPU)
    step = domain3d.make_domain_mc_iteration_3d(mesh, **_transparent(shape, n_photons, (8.0,) * 3))
    generators = [torch.Generator().manual_seed(i) for i in range(N_SHARDS)]
    _, _, diag = step(domain.emit_from(generators), _uniform(mesh, shape, domain3d.AXES, 1e-6),
                      _uniform(mesh, shape, domain3d.AXES, 1e8))
    assert int(diag["n_escaped"]) == (n_photons // 8) * 8
    assert int(diag["buffer_overflow"]) == 0
    assert int(diag["truncated_live"]) == 0


def test_make_domain_rhd_step_raises_for_what_it_does_not_carry():
    local = LocalMesh((4,), ("x",), CPU)
    kwargs = dict(global_shape=(16, 8, 8), boundaries=((hydro.BC_REFLECTIVE,) * 2,) * 3,
                  cell_size=(1.0,) * 3, gamma=5.0 / 3.0, n_photons=1024, nloop=1,
                  sigma_dx=1.0, source_gpos=(8.0, 4.0, 4.0), jfac_scale=1.0, alpha=1.0,
                  coupling={})
    for extra in (dict(extras={"gravity": None}), dict(inflow_x={}), dict(cooling=True),
                  dict(isothermal_sound_speed=1.0)):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            domain.make_domain_rhd_step(local, **kwargs, **extra)
    with pytest.raises(ValueError, match="halo"):
        domain.make_domain_rhd_step(LocalMesh((16,), ("x",), CPU), **kwargs)
