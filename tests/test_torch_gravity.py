"""Gravity parity: the PyTorch port's Pines recursion against nyx_tpu.

Both packages get the same numpy inputs (positions from a numpy seed, JGM3
from the repo's data/ directory) and the same recursion rows: the port's
Harmonics is built from the reference object's `_tables` through
`nyx_tpu_torch.interop`. All gravity tests live in this one file because
every test worker pays both the JAX and the torch import.

The test marked `cuda` needs only the port. A machine with a card but no
JAX runs it alone with

    python -m pytest --noconftest -m cuda tests/test_torch_gravity.py
"""

from pathlib import Path

import numpy as np
import pytest
import torch

try:
    import jax.numpy as jnp

    from nyx_tpu import Frames as RFrames
    from nyx_tpu.dynamics import Harmonics as RHarmonics
    from nyx_tpu.dynamics import gravity_pallas
    from nyx_tpu.io.gravity import GravityFieldData as RGravityFieldData
except ModuleNotFoundError:  # no JAX: only the port-only `cuda` test can run
    jnp = None

from chip_smoke import extend_kaula
from nyx_tpu_torch import Frames
from nyx_tpu_torch.dynamics import Harmonics
from nyx_tpu_torch.dynamics import gravity_pines
from nyx_tpu_torch.io.gravity import GravityFieldData
from nyx_tpu_torch.interop import harmonics_from_tables

JGM3 = Path(__file__).parents[1] / "data/JGM3.cof.gz"

# The reference's own f32 bound for two f32 evaluations of the recursion
# that round differently (tests/test_dynamics.py:399,415): per-lane norm of
# the difference over the norm of the acceleration.
F32_REL = 2e-5
# Two f64 evaluations of the same rows that differ only in summation order
# and in C*sqrt2 being pre-multiplied: a few hundred ulps at most.
F64_REL = 1e-12

FIELDS = {
    "21x21-split": (21, 21, "split"),
    "12x6": (12, 6, "f32"),
}
# Fields above 21x21: JGM3 in full, whose table the kernel stages whole, and
# JGM3 extended with Kaula-rule coefficients (`chip_smoke.extend_kaula`) to 120x120 and
# 160x160, whose tables stream through the kernel's buffers.
HIGH_FIELDS = {
    "70x70": (70, 0),
    "120x120": (120, 7),
    "160x160": (160, 8),
}


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float((np.linalg.norm(a - b, axis=-1) / np.linalg.norm(b, axis=-1)).max())


def _positions(n, seed, r_min=6700.0, r_max=42000.0):
    rng = np.random.default_rng(seed)
    r = rng.normal(size=(n, 3))
    return r / np.linalg.norm(r, axis=1, keepdims=True) * rng.uniform(r_min, r_max, (n, 1))


def _pair(name):
    """(reference Harmonics, port Harmonics built from its tables)."""
    deg, order, precision = FIELDS[name]
    stor = RGravityFieldData.from_cof(JGM3, deg, order, True, RFrames.IAU_EARTH)
    ref = RHarmonics.from_stor(stor, precision=precision)
    port = harmonics_from_tables(
        *ref._tables, ref.mu_km3_s2, ref.radius_km, precision, ref.j2, ref.j3
    )
    return ref, port


@pytest.mark.parametrize("name", sorted(FIELDS))
@pytest.mark.parametrize("q_hi", [0, 3])
def test_pack_tables_bitwise(name, q_hi):
    """(a) The port's pack_tables is the Pallas kernel's table, bit for bit,
    and the port's own from_stor builds the reference's recursion rows."""
    deg, order, precision = FIELDS[name]
    ref, _ = _pair(name)
    xs, _, N, M = ref._tables
    tab_ref, _gate = gravity_pallas.pack_tables(xs, N, M + 2, 0, q_hi)
    tab = gravity_pines.pack_tables(xs, N, M + 2, q_hi)
    assert tab.dtype == tab_ref.dtype == np.float32
    np.testing.assert_array_equal(tab, tab_ref)

    own = Harmonics.from_stor(
        GravityFieldData.from_cof(JGM3, deg, order, True, Frames.IAU_EARTH), precision
    )
    for key, rows in xs.items():
        np.testing.assert_array_equal(own._tables[0][key], rows, err_msg=key)
    assert (own.j2, own.j3) == (ref.j2, ref.j3)


@pytest.mark.parametrize(
    "name,q_lo", [("21x21-split", 0), ("21x21-split", 3), ("12x6", 0)]
)
def test_twin_f32_matches_unrolled(name, q_lo):
    """(b) The f32 twin against the reference's f32 XLA recursion
    (`_accel_unrolled`), within the f32 bound."""
    ref, port = _pair(name)
    r = _positions(64, 3)
    a_ref = np.asarray(ref._accel_unrolled(jnp.asarray(r, jnp.float32), q_lo))
    a = port._accel_any(torch.tensor(r, dtype=torch.float32), q_lo)
    assert a.dtype == torch.float32
    assert _rel(a.numpy(), a_ref) < F32_REL


@pytest.mark.parametrize("q_lo", [0, 3])
def test_twin_matches_pallas_interpret(q_lo):
    """(c) The twin against the Pallas kernel itself (interpret mode) at a
    ragged B = 37, from the same packed table."""
    ref, port = _pair("21x21-split")
    xs, diag, N, M = ref._tables
    tab, gate = gravity_pallas.pack_tables(xs, N, M + 2, q_lo, 0)
    r = _positions(37, 5)
    kw = dict(W=M + 2, mu=ref.mu_km3_s2, radius=ref.radius_km, diag1=float(diag[1]))
    a_pal = np.asarray(
        gravity_pallas.pines_accel_pallas(
            jnp.asarray(r, jnp.float32), jnp.asarray(tab), gate, interpret=True, **kw
        )
    )
    a = gravity_pines.pines_accel_torch(
        torch.tensor(r, dtype=torch.float32), torch.from_numpy(tab), q_lo, **kw
    )
    assert _rel(a.numpy(), a_pal) < F32_REL


def test_mixed_precision_matches_reference():
    """precision="mixed" at f64: degrees <= 3 through the f64 twin, the rest
    through the f32 twin, against the reference's mixed evaluation. The f32
    part is ~1e-3 of the field, so the f32 bound on it is ~2e-8 on the sum."""
    stor = RGravityFieldData.from_cof(JGM3, 21, 21, True, RFrames.IAU_EARTH)
    ref = RHarmonics.from_stor(stor, precision="mixed")
    port = harmonics_from_tables(
        *ref._tables, ref.mu_km3_s2, ref.radius_km, "mixed", ref.j2, ref.j3
    )
    r = _positions(64, 19, 6700.0, 7500.0)
    a_ref = np.asarray(ref.accel_body_fixed(jnp.asarray(r)))
    a = port.accel_body_fixed(torch.tensor(r, dtype=torch.float64))
    assert a.dtype == torch.float64
    assert _rel(a.numpy(), a_ref) < F32_REL * 1e-3


@pytest.mark.parametrize("precision", ["split", "f64"])
def test_twin_f64_matches_unrolled(precision):
    """(d) At f64 the twin (from f64 packed rows) is the reference's f64
    recursion to summation-order round-off."""
    stor = RGravityFieldData.from_cof(JGM3, 21, 21, True, RFrames.IAU_EARTH)
    ref = RHarmonics.from_stor(stor, precision=precision)
    port = harmonics_from_tables(
        *ref._tables, ref.mu_km3_s2, ref.radius_km, precision, ref.j2, ref.j3
    )
    r = _positions(64, 7)
    a_ref = np.asarray(ref._accel_unrolled(jnp.asarray(r)))
    a = port.accel_body_fixed(torch.tensor(r, dtype=torch.float64))
    assert a.dtype == torch.float64
    assert _rel(a.numpy(), a_ref) < F64_REL


def test_split_accel_with_rotation_matches_reference():
    """(e) Harmonics.accel at split precision, through the f64 pole / f32
    rows of iau_earth_dcm32_pole: the f32 part of the field agrees within
    the f32 bound, and J2+J3 (f64) agree to f64 round-off."""
    ref, port = _pair("21x21-split")
    rng = np.random.default_rng(11)
    B = 48
    r = _positions(B, 13, 6700.0, 7500.0)
    t = 6.68e8 + rng.uniform(0.0, 86_400.0, B)
    a_ref = np.asarray(ref.accel(None, jnp.asarray(t), jnp.asarray(r), None))
    a = port.accel(None, torch.tensor(t), torch.tensor(r), None).numpy()

    from nyx_tpu.cosmic.rotations import iau_earth_dcm32_pole as r_dcm32_pole
    from nyx_tpu.dynamics.gravity import _j2j3_accel as r_j2j3
    from nyx_tpu_torch.cosmic.rotations import iau_earth_dcm32_pole
    from nyx_tpu_torch.dynamics.gravity import _j2j3_accel

    _, pole_ref = r_dcm32_pole(jnp.asarray(t))
    a_low_ref = np.asarray(
        r_j2j3(ref.mu_km3_s2, ref.radius_km, ref.j2, ref.j3, jnp.asarray(r), pole_ref)
    )
    _, pole = iau_earth_dcm32_pole(torch.tensor(t))
    a_low = _j2j3_accel(port.mu_km3_s2, port.radius_km, port.j2, port.j3, torch.tensor(r), pole)
    assert _rel(a_low.numpy(), a_low_ref) < F64_REL
    # the f32 remainder of the field is the quantity held to the f32 bound
    assert _rel(a - a_low_ref, a_ref - a_low_ref) < F32_REL


def _high_stor(name):
    """The port's GravityFieldData of a HIGH_FIELDS entry, built from JGM3."""
    degree, seed = HIGH_FIELDS[name]
    stor = GravityFieldData.from_cof(JGM3, 70, 70, True, Frames.IAU_EARTH)
    return stor if degree == 70 else extend_kaula(stor, degree, seed)


def _high_pair(name, precision):
    """(reference Harmonics, port Harmonics) of a HIGH_FIELDS entry, both
    from the same numpy coefficients."""
    stor = _high_stor(name)
    rstor = RGravityFieldData(stor.c_nm, stor.s_nm, stor.mu_km3_s2, stor.radius_km,
                              RFrames.IAU_EARTH)
    return (RHarmonics.from_stor(rstor, precision=precision),
            Harmonics.from_stor(stor, precision))


@pytest.mark.parametrize(
    "name,q_lo", [("70x70", 0), ("70x70", 3), ("120x120", 0), ("120x120", 3)]
)
def test_twin_high_degree_f32_matches_scan(name, q_lo):
    """The f32 twin, fed from the port's own packed table, against the
    reference's f32 scan recursion (`_accel_scan`, the reference's path
    above degree 40), within the reference's f32 bound."""
    ref, port = _high_pair(name, "split")
    r = _positions(16, 23)
    a_ref = np.asarray(ref._accel_scan(jnp.asarray(r, jnp.float32), q_lo))
    tab = port.packed_table(0, torch.float32, "cpu")
    a = gravity_pines.pines_accel_torch(
        torch.tensor(r, dtype=torch.float32), tab, q_lo, **port.pines_args()
    )
    assert a.dtype == torch.float32 and np.isfinite(a.numpy()).all()
    assert _rel(a.numpy(), a_ref) < F32_REL


@pytest.mark.parametrize("q_lo", [0, 3])
def test_twin_70x70_f64_matches_scan(q_lo):
    """At f64 the twin's 70x70 recursion is the reference's scan to
    summation-order round-off (more degrees than at 21x21: 1e-11)."""
    ref, port = _high_pair("70x70", "f64")
    r = _positions(16, 29)
    a_ref = np.asarray(ref._accel_scan(jnp.asarray(r), q_lo))
    tab = port.packed_table(0, torch.float64, "cpu")
    a = gravity_pines.pines_accel_torch(
        torch.tensor(r, dtype=torch.float64), tab, q_lo, **port.pines_args()
    )
    assert a.dtype == torch.float64
    assert _rel(a.numpy(), a_ref) < 1e-11


@pytest.mark.parametrize("first", range(2, 201, 23))
def test_launch_plan_any_size(first):
    """pines_launch_plan for every degree from 2 to 200 (23 a case) and
    every width up to 208 columns: the block fits the card's shared memory,
    its chunks cover every degree step once, and a table that fits beside
    the reduction scratch is staged whole."""
    for W_pad in range(8, 209, 8):
        for steps in range(first, min(first + 23, 201)):
            plan = gravity_pines.pines_launch_plan(steps, W_pad)
            assert plan.smem_bytes <= gravity_pines.SMEM_PER_BLOCK
            covered = [k for k0, k1 in plan.chunks() for k in range(k0, k1)]
            assert covered == list(range(steps))
            # a staged column is 8 floats of a degree step
            scratch = 16 * plan.warps * 33
            fits = 32 * steps * (W_pad + 1) + scratch <= gravity_pines.SMEM_PER_BLOCK
            assert plan.whole == fits, (steps, W_pad)
            if plan.whole:  # every column and a zero one past them
                assert plan.cols == W_pad + 1
                assert plan.smem_bytes == 32 * steps * plan.cols + scratch
            else:  # two buffers of one group's columns and the next group's first
                assert plan.cols == 33
                assert plan.smem_bytes == 2 * 32 * plan.chunk_steps * plan.cols + scratch
            assert plan.warps * 32 <= 1024


def test_launch_plan_footprint_fixed_at_any_degree():
    """Above one column group the streamed footprint no longer grows: a
    2190x2190 field (EGM2008's full degree) plans like a 200x200 one."""
    big = gravity_pines.pines_launch_plan(2190, 2192)
    assert not big.whole and big.smem_bytes <= gravity_pines.SMEM_PER_BLOCK
    assert big.smem_bytes == gravity_pines.pines_launch_plan(200, 208).smem_bytes
    with pytest.raises(ValueError):
        gravity_pines.pines_launch_plan(21, 23)  # W_pad must be a multiple of 8


@pytest.mark.cuda
def test_kernel_matches_twin_on_card():
    """(f) The CUDA kernel against the twin on the card, from B = 1 (the
    OD leg's single-lane propagations) up. Both round every f32 operation
    alike and sum the orders in one order, so they agree bit for bit (the
    f32 bound would be 2e-5). Then the kernel's primal with the twin's
    tangent (gravity.PinesAccel) at the OD shapes, whole and cut to degree
    8, against the twin under torch.func.jvp."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    cases = [("21x21-split", 0, 10_000), ("21x21-split", 3, 37), ("12x6", 0, 37),
             ("21x21-split", 0, 1), ("70x70", 0, 1)]
    cases += [(name, 3, B) for name in HIGH_FIELDS for B in (10_000, 37)]
    for name, q_lo, B in cases:
        if name in HIGH_FIELDS:
            port = Harmonics.from_stor(_high_stor(name), "split")
        else:
            deg, order, precision = FIELDS[name]
            port = Harmonics.from_stor(
                GravityFieldData.from_cof(JGM3, deg, order, True, Frames.IAU_EARTH), precision
            )
        tab = port.packed_table(0, torch.float32, "cuda")
        r = torch.tensor(_positions(B, 17), dtype=torch.float32, device="cuda")
        kw = port.pines_args()
        a_k = gravity_pines.pines_accel_cuda(r, tab, q_lo, **kw)
        a_t = gravity_pines.pines_accel_torch(r, tab, q_lo, **kw)
        torch.cuda.synchronize()
        assert torch.equal(a_k, a_t), (name, q_lo, B)

    # the tangent: under torch.func.jvp the Harmonics evaluation launches
    # the kernel for the primal and takes the twin's tangent; against the
    # twin differentiated directly, the primal is bitwise equal, and so is
    # the tangent (the same twin operations)
    deg, order, precision = FIELDS["21x21-split"]
    port = Harmonics.from_stor(
        GravityFieldData.from_cof(JGM3, deg, order, True, Frames.IAU_EARTH), precision)
    tab = port.packed_table(0, torch.float32, "cuda")
    kw = port.pines_args()
    for B, jvp_degree in ((1, None), (1_157, None), (1_157, 8)):
        field = port if jvp_degree is None else port.with_jvp_degree(jvp_degree)
        r = torch.tensor(_positions(B, 19), dtype=torch.float32, device="cuda")
        dr = torch.tensor(np.random.default_rng(B).normal(size=(B, 3)), dtype=torch.float32,
                          device="cuda")
        launches = gravity_pines.pines_accel_cuda.launches
        twin_calls = gravity_pines.pines_accel_torch.cuda_calls
        a, da = torch.func.jvp(field.accel_body_fixed, (r,), (dr,))
        assert gravity_pines.pines_accel_cuda.launches == launches + 1
        assert gravity_pines.pines_accel_torch.cuda_calls == twin_calls
        tab_t = tab if jvp_degree is None else field.packed_table(jvp_degree, torch.float32, "cuda")
        a_t, da_t = torch.func.jvp(
            lambda x: gravity_pines.pines_accel_torch(x, tab_t, 0, **kw), (r,), (dr,))
        torch.cuda.synchronize()
        if jvp_degree is None:
            assert torch.equal(a, a_t), B
        else:
            assert torch.equal(a, gravity_pines.pines_accel_torch(r, tab, 0, **kw)), B
        assert torch.equal(da, da_t), (B, jvp_degree)


def test_kernel_wrapper_rejects_what_it_cannot_run():
    """The kernel wrapper refuses a CPU tensor instead of falling back, and
    the dispatcher takes the twin for a CPU tensor without launching. No
    table is refused for its size: every size has a plan, and on a card
    the largest field here runs through the kernel."""
    _, port = _pair("12x6")
    tab = port.packed_table(0, torch.float32, "cpu")
    kw = port.pines_args()
    with pytest.raises(ValueError, match="CUDA"):
        gravity_pines.pines_accel_cuda(torch.zeros(4, 3), tab, 0, **kw)
    launches = gravity_pines.pines_accel_cuda.launches
    a = gravity_pines.pines_accel(torch.tensor(_positions(4, 1), dtype=torch.float32), tab, 0, **kw)
    assert a.shape == (4, 3) and gravity_pines.pines_accel_cuda.launches == launches

    big = Harmonics.from_stor(_high_stor("160x160"), "split")
    big_tab = big.packed_table(0, torch.float32, "cpu")
    assert big_tab.numel() * 4 > gravity_pines.SMEM_PER_BLOCK
    plan = gravity_pines.pines_launch_plan(*big_tab.shape[::2])
    assert plan.smem_bytes <= gravity_pines.SMEM_PER_BLOCK
    with pytest.raises(ValueError, match="CUDA"):  # the device, not the size
        gravity_pines.pines_accel_cuda(torch.zeros(4, 3), big_tab, 0, **big.pines_args())
    if torch.cuda.is_available():
        r = torch.tensor(_positions(37, 2), dtype=torch.float32, device="cuda")
        a = gravity_pines.pines_accel_cuda(r, big_tab.cuda(), 3, **big.pines_args())
        assert bool(torch.isfinite(a).all())
