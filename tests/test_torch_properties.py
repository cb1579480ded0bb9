"""PyTorch/CUDA port: the property API (dqc_tpu_torch.api.properties)
against the JAX package's (dqc_tpu.api.properties), on the CPU.

The JAX package takes about 20 minutes on one core for the properties of
H2O (mostly compiles: jax.hessian 7 min, the Raman spectrum's jacfwd of a
Hessian 3.5 min), so its values for H2O HF/STO-3G at the CCCBDB geometry of
tests/test_properties.py, and B3LYP H2/3-21G's polarizability, are stored
below, made by

    JAX_PLATFORMS=cpu python tests/torch_anchor_report.py properties

(props_h2o_sto3g and props_small; SCFOptions(mixed=False, tol=1e-11)).
Each H2O property is also held to the port's own central differences. The
one live JAX comparison is a third derivative, on H2/STO-3G, by nested
jax.jvp (one jit). Tolerances are written beside each check.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dqc_tpu
import dqc_tpu_torch as dqt
from dqc_tpu.scf.fixed_point import SCFOptions as JOptions
from dqc_tpu_torch.api import properties as P

torch.set_num_threads(1)
pytestmark = pytest.mark.torch_port

H2O = "O 0.0 0.0 0.2156; H 0.0 1.4749 -0.8625; H 0.0 -1.4749 -0.8625"
OPTS = dict(tol=1e-11)

# dqc_tpu HF H2O/STO-3G (torch_anchor_report.py props_h2o_sto3g), a.u.
# except the frequencies (cm^-1), IR (km/mol) and Raman (angst^4/amu)
JAX_ENERGY = -74.96260152497638
JAX_HESSIAN = [[-0.05335217613026638, 7.699573346795139e-16,
                1.0571723510460234e-16, 0.026676088065129402,
                -3.1170976539713914e-16, 2.1114598435030345e-16,
                0.026676088065142267, -4.587572412118208e-16,
                -3.172041544371333e-16],
               [7.697474641624808e-16, 0.9799519937905808,
                6.291487110635357e-15, -3.282756894951546e-16,
                -0.48997599689531557, 0.37765449372560134,
                -4.4368193254195433e-16, -0.48997599689530236,
                -0.37765449372559873],
               [1.0584210825197554e-16, 5.489702320309663e-15,
                0.611479956034805, 2.0889984989093513e-16,
                0.25215662070931544, -0.30573997801740366,
                -3.1842584134646027e-16, -0.25215662070931966,
                -0.30573997801739444],
               [0.026676088065129916, -3.2685208109262575e-16,
                2.0966614615863607e-16, -0.015934750647922245,
                2.8498052802143435e-16, -2.1327473769931276e-16,
                -0.010741337417207512, 4.212087395144852e-17,
                4.117863807249532e-18],
               [-3.112229696519108e-16, -0.4899759968952919,
                0.2521566207093148, 2.855958717219438e-16,
                0.5113700072965743, -0.314905557217459,
                2.547773639668983e-17, -0.021394010401264138,
                0.06274893650814162],
               [2.116610205859466e-16, 0.3776544937255905,
                -0.3057399780174043, -2.1350930432084777e-16,
                -0.3149055572174611, 0.2882993552408532,
                2.7468293093800007e-18, -0.06274893650813941,
                0.01744062277655139],
               [0.026676088065139394, -4.4310525358688726e-16,
                -3.1538338126323634e-16, -0.01074133741720822,
                2.6729237375703594e-17, 2.1287533490080547e-18,
                -0.01593475064793147, 4.166363672603717e-16,
                3.130862906298831e-16],
               [-4.585244945105717e-16, -0.4899759968952875,
                -0.2521566207093206, 4.2679817773211534e-17,
                -0.02139401040125863, -0.06274893650814023,
                4.182041961452655e-16, 0.5113700072965659,
                0.31490555721745817],
               [-3.1750312883792226e-16, -0.3776544937255964,
                -0.30573997801739905, 4.6094544299128654e-18,
                0.06274893650814631, 0.01744062277654914,
                3.156790120370807e-16, 0.31490555721745994,
                0.28829935524084366]]
JAX_FREQS = [4681.323346880443, 4351.262484282534, 2014.7041177285294,
             8.475750557333105e-05, 7.650816343484795e-05,
             -6.03610565226567e-05, -368.98896395242826,
             -591.5356202896705, -887.3943686914049]
JAX_IR = [17.924937234714438, 33.88990752836602, 12.040220228631222,
          1.0499778253096264e-27, 7.727540958851323e-26,
          6.24534660718336e-26, 8.35911567446003e-24, 65.94968415437188,
          207.82353775955949]
JAX_RAMAN = [17.389614080046577, 47.80533048785752, 8.165956324124805,
             3.7326305395072796e-26, 4.949736425625588e-27,
             7.855370541505082e-27, 11.200485637430669, 2.919988222532549,
             3.048345684057982]
JAX_DIPOLE = [-9.307205088174232e-17, 4.432094881449073e-15,
              -0.6660310682543229]
JAX_QUADRUPOLE = [[-4.535087652327238, -1.0989999894752359e-16,
                   9.50896557368103e-17],
                  [-1.0989999894752359e-16, -3.161138489993643,
                   -3.596493354304302e-15],
                  [9.50896557368103e-17, -3.596493354304302e-15,
                   -4.042713138645621]]
JAX_OCTUPOLE = [[[-1.7345189509327022e-16, 2.783374318984415e-15,
                  -0.0008486125453600428],
                 [2.783374318984415e-15, -9.133796574983679e-17,
                  -2.3380404398238827e-17],
                 [-0.0008486125453600428, -2.3380404398238827e-17,
                  -3.039875004347607e-17]],
                [[2.783374318984415e-15, -9.133796574983679e-17,
                  -2.3380404398238827e-17],
                 [-9.133796574983679e-17, 1.7940931450579256e-14,
                  -0.8164219840545188],
                 [-2.3380404398238827e-17, -0.8164219840545188,
                  6.4173511684150544e-15]],
                [[-0.0008486125453600428, -2.3380404398238827e-17,
                  -3.039875004347607e-17],
                 [-2.3380404398238827e-17, -0.8164219840545184,
                  6.427718431019004e-15],
                 [-3.039875004347607e-17, 6.427718431019004e-15,
                  -0.24292571787033512]]]
JAX_ALPHA = [[0.04602782134915757, 4.65598644841734e-17,
              -5.011318263098289e-17],
             [4.8395778207383096e-17, 5.507395643120053,
              8.060461065321745e-15],
             [-5.00690981985439e-17, 6.7064735811054525e-15,
              2.0086780900337313]]
JAX_ORB_EIG = -1.362613653317562e-14


# dqc_tpu B3LYP H2/3-21G, grid 1, "H 0 0 0; H 0 0 1.4" (props_small)
JAX_B3LYP_H2_ALPHA_ZZ = 6.075574163513969
# dqc_tpu HF H2/3-21G optimal_geometry from "H 0 0 0; H 1.3 0 0"
JAX_H2_BOND = 1.3886142626292217


@pytest.fixture(scope="module")
def h2o():
    mol = dqt.Mol(H2O, basis="STO-3G", device="cpu")
    return dqt.HF(mol, opts=dqt.SCFOptions(**OPTS)).run()


def _calc(desc, basis="STO-3G", **kw):
    mol = dqt.Mol(desc, basis=basis, device="cpu", **kw)
    return dqt.HF(mol, opts=dqt.SCFOptions(**OPTS)).run()


def _close(a, b, rel):
    """max |a - b| <= rel * max |b|."""
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape
    err = np.abs(a - b).max()
    assert err <= rel * np.abs(b).max(), (err, np.abs(b).max())


def test_energy_matches_jax(h2o):
    assert abs(h2o.energy().item() - JAX_ENERGY) <= 1e-10


def test_hessian_pos_matches_jax_and_central_differences(h2o):
    """hessian_pos against the JAX package's to 1e-9 of its largest entry;
    two of its columns against central differences of energy_grad (h = 1e-4
    Bohr: truncation and the SCF's 1e-11 residual over 2h stay below
    1e-7) to 1e-6. The forward and the first backward run once; one
    second backward per column."""
    h = P.hessian_pos(h2o)
    _close(h, JAX_HESSIAN, 1e-9)
    assert torch.equal(h, h.T)
    rec = h2o.stats["props"]["hessian_pos"]
    assert set(rec) >= {"forward_s", "backward_s", "columns_s", "gmres"}
    pos0 = h2o._all_params()["basis"]["atompos"].detach()
    step = 1e-4
    for atom, axis in ((1, 1), (2, 2)):
        gs = []
        for s in (1, -1):
            pos = pos0.clone()
            pos[atom, axis] += s * step
            qc = _calc((h2o.mol.atomzs, pos))
            gs.append(qc.energy_grad()["basis"]["atompos"].reshape(-1))
        fd = (gs[0] - gs[1]) / (2 * step)
        assert float((h[:, 3 * atom + axis] - fd).abs().max()) <= 1e-6


def test_vibration_ir_and_raman_match_jax(h2o):
    """Frequencies (real modes and the rotations, whose values here are
    set by the geometry's residual forces) to 1e-9 relative, the three
    translations near 0 to 1e-3 cm^-1; IR and Raman of the three real
    modes to 1e-8 relative (Raman is a third derivative of the energy)."""
    freqs, modes = P.vibration(h2o)
    f = freqs.numpy()
    real = [0, 1, 2, 6, 7, 8]
    _close(f[real], np.asarray(JAX_FREQS)[real], 1e-9)
    assert np.abs(f[3:6] - np.asarray(JAX_FREQS)[3:6]).max() <= 1e-3
    np.testing.assert_allclose((modes.T @ modes).numpy(), np.eye(9),
                               atol=1e-12)
    f2, ir = P.ir_spectrum(h2o)
    assert torch.equal(f2, freqs)
    _close(ir[:3], JAX_IR[:3], 1e-8)
    _, raman = P.raman_spectrum(h2o)
    _close(raman[:3], JAX_RAMAN[:3], 1e-8)
    _, ir_au = P.ir_spectrum(h2o, ints_unit=None)
    assert ir[0] / ir_au[0] == pytest.approx(
        dqt.utils.units.IR_INT_AU_TO_KMMOL, rel=1e-12)


def test_multipoles_match_jax(h2o):
    """Dipole, quadrupole and octupole against the JAX package's to
    1e-9 a.u.; the octupole's index symmetry; the Debye unit."""
    mu = P.edipole(h2o)
    assert np.abs(mu.numpy() - JAX_DIPOLE).max() <= 1e-9
    assert P.edipole(h2o, unit="debye")[2].item() == pytest.approx(
        mu[2].item() * 2.541746473, rel=1e-12)
    q = P.equadrupole(h2o)
    assert np.abs(q.numpy() - JAX_QUADRUPOLE).max() <= 1e-9
    o = P.eoctupole(h2o)
    assert np.abs(o.numpy() - JAX_OCTUPOLE).max() <= 1e-9
    np.testing.assert_allclose(o.numpy(), o.permute(1, 0, 2).numpy(),
                               atol=1e-12)
    np.testing.assert_allclose(o.numpy(), o.permute(0, 2, 1).numpy(),
                               atol=1e-12)
    assert h2o.stats["props"]["eoctupole"]["gmres"]


def test_polarizability_matches_jax_and_dipole_differences(h2o):
    """alpha against the JAX package's to 1e-9 relative; its y column
    against central differences of edipole in a field E_y = +-1e-4 a.u.
    (truncation ~1e-8 here) to 1e-6. Only the field is a leaf."""
    a = P.polarizability(h2o)
    _close(a, JAX_ALPHA, 1e-9)
    p, leaves = h2o._leaves(P._params(h2o, "efield"), wrt=[("efield",)])
    assert len(leaves) == 1 and leaves[0] is p["efield"]
    assert not p["basis"]["atompos"].requires_grad
    step = 1e-4
    mus = [P.edipole(_calc(H2O, efield=np.array([0.0, s * step, 0.0])))
           for s in (1, -1)]
    fd = (mus[0] - mus[1]) / (2 * step)
    assert float((a[:, 1] - fd).abs().max()) <= 1e-6
    assert P.polarizability(h2o, unit="angst^3")[1, 1].item() == \
        pytest.approx(a[1, 1].item() * 0.529177210903 ** 3, rel=1e-12)


def test_orbital_hessian_matches_jax(h2o):
    """The lowest eigenvalue of the orbital-rotation Hessian (rounding
    level at a minimum in both packages) to 1e-9; is_orb_min."""
    assert abs(P.lowest_eival_orb_hessian(h2o).item() - JAX_ORB_EIG) <= 1e-9
    assert P.is_orb_min(h2o)


def test_b3lyp_polarizability_matches_jax():
    """B3LYP H2/3-21G (grid 1): the plain versions of K1-K3 in a second
    derivative; alpha_zz against the JAX package's to 1e-9 relative, the
    rest zero by symmetry."""
    mol = dqt.Mol("H 0 0 0; H 0 0 1.4", basis="3-21G", grid=1, device="cpu")
    qc = dqt.KS(mol, xc="b3lyp", opts=dqt.SCFOptions(**OPTS)).run()
    a = P.polarizability(qc)
    assert abs(a[2, 2].item() - JAX_B3LYP_H2_ALPHA_ZZ) <= \
        1e-9 * JAX_B3LYP_H2_ALPHA_ZZ
    off = a.clone()
    off[2, 2] = 0.0
    assert float(off.abs().max()) <= 1e-10


H2_OFF_AXIS = "H 0 0 0; H 0 0.1 1.4"


def _jax_third_derivative():
    """-d alpha_zz / dz of atom 1 and alpha_zz of dqc_tpu HF H2/STO-3G
    (H2_OFF_AXIS) by nested jax.jvp through its energy_fn, under one
    jax.jit (one compile, about 14 s on one core)."""
    mol = dqc_tpu.Mol(H2_OFF_AXIS, basis="STO-3G")
    qc = dqc_tpu.HF(mol, opts=JOptions(mixed=False, **OPTS)).run()
    p0 = qc._all_params()
    ez = jnp.array([0.0, 0.0, 1.0])

    def d2(pos):
        def e_of(ef):
            p = dict(p0, efield=ef, basis=dict(p0["basis"], atompos=pos))
            return qc.energy_fn(p)

        def d1(ef):
            return jax.jvp(e_of, (ef,), (ez,))[1]
        return jax.jvp(d1, (p0["efield"],), (ez,))[1]

    pos0 = p0["basis"]["atompos"]
    dz = jnp.zeros_like(pos0).at[1, 2].set(1.0)
    e2, e3 = jax.jit(lambda q: jax.jvp(d2, (q,), (dz,)))(pos0)
    return -float(e2), -float(e3)


def test_third_derivative_matches_jax_and_central_differences():
    """d alpha / dR (a third derivative through implicit_fixed_point: the
    field Hessian with its graph kept, then one more backward) on
    H2/STO-3G off its axis: d alpha_zz / dz of atom 1 against the JAX
    package's nested jax.jvp to 1e-9 relative, and the z and y columns of
    atom 1 against central differences of the port's own polarizability
    (h = 1e-4 Bohr; truncation ~1e-9 here) to 1e-7."""
    qc = _calc(H2_OFF_AXIS)
    alpha, da = P._dalpha_dpos(qc)
    alpha_zz, dzz = _jax_third_derivative()
    assert abs(alpha[2, 2].item() - alpha_zz) <= 1e-9 * abs(alpha_zz)
    assert abs(da[2, 2, 5].item() - dzz) <= 1e-9 * abs(dzz)
    pos0 = qc._all_params()["basis"]["atompos"].detach()
    step = 1e-4
    for axis in (1, 2):
        al = []
        for s in (1, -1):
            pos = pos0.clone()
            pos[1, axis] += s * step
            al.append(P.polarizability(_calc((qc.mol.atomzs, pos))))
        fd = (al[0] - al[1]) / (2 * step)
        assert float((da[:, :, 3 + axis] - fd).abs().max()) <= 1e-7
    # every order's solves went through GMRES and converged
    recs = qc.stats["props"]["raman_spectrum"]["gmres"]
    assert len(recs) > 6 and max(r["rel"] for r in recs) <= 1e-8


def test_optimal_geometry_matches_jax():
    """H2/3-21G from 1.3 Bohr: the bond against the JAX package's optimum
    to 1e-5 Bohr (BFGS stops at max |force| 1e-6 in both) and CCCBDB's
    1.3886 to 2e-3 (tests/test_properties.py:60-68)."""
    qc = _calc("H 0 0 0; H 1.3 0 0", basis="3-21G")
    pos = P.optimal_geometry(qc)
    d = float(torch.linalg.vector_norm(pos[1] - pos[0]))
    assert abs(d - JAX_H2_BOND) <= 1e-5
    assert abs(d - 1.3886) <= 2e-3
    assert qc.stats["props"]["optimal_geometry"]["iterations"] > 0
