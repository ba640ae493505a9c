"""The obstacle-free 3D slice of the port against the JAX package's, on
the CPU, module by module: `grids3d.py`, the 3D part of
`ops/spectral.py`, `ops/interp3d.py`, the 4-D branch of
`physics/poisson.py`, `physics/fluid3d.py`, the nets at dim=3,
`control/pde_fluid3d.py` and `experiments/smoke3d.py`.

The JAX side is compiled once per function (its compiles take most of
this file's time): one step with its VJP, one step forward, the nets and
their VJPs, `optimize_forces` and the generator.

8³ volumes (8×6×4 where the axes must differ), batch 2, inputs from a
numpy seed. Held to:
* the grids, face resamples and masks exactly (1e-6);
* the spectral transforms and solves within 1e-5 of the output's scale
  (fp32 products in another order);
* the samplers' outputs within 1e-6 and their gradients within 1e-5 of
  the JAX package's, at random displacements and at the tie points
  (integer displacements and the clip bound, where JAX's subgradients
  rule; `ops/interp3d.py`);
* `solve_pressure` on volumes (the spectral solve closed and open, the
  host-checked CG with a plate), its state within 1e-5 and its gradient
  within 1e-4 of their scale at pressure tol 1e-6; the step with the
  plate (CG) with every input's gradient, and without an obstacle
  (spectral), at the same tolerances;
* the spectral solve against the 3D 'pcg' route and a warm start against
  a cold one, within the CG's tolerance;
* the nets at dim=3 (CFE, U-net with 2 levels, bf16) on weights converted
  from flax's DHWIO kernels: the forward within 2e-2 of its scale, and in
  fp32 the input and kernel gradients within 1e-4; the conversion round
  trip exactly;
* the PDE in both control modes (direct without, buoyancy with a force
  mask and inflow): the CFE's inputs and the OP's exactly, the force from
  a net output, its cost and |F| within 1e-6;
* one `optimize_forces` iteration on the 3D PDE: the history at rtol
  1e-4 (`tests/test_torch_adjoint.py`'s tolerance) and the forces within
  5e-5: Adam's first step is lr·g/(|g| + 1e-8), which for the few
  gradients near 1e-8 moves with the fp32 gradients' last digits (one
  face of 2,304 differs by 2.4e-5 at lr 0.1);
* the 3D generators' constructions from the JAX package's draws within
  1e-6, and `generate_forced_smoke3d_dataset` with its draws replaced by
  the JAX package's within 1e-5 of the JAX package's dataset; the entries'
  setups and CurriculumConfigs as the JAX package's.
The step's and `optimize_forces`'s tests are in
`tests/test_torch_smoke3d_step.py` (a file of at most five tests, which
the test run hands out last).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pde_control_tpu import grids3d as jgrids
from pde_control_tpu.control.pde_fluid3d import IncompressibleFluid3DPDE as JPDE
from pde_control_tpu.experiments import smoke3d as jsmoke3d
from pde_control_tpu.models import nets as jnets
from pde_control_tpu.ops import interp3d as jinterp
from pde_control_tpu.ops import spectral as jspec
from pde_control_tpu.physics import fluid3d as jfluid
from pde_control_tpu.physics.poisson import solve_pressure as jsolve
from pde_control_tpu_torch import grids3d
from pde_control_tpu_torch.control.pde_fluid3d import IncompressibleFluid3DPDE
from pde_control_tpu_torch.experiments import smoke3d
from pde_control_tpu_torch.models import nets
from pde_control_tpu_torch.ops import interp3d, spectral
from pde_control_tpu_torch.physics import fluid3d
from pde_control_tpu_torch.physics.poisson import _pick_backend, solve_pressure
from pde_control_tpu_torch.utils.convert import params_from_flax, params_to_flax

torch.set_num_threads(1)

D, B = 8, 2


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _close(got, want, limit, label=""):
    """max|got - want| within `limit` of max|want|."""
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape, label
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= limit * scale, f"{label}: {err:.3e} > {limit} x {scale:.3e}"


def _plate(d=D, h=D, w=D) -> np.ndarray:
    """A horizontal plate at mid-height with a hole (obstacle_plate_3d's
    shape at 8³)."""
    m = np.zeros((d, h, w), np.float32)
    m[d // 2, :, :] = 1.0
    m[d // 2, 2:5, 3:6] = 0.0
    return m


def _domains(obstacle: bool, closed: bool, shape=(D, D, D)):
    mask = _plate(*shape) if obstacle else None
    j = jgrids.Domain3D.create(*shape, closed=closed,
                               obstacle_mask=None if mask is None
                               else jnp.asarray(mask))
    t = grids3d.Domain3D.create(*shape, obstacle_mask=mask, closed=closed,
                                device="cpu")
    return j, t


def _vel(rng, scale=0.5, shape=(D, D, D)):
    d, h, w = shape
    return [(scale * rng.normal(size=s)).astype(np.float32) for s in
            ((B, d + 1, h, w), (B, d, h + 1, w), (B, d, h, w + 1))]


# ------------------------------------------------------------------ grids


@pytest.mark.parametrize("obstacle,closed", [(False, True), (True, True),
                                             (True, False)])
def test_domain_and_grids_match_jax(obstacle, closed):
    rng = np.random.default_rng(0)
    jd, td = _domains(obstacle, closed, (D, 6, 4))
    assert td.has_obstacles is jd.has_obstacles is obstacle
    assert td.grid_shape == jd.grid_shape == (D, 6, 4)
    for k in ("fluid_mask", "acc_z", "acc_y", "acc_x"):
        np.testing.assert_array_equal(getattr(td, k).numpy(),
                                      np.asarray(getattr(jd, k)), err_msg=k)
    vz, vy, vx = _vel(rng, shape=(D, 6, 4))
    jv = jgrids.Staggered3D(*map(jnp.asarray, (vz, vy, vx)))
    tv = grids3d.Staggered3D(*map(_t, (vz, vy, vx)))
    assert tv.grid_shape == jv.grid_shape and tv.batch == B
    for got, want in zip(tv.at_centers(), jv.at_centers()):
        _close(got, want, 1e-6)
    _close(tv.divergence(0.5), jv.divergence(0.5), 1e-6)
    for got, want in zip(vars(td.mask_velocity(tv)).values(),
                         (jd.mask_velocity(jv).vz, jd.mask_velocity(jv).vy,
                          jd.mask_velocity(jv).vx)):
        _close(got, want, 1e-6)
    p = rng.normal(size=(B, D, 6, 4)).astype(np.float32)
    jg, tg = jd.pressure_gradient(jnp.asarray(p)), td.pressure_gradient(_t(p))
    for k in ("vz", "vy", "vx"):
        _close(getattr(tg, k), getattr(jg, k), 1e-6, k)
    c = p
    for tf, jf in ((grids3d.centered_to_z_faces, jgrids.centered_to_z_faces),
                   (grids3d.centered_to_y_faces_3d,
                    jgrids.centered_to_y_faces_3d),
                   (grids3d.centered_to_x_faces_3d,
                    jgrids.centered_to_x_faces_3d)):
        for boundary in ("clamp", "periodic"):
            _close(tf(_t(c), boundary), jf(jnp.asarray(c), boundary), 1e-6)


def test_constructors_default_to_the_gpu():
    """With no `device` the 3D constructors build on the card; on a host
    without one they raise and never fall back."""
    if torch.cuda.is_available():
        assert grids3d.Domain3D.create(4, 4, 4).device.type == "cuda"
        return
    for build in (lambda: grids3d.Domain3D.create(4, 4, 4),
                  lambda: grids3d.Staggered3D.zeros(1, 4, 4, 4),
                  lambda: fluid3d.FluidState3D.zeros(1, 4, 4, 4)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            build()
    s = fluid3d.FluidState3D.zeros(2, 4, 5, 6, with_inflow=True, device="cpu")
    assert s.velocity.vz.shape == (2, 5, 5, 6) and s.inflow.shape == (2, 4, 5, 6)


# --------------------------------------------------------------- spectral


def test_spectral_3d_matches_jax():
    rng = np.random.default_rng(1)
    x = rng.normal(size=(B, D, 6, 4)).astype(np.float32)
    for name in ("dct2_3d", "idct2_3d", "dst1_3d"):
        _close(getattr(spectral, name)(_t(x)),
               getattr(jspec, name)(jnp.asarray(x)), 1e-5, name)
    b = x - x.mean(axis=(1, 2, 3), keepdims=True)
    for name in ("spectral_neumann_solve", "spectral_dirichlet_solve"):
        got = getattr(spectral, name)(_t(b), dx=0.5)
        _close(got, getattr(jspec, name)(jnp.asarray(b), dx=0.5), 1e-5, name)
    # The transforms are orthonormal: the inverse undoes the forward.
    _close(spectral.idct2_3d(spectral.dct2_3d(_t(x))), x, 1e-5)
    _close(spectral.dst1_3d(spectral.dst1_3d(_t(x))), x, 1e-5)


# --------------------------------------------------------------- samplers


def _sampler_inputs(case: str):
    rng = np.random.default_rng(2)
    field = rng.normal(size=(B, D, 6, 4)).astype(np.float32)
    if case == "random":
        disp = [rng.uniform(-1.6, 1.6, size=field.shape).astype(np.float32)
                for _ in range(3)]
    else:  # ties: integer displacements, the clip bound and beyond it
        ties = np.array([-2.0, -1.0, 0.0, 1.0, 2.0, 0.5], np.float32)
        disp = [ties[rng.integers(0, len(ties), size=field.shape)]
                for _ in range(3)]
    cot = rng.normal(size=field.shape).astype(np.float32)
    return field, disp, cot


@pytest.mark.parametrize("boundary", ["clamp", "periodic"])
@pytest.mark.parametrize("case", ["random", "ties"])
def test_shift_sampler_matches_jax(case, boundary):
    """Forward and the gradients of field and displacements, JAX's
    subgradients at the tie points included."""
    field, disp, cot = _sampler_inputs(case)

    def jfn(f, dz, dy, dx):
        return jinterp.shift_trilinear_sample_3d(f, dz, dy, dx, 1, boundary)

    jout, vjp = jax.vjp(jfn, jnp.asarray(field), *map(jnp.asarray, disp))
    jgrads = vjp(jnp.asarray(cot))
    args = [_t(a).requires_grad_(True) for a in [field] + disp]
    out = interp3d.shift_trilinear_sample_3d(*args, max_shift=1,
                                             boundary=boundary)
    _close(out, jout, 1e-6, "forward")
    out.backward(_t(cot))
    for name, a, g in zip(("field", "dz", "dy", "dx"), args, jgrads):
        _close(a.grad, g, 1e-5, name)
    if case == "ties":
        assert float(args[1].grad.abs().max()) > 0


def test_gather_sampler_matches_jax():
    field, disp, cot = _sampler_inputs("random")
    _, d, h, w = field.shape
    grid = np.meshgrid(np.arange(d), np.arange(h), np.arange(w), indexing="ij")
    coords = [(g[None] + c).astype(np.float32) for g, c in zip(grid, disp)]
    for boundary in ("clamp", "periodic"):
        jout, vjp = jax.vjp(
            lambda f, z, y, x: jinterp.trilinear_sample_3d(f, z, y, x, boundary),
            jnp.asarray(field), *map(jnp.asarray, coords))
        jgrads = vjp(jnp.asarray(cot))
        args = [_t(a).requires_grad_(True) for a in [field] + coords]
        out = interp3d.trilinear_sample_3d(*args, boundary=boundary)
        _close(out, jout, 1e-6, boundary)
        out.backward(_t(cot))
        for a, g in zip(args, jgrads):
            _close(a.grad, g, 1e-5, boundary)


# ---------------------------------------------------------- pressure solve


def test_pick_backend_on_volumes():
    div = torch.zeros(1, 4, 4, 4)
    _, empty = _domains(False, True, (4, 4, 4))
    plate = grids3d.Domain3D.create(4, 4, 4, obstacle_mask=_plate(4, 4, 4),
                                    device="cpu")
    open_plate = grids3d.Domain3D.create(4, 4, 4, obstacle_mask=_plate(4, 4, 4),
                                         closed=False, device="cpu")
    assert _pick_backend("auto", div, empty) == "spectral"
    assert _pick_backend("auto", div, plate) == "pcg"
    assert _pick_backend("auto", div, open_plate) == "pcg"
    assert _pick_backend("jax", div, plate) == "jax"
    with pytest.raises(ValueError, match="2D"):
        _pick_backend("cuda", div, empty)
    with pytest.raises(ValueError, match="obstacles"):
        _pick_backend("spectral", div, plate)
    with pytest.raises(ValueError, match="2D"):
        solve_pressure(div, empty, backend="cuda")
    with pytest.raises(ValueError, match=r"\(B, D, H, W\)"):
        _pick_backend("auto", torch.zeros(1, 1, 4, 4, 4), empty)


_SOLVES = {"spectral-closed": (False, True, "auto"),
           "spectral-open": (False, False, "auto"),
           "pcg-plate": (True, True, "auto"),
           "jax-open-plate": (True, False, "jax")}


@pytest.mark.parametrize("case", sorted(_SOLVES))
def test_solve_pressure_matches_jax(case):
    """The solution and the gradient of sum(w·p) through the solve."""
    obstacle, closed, backend = _SOLVES[case]
    jd, td = _domains(obstacle, closed)
    rng = np.random.default_rng(3)
    div = rng.normal(size=(B, D, D, D)).astype(np.float32)
    w = rng.normal(size=div.shape).astype(np.float32)
    kw = dict(tol=1e-6, maxiter=500, backend=backend)
    jp, vjp = jax.vjp(lambda d: jsolve(d, jd, **kw), jnp.asarray(div))
    (jg,) = vjp(jnp.asarray(w))
    d = _t(div).requires_grad_(True)
    p = solve_pressure(d, td, **kw)
    _close(p, jp, 1e-5, "p")
    (p * _t(w)).sum().backward()
    _close(d.grad, jg, 1e-4, "grad")


def test_spectral_solve_matches_the_cg_and_warm_matches_cold():
    """In the empty box the exact spectral solve and the 3D 'pcg' route
    agree to the CG's tolerance; with the plate, a warm start from a
    perturbed solution gives the cold start's answer."""
    rng = np.random.default_rng(4)
    div = _t(rng.normal(size=(B, D, D, D)))
    _, empty = _domains(False, True)
    exact = solve_pressure(div, empty, backend="spectral")
    cg = solve_pressure(div, empty, tol=1e-7, maxiter=500, backend="pcg")
    _close(cg, exact.numpy(), 1e-5)
    _, plate = _domains(True, True)
    cold = solve_pressure(div, plate, tol=1e-7, maxiter=500)
    guess = cold + 0.1 * cold.std() * _t(rng.normal(size=div.shape))
    warm = solve_pressure(div, plate, tol=1e-7, maxiter=500, x0=guess)
    _close(warm, cold.numpy(), 1e-5)


# -------------------------------------------------------------------- step


def test_laplace_3d_matches_jax():
    f = np.random.default_rng(5).normal(size=(B, D, 6, 4)).astype(np.float32)
    _close(fluid3d.laplace_3d(_t(f), 0.5), jfluid.laplace_3d(jnp.asarray(f), 0.5),
           1e-6)


_STEP_CFG = dict(dt=0.7, buoyancy=0.05, pressure_tol=1e-6,
                 pressure_maxiter=500, warm_start_pressure=True)


def test_buoyancy_field_and_gather_step_match_jax():
    """A full (B, D, H, W) buoyancy factor (weighted at the centers, then
    moved to z-faces) and advection_mode='gather', without force, in the
    empty box."""
    jd, td = _domains(False, True)
    rng = np.random.default_rng(7)
    vel = _vel(rng, 0.4)
    rho = rng.uniform(0, 1, size=(B, D, D, D)).astype(np.float32)
    bf = rng.normal(size=rho.shape).astype(np.float32)
    cfg = dict(_STEP_CFG, advection_mode="gather", warm_start_pressure=False)
    js = jax.jit(lambda v, r, b: jfluid.fluid3d_step(
        jfluid.FluidState3D(jgrids.Staggered3D(*v), r), jd,
        jfluid.Fluid3DConfig(**cfg), buoyancy_factor=b))(
            tuple(map(jnp.asarray, vel)), jnp.asarray(rho), jnp.asarray(bf))
    ts = fluid3d.fluid3d_step(
        fluid3d.FluidState3D(grids3d.Staggered3D(*map(_t, vel)), _t(rho)), td,
        fluid3d.Fluid3DConfig(**cfg), buoyancy_factor=_t(bf))
    for k in ("vz", "vy", "vx"):
        _close(getattr(ts.velocity, k), getattr(js.velocity, k), 1e-5, k)
    _close(ts.density, js.density, 1e-5)
    assert ts.pressure is None


# -------------------------------------------------------------------- nets


def _net_pair(kind: str, dtype, rng):
    """The JAX package's net at dim=3, its flax params drawn from `rng`
    (kernels at variance 1/fan_in, biases at 0.1; the CFE's zero output
    layer included), and the port's net with them converted."""
    jd = {"bf16": jnp.bfloat16, "fp32": jnp.float32}[dtype]
    td = {"bf16": torch.bfloat16, "fp32": torch.float32}[dtype]
    if kind == "cfe":
        cin, cout = 6, 3
        jnet = jnets.CFENet(out_channels=cout, dim=3, dtype=jd)
        tnet = nets.CFENet(cin, cout, dtype=td, dim=3)
    else:
        cin, cout = 3, 1
        jnet = jnets.UNet(out_channels=cout, levels=2, base_features=16,
                          dim=3, dtype=jd)
        tnet = nets.UNet(cin, cout, levels=2, base_features=16, dtype=td,
                         dim=3)
    x = rng.uniform(-1, 1, size=(B, D, D, D, cin)).astype(np.float32)
    params = jax.eval_shape(jnet.init, jax.random.PRNGKey(0),
                            jnp.asarray(x))["params"]
    params = jax.tree_util.tree_map(
        lambda p: ((0.1 if p.ndim == 1 else 1 / np.sqrt(np.prod(p.shape[:-1])))
                   * rng.normal(size=p.shape)).astype(np.float32), params)
    sd = params_from_flax({"net": params})["net"]
    tnet.load_state_dict(sd)
    return jnet, params, tnet, x, sd


@pytest.mark.parametrize("kind", ["cfe", "unet"])
def test_nets_at_dim3_match_flax(kind):
    rng = np.random.default_rng(8)
    jnet, params, tnet, x, sd = _net_pair(kind, "bf16", rng)
    # DHWIO kernels cross both ways exactly.
    back = params_to_flax({"net": sd})["net"]
    for path, leaf in jax.tree_util.tree_leaves_with_path(params):
        node = back
        for k in path:
            node = node[k.key]
        np.testing.assert_array_equal(node, leaf)
    assert all(v.dim() == 5 for k, v in sd.items() if k.endswith("weight"))
    want = np.asarray(jax.jit(jnet.apply)({"params": params}, jnp.asarray(x)))
    got = tnet(torch.from_numpy(x)).detach().numpy()
    assert got.dtype == np.float32
    _close(got, want, 2e-2, "forward bf16")

    jnet, params, tnet, x, _ = _net_pair(kind, "fp32", rng)
    g = rng.normal(size=x.shape[:-1] + (want.shape[-1],)).astype(np.float32)
    jp, jx = jax.jit(lambda p, a, g: jax.vjp(
        lambda p, a: jnet.apply({"params": p}, a), p, a)[1](g))(
            params, jnp.asarray(x), jnp.asarray(g))
    xt = torch.from_numpy(x).requires_grad_(True)
    tnet(xt).backward(torch.from_numpy(g))
    _close(xt.grad, jx, 1e-4, "input gradient")
    jgrads = params_from_flax({"net": jax.device_get(jp)})["net"]
    for name, p in tnet.named_parameters():
        _close(p.grad, jgrads[name].numpy(), 1e-4, name)


def test_cuda_convs_stay_2d():
    """conv_impl='cuda' routes only 2D convs to the kernels: a 3D net under
    it runs cuDNN's conv3d, channels-first, like the default route."""
    rng = np.random.default_rng(9)
    x = torch.from_numpy(rng.uniform(-1, 1, size=(1, 4, 4, 4, 3)).astype(
        np.float32))
    a = nets.UNet(3, 1, levels=1, base_features=4, dim=3, conv_impl="cuda",
                  generator=torch.Generator().manual_seed(0))
    b = nets.UNet(3, 1, levels=1, base_features=4, dim=3,
                  generator=torch.Generator().manual_seed(0))
    assert not a.channels_last
    assert torch.equal(a(x), b(x))
    with pytest.raises(ValueError, match="1, 2 or 3"):
        nets.Conv(3, 4, dim=4)


# --------------------------------------------------------------------- PDE


_PDE_CFG = dict(dt=0.7, buoyancy=0.05, pressure_tol=1e-6,
                pressure_maxiter=500, warm_start_pressure=True)


def _pdes(control: str):
    """The JAX package's and the port's 3D PDE: 'direct' in the empty box;
    'buoyancy' with the plate, a force mask over the lower half and
    inflow."""
    buoy = control == "buoyancy"
    jd, td = _domains(buoy, True)
    mask = np.zeros((D, D, D), np.float32)
    mask[:D // 2] = 1.0
    kw = dict(control=control, with_inflow=buoy)
    jpde = JPDE(jd, jfluid.Fluid3DConfig(**_PDE_CFG),
                force_mask=jnp.asarray(mask) if buoy else None, **kw)
    tpde = IncompressibleFluid3DPDE(td, fluid3d.Fluid3DConfig(**_PDE_CFG),
                                    force_mask=mask if buoy else None, **kw)
    return jpde, tpde


def _batch(n: int, seed: int, inflow: bool) -> dict:
    rng = np.random.default_rng(seed)
    out = {"obs": rng.uniform(0, 1, size=(B, n + 1, D, D, D, 1)).astype(
        np.float32)}
    if inflow:
        out["inflow"] = rng.uniform(0, 0.1, size=(B, D, D, D)).astype(
            np.float32)
    return out


@pytest.mark.parametrize("control", ["direct", "buoyancy"])
def test_pde_glue_matches_jax(control):
    jpde, tpde = _pdes(control)
    buoy = control == "buoyancy"
    batch = _batch(1, 10, buoy)
    js = jpde.initial_state({k: jnp.asarray(v) for k, v in batch.items()})
    ts = tpde.initial_state({k: _t(v) for k, v in batch.items()})
    assert ts.pressure.shape == (B, D, D, D) and float(ts.pressure.abs().sum()) == 0
    target = batch["obs"][:, 1]
    np.testing.assert_array_equal(
        tpde.cfe_inputs(ts, _t(target)).numpy(),
        np.asarray(jpde.cfe_inputs(js, jnp.asarray(target))))
    assert tpde.cfe_inputs(ts, _t(target)).shape[-1] == (7 if buoy else 6)
    np.testing.assert_array_equal(
        tpde.op_inputs(_t(target), _t(target)).numpy(),
        np.asarray(jpde.op_inputs(jnp.asarray(target), jnp.asarray(target))))
    out = np.random.default_rng(11).normal(
        size=(B, D, D, D, 1 if buoy else 3)).astype(np.float32)
    jf = jpde.force_from_net(jnp.asarray(out), js)
    tf = tpde.force_from_net(_t(out), ts)
    for k in ("vz", "vy", "vx"):
        _close(getattr(tf, k), getattr(jf, k), 1e-6, k)
    _close(tpde.force_cost(tf), jpde.force_cost(jf), 1e-6)
    _close(tpde.force_abs_mean(tf), jpde.force_abs_mean(jf), 1e-6)
    zero = tpde.zero_force(ts)
    assert all(float(getattr(zero, k).abs().sum()) == 0 for k in ("vz", "vy", "vx"))
    tnext = tpde.step(ts, tf)  # fluid3d_step: held above
    assert torch.isfinite(tnext.density).all() and tnext.pressure is not None
    cfe = tpde.build_cfe(torch.Generator().manual_seed(0))
    assert cfe(tpde.cfe_inputs(ts, _t(target))).shape == out.shape
    op = tpde.build_op(torch.Generator().manual_seed(0))
    assert op(tpde.op_inputs(_t(target), _t(target))).shape == target.shape
    example = tpde.example_state(3)
    assert example.density.shape == (3, D, D, D)
    assert (example.inflow is not None) is buoy
    if buoy:
        with pytest.raises(ValueError, match="inflow"):
            tpde.initial_state({"obs": _t(batch["obs"])})


# -------------------------------------------------------------- experiment


def _blob_draws(key, b, d, h, w):
    """`random_blobs_3d`'s draws from `key` (margin 4 clamped, sigma 2-4)."""
    k_pos, k_sig = jax.random.split(key)
    m = min(4, max(1, min(d, h, w) // 3))
    pos = jax.random.uniform(k_pos, (b, 3), minval=jnp.array([m] * 3, jnp.float32),
                             maxval=jnp.array([d - m, h - m, w - m], jnp.float32))
    return pos, jax.random.uniform(k_sig, (b, 1, 1, 1), minval=2.0, maxval=4.0)


def _smooth_draws(key, b, modes=2):
    """`random_smooth_field_3d`'s draws from `key`."""
    k_amp, k_pz, k_py, k_px = jax.random.split(key, 4)
    return (jax.random.normal(k_amp, (b, modes, modes, modes)),
            *(jax.random.uniform(k, (b, modes, 1), maxval=2 * jnp.pi)
              for k in (k_pz, k_py, k_px)))


def test_constructions_from_jax_draws_match_jax():
    key = jax.random.PRNGKey(3)
    k1, k2 = jax.random.split(key)
    got = smoke3d.blobs3d_from_draws(*map(_t, _blob_draws(k1, 3, D, 6, 10)),
                                     D, 6, 10)
    _close(got, jsmoke3d.random_blobs_3d(k1, 3, D, 6, 10), 1e-6)
    got = smoke3d.smooth3d_from_draws(*map(_t, _smooth_draws(k2, 3)), D, 6, 10,
                                      amplitude=0.15)
    _close(got, jsmoke3d.random_smooth_field_3d(k2, 3, D, 6, 10,
                                                amplitude=0.15), 1e-6)


def test_port_draws_are_seeded_and_in_range():
    gen = lambda: torch.Generator().manual_seed(4)  # noqa: E731
    a = smoke3d.random_blobs_3d(gen(), 64, D, D, D)
    assert torch.equal(a, smoke3d.random_blobs_3d(gen(), 64, D, D, D))
    pos, sig = smoke3d.blob3d_draws(gen(), 64, 24, 24, 24)
    assert float(pos.min()) >= 4 and float(pos.max()) <= 20
    assert float(sig.min()) >= 2 and float(sig.max()) <= 4
    f = smoke3d.random_smooth_field_3d(gen(), 4, D, D, D)
    assert f.shape == (4, D, D, D) and torch.isfinite(f).all()


def test_dataset_from_jax_draws_matches_jax(monkeypatch):
    """`generate_forced_smoke3d_dataset` (8³, 5 trajectories in chunks of
    4, n=2), its draws replaced by the JAX package's for its seed."""
    num, n, seed = 5, 2, 7
    cfg = dict(_PDE_CFG, pressure_tol=1e-4, pressure_maxiter=200)
    key, draws = jax.random.PRNGKey(seed), []
    for b in (4, 1):
        key, k1, k2, k3, k4 = jax.random.split(key, 5)
        draws.append((_blob_draws(k1, b, D, D, D),
                      [_smooth_draws(k, b) for k in (k2, k3, k4)]))
    it = iter(draws)
    fields = []

    def blob_draws(gen, b, d, h, w):
        blob, field = next(it)
        fields.extend(field)
        return tuple(map(_t, blob))

    monkeypatch.setattr(smoke3d, "blob3d_draws", blob_draws)
    monkeypatch.setattr(smoke3d, "smooth3d_draws",
                        lambda gen, b: tuple(map(_t, fields.pop(0))))
    jd, td = _domains(False, True)
    got = smoke3d.generate_forced_smoke3d_dataset(
        td, fluid3d.Fluid3DConfig(**cfg), num, n, seed=seed)
    want = jsmoke3d.generate_forced_smoke3d_dataset(
        jd, jfluid.Fluid3DConfig(**cfg), num, n, seed=seed)
    assert got.obs.shape == want.obs.shape == (num, n + 1, D, D, D, 1)
    assert not got.extras and not want.extras
    _close(got.obs, want.obs, 1e-5)
    assert np.abs(got.obs[:, n] - got.obs[:, 0]).max() > 1e-3


def _ccfg(module, entry, monkeypatch, **kw):
    """The setup's physics and the CurriculumConfig `entry` hands to
    run_curriculum / finetune_e2e, with the datasets stubbed out."""
    got = []
    gen = "generate_forced_smoke3d_dataset"
    monkeypatch.setattr(module, gen, lambda domain, cfg, *a, **k:
                        got.append(("data", cfg, a, k)))
    for runner in ("run_curriculum", "finetune_e2e"):
        monkeypatch.setattr(module, runner, lambda pde, cfg, *a, **k:
                            got.append(("run", pde, cfg)) or {})
    extra = {"device": "cpu"} if module is smoke3d else {}
    getattr(module, entry)("unused", size=8, n=2, **kw, **extra)
    data = [(dataclasses.asdict(c), a, k) for _, c, a, k in got[:2]]
    _, pde, ccfg = got[2]
    return data, (pde.control, pde.unet_levels, pde.with_inflow,
                  pde.domain.has_obstacles), dataclasses.asdict(ccfg)


@pytest.mark.parametrize("entry, kw", [
    ("run_smoke3d", {}), ("run_smoke3d", dict(iterations=3, batch_size=8)),
    ("run_smoke3d_ft", dict(init_from="ckpt")),
])
def test_entries_match_jax(entry, kw, monkeypatch):
    got = _ccfg(smoke3d, entry, monkeypatch, **kw)
    want = _ccfg(jsmoke3d, entry, monkeypatch, **kw)
    assert got[0] == want[0] and got[1] == want[1]
    assert got[2] == {k: want[2][k] for k in got[2]}


def test_cli_smoke3d_on_the_cpu(tmp_path):
    """`run smoke3d --smoke-test` end to end on the CPU (8³, n=2), then
    `smoke3d_ft` from its ckpt_final."""
    import contextlib
    import io
    import json
    import os

    from pde_control_tpu_torch.experiments import run

    wd = str(tmp_path / "s3")
    with contextlib.redirect_stdout(io.StringIO()) as out:
        run.main(["smoke3d", "--smoke-test", "--device", "cpu", "--iterations",
                  "1", "--workdir", wd])
    with open(os.path.join(wd, "results.json")) as f:
        res = json.load(f)
    assert json.loads(out.getvalue())["eval"] == res["eval"]
    for key in ("cfe_supervised", "op2_supervised", "end_to_end_n2", "eval"):
        assert key in res, key
    assert np.isfinite(res["eval"]["final_state_mse"])
    ft = str(tmp_path / "ft")
    with contextlib.redirect_stdout(io.StringIO()):
        run.main(["smoke3d_ft", "--smoke-test", "--device", "cpu",
                  "--e2e-iterations", "1", "--workdir", ft, "--init-from",
                  os.path.join(wd, "ckpt_final")])
    with open(os.path.join(ft, "results.json")) as f:
        assert np.isfinite(json.load(f)["eval"]["final_state_mse"])
