"""Geometry, BSDF and camera functions of the port against the JAX package's,
in float64 on random inputs (rtol 1e-10)."""
import numpy as np
import pytest
import torch

from mcrt_tpu_torch.camera import camera as tcam
from mcrt_tpu_torch.materials import bsdf as tb
from mcrt_tpu_torch.ops import geometry as tg
from mcrt_tpu_torch.scene import loader as tl

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
from mcrt_tpu.camera import camera as jcam  # noqa: E402
from mcrt_tpu.materials import bsdf as jb  # noqa: E402
from mcrt_tpu.ops import geometry as jg  # noqa: E402
from mcrt_tpu.scene import loader as jl  # noqa: E402

torch.set_num_threads(1)  # pytest-xdist runs several workers on the same cores

N = 2048
RTOL, ATOL = 1e-10, 1e-12


def _close(got, want):
    if isinstance(got, (tuple, list)):
        assert len(got) == len(want)
        for a, b in zip(got, want):
            _close(a, b)
        return
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    if got.dtype == bool or np.issubdtype(got.dtype, np.integer):
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def _both(*arrays):
    return [torch.as_tensor(a) for a in arrays], [jnp.asarray(a) for a in arrays]


def _unit(rng, n, upper=None):
    v = rng.normal(size=(n, 3))
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    if upper is not None:
        v[:, 2] = np.abs(v[:, 2]) * upper
    return v


@pytest.fixture(scope="module")
def rng():
    return np.random.default_rng(7)


GEOMETRY = {
    "normalize": lambda m, a, b, u, v: m.normalize(a * 3.0),
    "reflect": lambda m, a, b, u, v: m.reflect(a, b),
    "orthonormal_basis": lambda m, a, b, u, v: m.orthonormal_basis(b),
    "to_local": lambda m, a, b, u, v: m.to_local(a, *m.orthonormal_basis(b), b),
    "from_local": lambda m, a, b, u, v: m.from_local(a, *m.orthonormal_basis(b), b),
    "cos_weighted_hemi": lambda m, a, b, u, v: m.cos_weighted_hemi(u, v),
    "uniform_disk": lambda m, a, b, u, v: m.uniform_disk(u, v),
    "power_heuristic": lambda m, a, b, u, v: m.power_heuristic(u, v),
    "length": lambda m, a, b, u, v: m.length(a * u[:, None]),
    "solve_quadratic": lambda m, a, b, u, v: m.solve_quadratic(u - 0.5, v - 0.3, u * v - 0.1),
}


@pytest.mark.parametrize("name", sorted(GEOMETRY))
def test_geometry(rng, name):
    a, b = _unit(rng, N), _unit(rng, N)
    u, v = rng.random(N), rng.random(N)
    (ta, tb_, tu, tv), (ja, jb_, ju, jv) = _both(a, b, u, v)
    _close(GEOMETRY[name](tg, ta, tb_, tu, tv), GEOMETRY[name](jg, ja, jb_, ju, jv))


def test_cdf_index(rng):
    cdf = np.cumsum(rng.random(37))
    cdf /= cdf[-1]
    u = np.concatenate([rng.random(N), cdf[:5]])      # exact ties pick the left index
    got = tg.cdf_index(torch.as_tensor(cdf), torch.as_tensor(u))
    _close(got, np.asarray(jg.cdf_index(jnp.asarray(cdf), jnp.asarray(u))).astype(np.int64))


def _materials(rng, n):
    rough = rng.random(n) < 0.4
    roughness = np.where(rough, rng.random(n), 0.0)
    spec_rough = np.where(rng.random(n) < 0.5, rng.uniform(0.02, 0.8, n), 0.0)
    transparency = np.where(rng.random(n) < 0.3, 1.0, np.where(rng.random(n) < 0.3, rng.random(n), 0.0))
    mirror = rng.random(n) < 0.1
    complex_ = (rng.random(n) < 0.15) & ~mirror
    var = roughness ** 2
    d = dict(
        reflectance=rng.random((n, 3)), specular_reflectance=rng.random((n, 3)),
        transmittance=rng.random((n, 3)), roughness=roughness, specular_roughness=spec_rough,
        transparency=transparency, ior=rng.uniform(1.0, 2.4, n), perfect_mirror=mirror,
        has_complex=complex_, complex_real=np.where(complex_[:, None], rng.uniform(0.1, 3, (n, 3)), 1.0),
        complex_imag=np.where(complex_[:, None], rng.uniform(0.5, 5, (n, 3)), 0.0),
        rough=roughness > 1e-9, rough_specular=spec_rough > 1e-9,
        opaque=(transparency < 1e-9) | complex_ | mirror,
        dirac_delta=(complex_ | mirror | (np.abs(transparency - 1) < 1e-9)) & ~(spec_rough > 1e-9),
        oren_A=1.0 - 0.5 * var / (var + 0.33), oren_B=0.45 * var / (var + 0.09),
    )
    return (tb.MatParams(**{k: torch.as_tensor(v) for k, v in d.items()}),
            jb.MatParams(**{k: jnp.asarray(v) for k, v in d.items()}))


@pytest.fixture(scope="module")
def shading(rng):
    tm, jm = _materials(rng, N)
    wo = _unit(rng, N, upper=1.0)
    wi = _unit(rng, N)
    n1 = np.where(rng.random(N) < 0.5, 1.0, rng.uniform(1.0, 2.0, N))
    n2 = np.where(rng.random(N) < 0.1, 0.8, rng.uniform(1.0, 2.5, N))
    inside = rng.random(N) < 0.3
    R = rng.random(N)
    event = rng.integers(0, 3, N).astype(np.int32)
    dirac = rng.random(N) < 0.3
    u, v = rng.random(N), rng.random(N)
    t_args, j_args = _both(wo, wi, n1, n2, inside, R, event, dirac, u, v)
    return tm, jm, t_args, j_args


BSDF = {
    "fresnel_dielectric": lambda m, mat, wo, wi, n1, n2, *_: m.fresnel_dielectric(n1, n2, wo[:, 2]),
    "fresnel_conductor": lambda m, mat, wo, wi, n1, n2, *_: m.fresnel_conductor(
        n1, mat.complex_real, mat.complex_imag, wo[:, 2]),
    "ggx_D": lambda m, mat, wo, wi, *_: m.ggx_D(wo, mat.specular_roughness + 0.1),
    "ggx_G2": lambda m, mat, wo, wi, *_: m.ggx_G2(wi, wo, mat.specular_roughness + 0.1),
    "ggx_reflection": lambda m, mat, wo, wi, *_: m.ggx_reflection(wi, wo, mat.specular_roughness + 0.1),
    "ggx_transmission": lambda m, mat, wo, wi, n1, n2, *_: m.ggx_transmission(
        wi, wo, n1, n2, mat.specular_roughness + 0.1),
    "ggx_visible_microfacet": lambda m, mat, wo, wi, n1, n2, ins, R, ev, dr, u, v:
        m.ggx_visible_microfacet(u, v, wo, mat.specular_roughness + 0.1),
    "diffuse_reflection": lambda m, mat, wo, wi, *_: m.diffuse_reflection(mat, wi, wo),
    "specular_reflection": lambda m, mat, wo, wi, *_: m.specular_reflection(mat, wi, wo),
    "specular_transmission": lambda m, mat, wo, wi, n1, n2, ins, *_: m.specular_transmission(
        mat, wi, wo, n1, n2, ins, False),
    "specular_transmission_flux": lambda m, mat, wo, wi, n1, n2, ins, *_: m.specular_transmission(
        mat, wi, wo, n1, n2, ins, True),
    "eval_layered": lambda m, mat, wo, wi, n1, n2, ins, R, ev, dr, u, v: m.eval_layered(
        mat, wo, wi, n1, n2, ins, R, mat.transparency, ev, False, dr),
    "eval_layered_flux": lambda m, mat, wo, wi, n1, n2, ins, R, ev, dr, u, v: m.eval_layered(
        mat, wo, wi, n1, n2, ins, R, mat.transparency, ev, True, dr),
    "select_event": lambda m, mat, wo, wi, n1, n2, ins, R, ev, dr, u, v: m.select_event(
        mat, n2, R, mat.transparency, u),
}


@pytest.mark.parametrize("name", sorted(BSDF))
def test_bsdf(shading, name):
    tm, jm, t_args, j_args = shading
    got = BSDF[name](tb, tm, *t_args)
    want = BSDF[name](jb, jm, *j_args)
    if name == "select_event":
        want = np.asarray(want).astype(np.int32)
    _close(got, want)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_fresnel_dielectric_grad_matches_jax(dtype):
    """The gradient of sum(fresnel_dielectric) with respect to n1, n2 and
    cos_theta equals jax.grad of the JAX package's within 1e-6 (float32) or
    1e-10 (float64) of each input's largest |g|, and is finite: on
    total-internal-reflection lanes down to a denormal cos_theta, and on lanes
    that refract."""
    cos = np.array([1e-10, 1e-20, 1e-30, 1e-38, 1e-45, 1e-300, 0.05, 0.3, 0.6, 0.9])
    n1 = np.where(np.arange(cos.size) < 6, 1.5, 1.0)
    n2 = np.where(np.arange(cos.size) < 6, 1.0, 1.5)
    args = [torch.tensor(x, dtype=getattr(torch, dtype), requires_grad=True) for x in (n1, n2, cos)]
    got = torch.autograd.grad(tb.fresnel_dielectric(*args).sum(), args)
    want = jax.grad(lambda *a: jb.fresnel_dielectric(*a).sum(), argnums=(0, 1, 2))(
        *(jnp.asarray(x, dtype) for x in (n1, n2, cos)))
    bar = 1e-6 if dtype == "float32" else 1e-10
    for g, w in zip(got, want):
        g, w = g.numpy(), np.asarray(w)
        assert np.isfinite(g).all()
        assert np.abs(g - w).max() <= bar * np.abs(w).max()


def test_pack_and_gather_materials():
    from mcrt_tpu_torch.scene.synthetic import height_field_scene

    j = height_field_scene(3, 8, 1)
    ts = tl.Scene(j).tables(np.float64, "cpu")
    js = jl.Scene(j).tables(jnp.float64)
    _close(tb.pack_materials(ts), jb.pack_materials(js))
    ids = np.array([0, 3, 1, 2, 2, 0], np.int32)
    _close(tuple(tb.gather_materials(ts, torch.as_tensor(ids))),
           tuple(jb.gather_materials(js, jnp.asarray(ids))))


CAMERAS = {
    "pinhole": {"focal_length": 35, "sensor_width": 36, "eye": [0.3, 1.2, -4.0],
                "look_at": [0.1, 0.5, 0.0]},
    "thin_lens": {"focal_length": 50, "sensor_width": 36, "eye": [1.0, 2.0, -5.0],
                  "look_at": [0.0, 0.0, 0.0], "f_stop": 2.8, "focus_distance": 4.0},
    "forward_up": {"focal_length": 24, "sensor_width": 36, "eye": [0.0, 1.0, 0.0],
                   "forward": [0.0, -0.2, 1.0], "up": [0.0, 1.0, 0.1]},
}


@pytest.mark.parametrize("name", sorted(CAMERAS))
def test_generate_rays(rng, name):
    c = dict(CAMERAS[name], image={"width": 40, "height": 30}, sqrtspp=2)
    tc, jc = tl.parse_camera(c), jl.parse_camera(c)
    px = rng.integers(0, 40, N)
    py = rng.integers(0, 30, N)
    si = rng.integers(0, 16, N)
    got = tcam.generate_rays(tc, torch.as_tensor(px), torch.as_tensor(py), torch.as_tensor(si),
                             global_seed=3, dtype=torch.float64)
    want = jcam.generate_rays(jc, jnp.asarray(px, jnp.uint32), jnp.asarray(py, jnp.uint32),
                              jnp.asarray(si, jnp.uint32), None, 3, jnp.float64)
    for field in ("origin", "direction", "px"):
        _close(getattr(got, field), getattr(want, field))
    for field in ("pixel_index", "sample_index"):
        _close(getattr(got, field), np.asarray(getattr(want, field)).astype(np.int64))
