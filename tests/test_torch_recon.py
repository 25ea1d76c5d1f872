"""The rest of the port's projector ops (``radon_fast``, ``radon_low_mem``,
``rotate_image``), the FBP route past 512 detector pixels and the Voronoi
weights, Fourier ``gridrec``, the ``gridrec_fourier`` init channel and the
roll augmentation, against the JAX package on the CPU.

The JAX references are computed once by a module-scoped fixture, in one
``jax.jit`` but for gridrec, whose matmul method needs concrete angles.  On the CPU both packages take the gather projector
and the pixel-driven backprojector; the CUDA routes (kernel C in
``radon_fast``, kernel D in ``fbp``) are held against their plain versions
on the card (``tests/test_torch_cuda.py``, ``chip_smoke.py``).
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ct_pvae_tpu.data.recon_init import classical_recon_stack as jax_stack
from ct_pvae_tpu.ops.gridrec import gridrec as jax_gridrec
from ct_pvae_tpu.vi.augment import roll_batch as jax_roll_batch
from ct_pvae_tpu_torch.config import Config
from ct_pvae_tpu_torch.data.recon_init import classical_recon_stack
from ct_pvae_tpu_torch.ops.fbp import fbp, voronoi_angle_weights
from ct_pvae_tpu_torch.ops.gridrec import gridrec
from ct_pvae_tpu_torch.ops.radon import radon, radon_fast, radon_low_mem, rotate_image
from ct_pvae_tpu_torch.vi.augment import roll_batch
from ct_pvae_tpu_torch.vi.train import Trainer

jradon = importlib.import_module("ct_pvae_tpu.ops.radon")  # the package re-exports radon()
jfbp = importlib.import_module("ct_pvae_tpu.ops.fbp")

CPU = torch.device("cpu")
RTOL = 1e-5      # relative to the reference's largest magnitude: float32 rounding
GRIDREC_RTOL = 1e-5  # the same, through the FFTs and the 16 scatter-adds
# matmul against scatter: a sample within rounding of a lattice point takes
# the tap set on either side (float64 tables, float32 scatter), which moves a
# kernel tail of 1/i0(beta) ~ 1e-3; the JAX package's own test allows rtol
# 2e-4 + atol 1e-4 on values of 0.05 (tests/test_radon.py)
METHODS_RTOL = 1e-3
N, A, P = 32, 12, 48  # 32^2 images, 12 angles, num_proj_pixels(32, 32) bins
WIDE = 512           # the detector from which the JAX package takes kernel D on a TPU
RNG = np.random.default_rng(11)
IMAGES = RNG.uniform(0, 1, (2, 16, 16)).astype(np.float32)
UNIFORM = np.linspace(0, np.pi, A, endpoint=False).astype(np.float32)
SPARSE = np.sort(RNG.uniform(0, np.pi, 5)).astype(np.float32)  # a random 5-angle subset
SINO = RNG.uniform(0, 1, (2, A, P)).astype(np.float32)
SINO5 = RNG.uniform(0, 1, (2, 5, P)).astype(np.float32)
ROT_ANGLES = RNG.uniform(-3, 3, 2).astype(np.float32)
STACK_4D = RNG.uniform(0, 1, (2, 16, 12, 3)).astype(np.float32)
# a smooth wide sinogram (a Gaussian profile per angle): the two backprojectors'
# interpolation positions differ by an ulp of t ~ 512, which a rough input would amplify
WIDE_THETA = UNIFORM[:4]
WIDE_SINO = np.exp(-((np.arange(WIDE)[None, None, :] - 250.0 - 20 * np.arange(4)[None, :, None])
                     / 60.0) ** 2).astype(np.float32)
ROLL = dict(proj_sample=RNG.uniform(0, 1, (3, A, 20)).astype(np.float32),
            mask=RNG.uniform(0, 1, (3, A)).astype(np.float32),
            input_encode=RNG.uniform(0, 1, (3, 14, 14, 2)).astype(np.float32))
ROLL_KEY = jax.random.PRNGKey(3)


def _rel(ours, ref):
    ours, ref = np.asarray(ours), np.asarray(ref)
    assert ours.shape == ref.shape
    return float(np.abs(ours - ref).max() / np.abs(ref).max())


@pytest.fixture(scope="module")
def ref():
    """Every JAX reference of this file but the init stack: one jit, and
    gridrec beside it."""

    def all_refs():
        theta = jnp.asarray(UNIFORM)
        img = jnp.asarray(IMAGES)
        out = {
            "radon_fast": jradon.radon_fast(img, UNIFORM, pad=True),
            "radon_low_mem": jradon.radon_low_mem(img, theta, pad=True, angle_chunk=4),
            "rotate 3d": jradon.rotate_image(img, jnp.asarray(ROT_ANGLES)),
            "rotate 4d": jradon.rotate_image(jnp.asarray(STACK_4D), jnp.asarray(ROT_ANGLES)),
            "voronoi uniform": jfbp.voronoi_angle_weights(theta),
            "voronoi sparse": jfbp.voronoi_angle_weights(jnp.asarray(SPARSE)),
            "fbp voronoi": jfbp.fbp(jnp.asarray(SINO5), jnp.asarray(SPARSE), N, N, "ramp", "voronoi"),
            "fbp wide": jfbp.fbp(jnp.asarray(WIDE_SINO), jnp.asarray(WIDE_THETA), 360, 360),
            "roll k": jax.random.randint(ROLL_KEY, (3,), 0, A),
            "roll": jax_roll_batch({k: jnp.asarray(v) for k, v in ROLL.items()}, theta, ROLL_KEY),
        }
        return out

    out = jax.jit(all_refs)()
    for method in ("matmul", "scatter"):  # outside the jit: matmul builds tables from concrete angles
        out[f"gridrec uniform {method}"] = jax_gridrec(jnp.asarray(SINO), UNIFORM, N, N, method=method)
        out[f"gridrec sparse {method}"] = jax_gridrec(jnp.asarray(SINO5), SPARSE, N, N, method=method)
    return jax.tree_util.tree_map(np.asarray, out)


def test_radon_fast_on_the_cpu_matches_jax(ref):
    ours = radon_fast(torch.from_numpy(IMAGES), UNIFORM, pad=True)
    assert _rel(ours, ref["radon_fast"]) <= RTOL
    # on the CPU it is the gather projector
    assert torch.equal(ours, radon(torch.from_numpy(IMAGES), torch.from_numpy(UNIFORM), pad=True))


def test_radon_low_mem_matches_jax_and_refuses_an_indivisible_chunk(ref):
    img, theta = torch.from_numpy(IMAGES), torch.from_numpy(UNIFORM)
    ours = radon_low_mem(img, theta, pad=True, angle_chunk=4)
    assert _rel(ours, ref["radon_low_mem"]) <= RTOL
    torch.testing.assert_close(ours, radon(img, theta, pad=True), rtol=0, atol=1e-5)
    with pytest.raises(ValueError, match="not divisible by angle_chunk 5"):
        radon_low_mem(img, theta, pad=True, angle_chunk=5)
    with pytest.raises(ValueError, match="not divisible"):
        jradon.radon_low_mem(jnp.asarray(IMAGES), jnp.asarray(UNIFORM), pad=True, angle_chunk=5)


@pytest.mark.parametrize("layout", ["3d", "4d"])
def test_rotate_image_matches_jax(ref, layout):
    images = IMAGES if layout == "3d" else STACK_4D
    ours = rotate_image(torch.from_numpy(images), torch.from_numpy(ROT_ANGLES))
    assert _rel(ours, ref[f"rotate {layout}"]) <= RTOL


def test_rotation_rolls_the_sinogram():
    """radon(rotate_image(x, theta_k)) is radon(x) rolled by k rows, the
    wrapped rows detector-flipped (the JAX package's
    test_rotate_image_roll_consistency, on the port)."""
    n, num_angles = 32, 24
    yy, xx = np.mgrid[0:n, 0:n]
    img = np.stack([np.exp(-(((xx - 20) ** 2 + (yy - 12) ** 2) / 18.0)),
                    np.exp(-(((xx - 10) ** 2 + (yy - 18) ** 2) / 30.0))]).astype(np.float32)
    img = img * (((xx - (n - 1) / 2) ** 2 + (yy - (n - 1) / 2) ** 2) < (n / 3) ** 2)
    theta = torch.from_numpy(np.linspace(0, np.pi, num_angles, endpoint=False).astype(np.float32))
    x = torch.from_numpy(img.astype(np.float32))
    sino = radon(x, theta, pad=True)
    for k in (0, 5, 17):
        rolled = torch.roll(sino, k, dims=1)
        wrap = (torch.arange(num_angles) < k)[None, :, None]
        want = torch.where(wrap, rolled.flip(-1), rolled)
        got = radon(rotate_image(x, theta[[k, k]]), theta, pad=True)
        # the JAX test's bound: interior bins (the rim interpolates otherwise),
        # bilinear rotation and projection errors only
        err = float((got - want)[:, :, 8:-8].abs().max() / sino.abs().max())
        assert err < 0.06, (k, err)
        # and roll_batch rolls the sinogram so
        batch = {"proj_sample": sino, "mask": torch.ones(2, num_angles),
                 "input_encode": x[..., None]}
        out = roll_batch(batch, theta, torch.tensor([k, k]))
        assert torch.equal(out["proj_sample"], want)


@pytest.mark.parametrize("angles", ["uniform", "sparse"])
def test_voronoi_weights_match_jax(ref, angles):
    theta = UNIFORM if angles == "uniform" else SPARSE
    ours = voronoi_angle_weights(torch.from_numpy(theta))
    assert ours.dtype == torch.float32
    np.testing.assert_allclose(ours.numpy(), ref[f"voronoi {angles}"], rtol=1e-6, atol=0)
    assert abs(float(ours.sum()) - np.pi) < 1e-5  # the cells tile the half-circle
    if angles == "uniform":
        np.testing.assert_allclose(ours.numpy(), np.pi / A, rtol=1e-5)


def test_fbp_with_voronoi_weights_matches_jax(ref):
    ours = fbp(torch.from_numpy(SINO5), torch.from_numpy(SPARSE), N, N, "ramp", "voronoi")
    assert _rel(ours, ref["fbp voronoi"]) <= RTOL
    with pytest.raises(ValueError, match="angle_weights"):
        fbp(torch.from_numpy(SINO5), torch.from_numpy(SPARSE), N, N, angle_weights="cells")


def test_fbp_past_512_detector_pixels_matches_jax(ref):
    """A 512-pixel detector onto a square 360^2 image, batch 1: the JAX
    package takes its gather backprojector off the TPU, and so does the
    port on the CPU (kernel D on the card)."""
    ours = fbp(torch.from_numpy(WIDE_SINO), torch.from_numpy(WIDE_THETA), 360, 360)
    assert ours.shape == (1, 360, 360)
    assert _rel(ours, ref["fbp wide"]) <= RTOL


@pytest.mark.parametrize("method", ["matmul", "scatter"])
@pytest.mark.parametrize("angles", ["uniform", "sparse"])
def test_gridrec_matches_jax(ref, angles, method):
    sino, theta = (SINO, UNIFORM) if angles == "uniform" else (SINO5, SPARSE)
    ours = gridrec(torch.from_numpy(sino), torch.from_numpy(theta), N, N, method=method)
    assert ours.shape == (2, N, N) and ours.dtype == torch.float32
    assert _rel(ours, ref[f"gridrec {angles} {method}"]) <= GRIDREC_RTOL


@pytest.mark.parametrize("angles", ["uniform", "sparse"])
def test_gridrec_methods_agree(angles):
    sino, theta = (SINO, UNIFORM) if angles == "uniform" else (SINO5, SPARSE)
    s, t = torch.from_numpy(sino), torch.from_numpy(theta)
    scatter = gridrec(s, t, N, N, method="scatter")
    assert _rel(gridrec(s, t, N, N, method="matmul"), scatter) <= METHODS_RTOL
    assert torch.equal(gridrec(s, t, N, N), gridrec(s, t, N, N, method="matmul"))  # small tables
    with pytest.raises(ValueError, match="unknown method"):
        gridrec(s, t, N, N, method="nufft")


def test_init_stack_gridrec_fourier_matches_jax():
    rng = np.random.default_rng(4)
    sino = rng.uniform(0, 1, (4, A, 36)).astype(np.float32)
    masks = np.zeros((4, A), np.float32)
    masks[:, ::3] = 0.25
    theta = UNIFORM
    algs = ["gridrec_fourier", "gridrec"]
    ours = classical_recon_stack(sino, masks, theta, algs, 20, 20, CPU)
    want = jax_stack(sino, masks, theta, algs, 20, 20)
    assert ours.shape == (4, 20, 20, 3)
    for c, name in enumerate(algs + ["mask"]):
        assert _rel(ours[..., c], want[..., c]) <= GRIDREC_RTOL, name


def test_roll_batch_matches_jax(ref):
    k = torch.from_numpy(ref["roll k"].astype(np.int64))
    ours = roll_batch({name: torch.from_numpy(v) for name, v in ROLL.items()},
                      torch.from_numpy(UNIFORM), k)
    np.testing.assert_array_equal(ours["proj_sample"].numpy(), ref["roll"]["proj_sample"])
    np.testing.assert_array_equal(ours["mask"].numpy(), ref["roll"]["mask"])
    assert _rel(ours["input_encode"], ref["roll"]["input_encode"]) <= RTOL


def test_trainer_with_roll_augment_takes_steps(tmp_path):
    """``roll_augment`` no longer raises: a small Trainer takes 2 steps with
    finite losses, its roll indices restart-invariant, in [0, A)."""
    rng = np.random.default_rng(6)
    sinos = rng.uniform(0, 5, (4, A, 64)).astype(np.float32)
    cfg = Config(truncate_dataset=4, batch_size=2, num_sparse_angles=4, angles_per_iter=5,
                 random_angles=True, num_samples=2, poisson_noise_multiplier=1e4, num_iter=2,
                 algorithms=["fbp"], num_blocks=2, num_feature_maps=4, intermediate_layers=1,
                 use_normal=True, train=True, roll_augment=True, metrics_every=1,
                 save_path=str(tmp_path), seed=2)
    tr = Trainer(cfg, sinos, UNIFORM, CPU)
    k = tr.roll_indices(0)
    assert k.shape == (2,) and int(k.min()) >= 0 and int(k.max()) < A
    assert torch.equal(k, tr.roll_indices(0)) and not torch.equal(tr.roll_indices(0), tr.roll_indices(1))
    tr.train()
    losses = np.load(tmp_path / "train_loss_vec.npy")
    assert losses.shape == (2,) and np.isfinite(losses).all()
