"""The port's data generation (``data/foam.py``, ``toy.py``, ``sinogram.py``,
``io.py`` and ``cli make-data``) against the JAX package on the CPU.

Both sides make the same images from the same seed; the sinograms of both
come from the gather projector (the CPU route of either package), so they
agree to float32 rounding.  Every file either package writes is read back
through both packages' readers.
"""

import os

import numpy as np
import pytest
import torch

from ct_pvae_tpu import cli as jax_cli
from ct_pvae_tpu.data import io as jax_io
from ct_pvae_tpu.data.foam import generate_foam_images as jax_foam
from ct_pvae_tpu.data.sinogram import make_dataset as jax_make_dataset
from ct_pvae_tpu.data.toy import generate_toy_images as jax_toy_images
from ct_pvae_tpu.data.toy import toy_theta as jax_toy_theta
from ct_pvae_tpu_torch import cli
from ct_pvae_tpu_torch.data import io
from ct_pvae_tpu_torch.data.foam import generate_foam_images
from ct_pvae_tpu_torch.data.sinogram import images_to_sinograms, make_dataset
from ct_pvae_tpu_torch.data.toy import generate_toy_images, toy_theta

SINO_RTOL = 1e-5  # the same gather projector on both sides: float32 rounding only
DATASET_FILES = ("x_train_sinograms.npy", "dataset_parameters.npy", "x_size.npy", "y_size.npy")


def test_foam_images_are_bit_identical():
    ours = generate_foam_images(3, n_pixel=32, seed=0)
    ref = jax_foam(3, n_pixel=32, seed=0)
    assert ours.dtype == ref.dtype == np.float32
    np.testing.assert_array_equal(ours, ref)


def test_toy_images_and_angles_are_identical():
    np.testing.assert_array_equal(generate_toy_images(3), jax_toy_images(3))
    assert generate_toy_images(3).dtype == jax_toy_images(3).dtype
    np.testing.assert_array_equal(toy_theta(), jax_toy_theta())
    assert toy_theta().dtype == np.float32
    # the continuous images: draws of toy_prior on the simplex (test_torch_eval.py holds them)
    cont = generate_toy_images(3, discrete=False)
    assert cont.shape == (3, 2, 2) and cont.dtype == np.float32
    np.testing.assert_allclose(cont.reshape(3, -1).sum(-1), 1.0, atol=1e-6)


def _assert_same_files(ours_dir, ref_dir, truth_ours, truth_ref):
    """The same dataset files, by name, shape and dtype, and the same values
    (sinograms to SINO_RTOL); each read back through both packages' readers."""
    assert sorted(os.listdir(ours_dir)) == sorted(os.listdir(ref_dir)) == sorted(DATASET_FILES)
    for name in DATASET_FILES:
        a = np.load(os.path.join(ours_dir, name), allow_pickle=True)
        b = np.load(os.path.join(ref_dir, name), allow_pickle=True)
        assert a.shape == b.shape and a.dtype == b.dtype, name
    for d in (ours_dir, ref_dir):
        for reader in (io.load_dataset, jax_io.load_dataset):
            sinos, theta, p = reader(d)
            ref_sinos, ref_theta, ref_p = jax_io.load_dataset(ref_dir)
            np.testing.assert_allclose(sinos, ref_sinos, rtol=0, atol=SINO_RTOL * np.abs(ref_sinos).max())
            np.testing.assert_array_equal(theta, ref_theta)
            assert p == ref_p
        for reader in (io.load_ground_truth, jax_io.load_ground_truth):
            np.testing.assert_array_equal(reader(d), np.load(truth_ref))
    truth = np.load(truth_ours)
    assert truth.dtype == np.load(truth_ref).dtype and truth.shape == np.load(truth_ref).shape


@pytest.mark.parametrize("img_type", ["foam", "toy"])
def test_make_dataset_writes_the_jax_files(img_type, tmp_path):
    kw = dict(num_angles=12, n_pixel=24, seed=3) if img_type == "foam" else {}
    n = 3 if img_type == "foam" else 8
    (tmp_path / "ours").mkdir()
    (tmp_path / "jax").mkdir()
    ours = make_dataset(img_type, n, save_path=str(tmp_path / "ours" / "dataset_x"), device="cpu", **kw)
    ref = jax_make_dataset(img_type, n, save_path=str(tmp_path / "jax" / "dataset_x"), **kw)
    np.testing.assert_array_equal(ours[0], ref[0])    # images
    np.testing.assert_array_equal(ours[2], ref[2])    # theta
    assert ours[1].shape == ref[1].shape and ours[1].dtype == np.float32
    np.testing.assert_allclose(ours[1], ref[1], rtol=0, atol=SINO_RTOL * np.abs(ref[1]).max())
    assert ours[1].min() >= 0
    _assert_same_files(str(tmp_path / "ours" / "dataset_x"), str(tmp_path / "jax" / "dataset_x"),
                       str(tmp_path / "ours" / "x_training.npy"), str(tmp_path / "jax" / "x_training.npy"))


def test_sinograms_do_not_depend_on_the_chunking():
    images = generate_foam_images(5, n_pixel=16, seed=1)
    theta = np.linspace(0, np.pi, 7, endpoint=False).astype(np.float32)
    whole = images_to_sinograms(images, theta, device="cpu")
    np.testing.assert_array_equal(images_to_sinograms(images, theta, batch=2, device="cpu"), whole)


def test_cli_make_data_writes_what_the_jax_cli_writes(tmp_path, monkeypatch, capsys):
    for side, main, extra in (("jax", jax_cli.main, []), ("ours", cli.main, ["--device", "cpu"])):
        (tmp_path / side).mkdir()
        monkeypatch.chdir(tmp_path / side)
        assert main(["make-data", "--img-type", "toy", "-n", "8", *extra]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[:3] == out[3:6] and out[0] == "Shape of sinograms: (8, 2, 2)"
    assert sorted(os.listdir(tmp_path / "ours")) == sorted(os.listdir(tmp_path / "jax")) == [
        "dataset_toy_discrete2", "toy_discrete2_training.npy"]
    _assert_same_files(str(tmp_path / "ours" / "dataset_toy_discrete2"),
                       str(tmp_path / "jax" / "dataset_toy_discrete2"),
                       str(tmp_path / "ours" / "toy_discrete2_training.npy"),
                       str(tmp_path / "jax" / "toy_discrete2_training.npy"))


def test_cli_make_data_refuses_what_is_not_ported(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    # real-data ingest is ported (test_torch_eval.py): an empty directory has no scans
    with pytest.raises(FileNotFoundError, match="no .h5 files"):
        cli.main(["make-data", "--h5-dir", str(tmp_path), "--device", "cpu"])
    # the card by default, with no silent CPU fallback
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(["make-data", "--img-type", "toy", "-n", "4"])
    assert not os.listdir(tmp_path)
