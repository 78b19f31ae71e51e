"""The plotting helpers of analysis/render.py against the JAX package's, on
the CPU (matplotlib, scikit-learn, imageio and IPython are installed here,
not on the card's machine).

- `plot_pca_intention_video`: on the same seeded intentions the port writes
  the JAX function's frames (read back with imageio; an mp4 asked for
  without ffmpeg becomes a .gif in both) from the same PCA embedding.
- `display_video`: the same HTML (imageio's writer replaced by one that
  writes the frames' bytes, as this machine has no mp4 backend), and
  without IPython the same base64 text.
- Without one of its packages each helper raises an ImportError that names
  it.
"""

import sys

import numpy as np
import pytest

from track_mjx_tpu.analysis import render as jrender
from track_mjx_tpu_torch.analysis import render

T, LATENTS = 12, 6


def _intentions():
    rng = np.random.RandomState(7)
    return np.cumsum(rng.randn(T, LATENTS), axis=0).astype(np.float32)


@pytest.fixture
def embeddings(monkeypatch):
    """Every PCA embedding fitted while the fixture is on."""
    from sklearn.decomposition import PCA

    seen = []
    fit = PCA.fit_transform

    def recording(self, x, *args, **kwargs):
        out = fit(self, x, *args, **kwargs)
        seen.append(np.array(out))
        return out

    monkeypatch.setattr(PCA, "fit_transform", recording)
    return seen


def test_pca_video_is_the_jax_one(tmp_path, embeddings):
    import imageio

    intentions = _intentions()
    want = jrender.plot_pca_intention_video(intentions, str(tmp_path / "jax.mp4"), fps=10, trail=4)
    got = render.plot_pca_intention_video(intentions, str(tmp_path / "port.mp4"), fps=10, trail=4)
    assert got.endswith(want[-4:]) and got != want
    jframes, frames = imageio.mimread(want), imageio.mimread(got)
    assert len(frames) == len(jframes) == T
    for k, (a, b) in enumerate(zip(frames, jframes)):
        np.testing.assert_array_equal(a, b, err_msg=f"frame {k}")
    assert len(embeddings) == 2 and embeddings[0].shape == (T, 2)
    np.testing.assert_array_equal(embeddings[1], embeddings[0])
    assert frames[0].std() > 0 and not np.array_equal(frames[0], frames[-1])


@pytest.fixture
def fake_mp4(monkeypatch):
    """imageio.mimsave replaced by a writer of the frames' bytes and fps."""
    import imageio

    def mimsave(path, frames, fps):
        with open(path, "wb") as f:
            f.write(np.asarray(frames).tobytes() + str(fps).encode())

    monkeypatch.setattr(imageio, "mimsave", mimsave)


@pytest.mark.parametrize("ipython", [True, False], ids=["html", "without IPython"])
def test_display_video_is_the_jax_one(fake_mp4, monkeypatch, ipython):
    frames = [np.full((4, 6, 3), k * 20, np.uint8) for k in range(5)]
    if not ipython:
        monkeypatch.setitem(sys.modules, "IPython", None)
        monkeypatch.setitem(sys.modules, "IPython.display", None)
    want, got = jrender.display_video(frames, fps=12), render.display_video(frames, fps=12)
    if ipython:
        assert type(got).__name__ == "HTML" and got.data == want.data and "base64," in got.data
    else:
        assert isinstance(got, str) and got == want


@pytest.mark.parametrize(
    "hidden, package",
    [("matplotlib", "matplotlib"), ("imageio", "imageio"), ("sklearn.decomposition", "scikit-learn")],
)
def test_pca_video_names_a_missing_package(monkeypatch, tmp_path, hidden, package):
    monkeypatch.setitem(sys.modules, hidden, None)
    with pytest.raises(ImportError, match=package):
        render.plot_pca_intention_video(_intentions(), str(tmp_path / "v.gif"))
    assert not list(tmp_path.iterdir())


def test_display_video_names_a_missing_package(monkeypatch):
    monkeypatch.setitem(sys.modules, "imageio", None)
    with pytest.raises(ImportError, match="imageio"):
        render.display_video([np.zeros((4, 4, 3), np.uint8)])
