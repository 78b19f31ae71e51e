"""Saved-rollout analysis with the torch port (the counterpart of
examples/04_analyze_rollouts.py), on the host alone: load a rollout HDF5
(examples/torch/02_rollout_from_checkpoint.py writes one; so does the JAX
script), summarize its rewards and reward components, and make the video
of its intention trajectory's PCA projection
(`analysis.render.plot_pca_intention_video`; a .gif where imageio has no
ffmpeg).

Usage: python examples/torch/04_analyze_rollouts.py <rollout.h5> [out.mp4]
"""

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

from track_mjx_tpu_torch.analysis import utils as h5utils
from track_mjx_tpu_torch.analysis.render import plot_pca_intention_video


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("path")
    ap.add_argument("out", nargs="?", default="intention_pca.mp4")
    args = ap.parse_args(argv)

    data = h5utils.load_from_h5py(args.path)
    print("keys:", sorted(data.keys()))
    if "state_rewards" in data:
        r = np.asarray(data["state_rewards"])
        print(f"rewards: mean={r.mean():.3f} min={r.min():.3f} max={r.max():.3f}")
    if "rollout_metrics" in data:
        for k, v in sorted(data["rollout_metrics"].items()):
            print(f"  {k}: mean={np.asarray(v).mean():.4f}")
    # the intention trajectory: the saved activations, or the latent means
    intentions = None
    if isinstance(data.get("activations"), dict):
        intentions = data["activations"].get("intention")
    if intentions is None and "latent_means" in data:
        intentions = data["latent_means"]
    if intentions is None:
        print("no intention data in this rollout; no PCA video")
        return
    intentions = np.asarray(intentions).reshape(-1, np.asarray(intentions).shape[-1])
    written = plot_pca_intention_video(intentions, args.out)
    print("wrote the PCA intention video to", written)


if __name__ == "__main__":
    main()
