"""A tiny copy of a cell for runs on the CPU (the tests): the same
configuration at widths 16, a handful of envs and short clips, in a root of
its own that holds a manifest of one cell, its files and the real metric
readers."""

from __future__ import annotations

import json
import os
import shutil

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))  # benchmark/

TINY = {
    "train_setup.train_config.num_envs": 8,
    "train_setup.train_config.batch_size": 2,
    "train_setup.train_config.num_minibatches": 4,
    "train_setup.train_config.num_updates_per_batch": 2,
    "train_setup.train_config.unroll_length": 4,
    "network_config.encoder_layer_sizes": [16],
    "network_config.decoder_layer_sizes": [16],
    "network_config.critic_layer_sizes": [16],
    "network_config.intention_size": 4,
    "reference_config.clip_length": 40,
    "reference_config.random_init_range": 5,
}


def make_root(path: str, config: str = "rodent-sps-per-actor", limits: dict | None = None) -> str:
    """Writes a root with the one cell "tiny" and returns it."""
    from benchmark.harness.cell import set_dotted

    with open(os.path.join(HERE, "configs", config + ".json")) as f:
        cfg_file = json.load(f)
    for k, v in TINY.items():
        set_dotted(cfg_file["config"], k, v)
    os.makedirs(os.path.join(path, "benchmark", "configs"), exist_ok=True)
    os.makedirs(os.path.join(path, "benchmark", "traffic"), exist_ok=True)
    os.makedirs(os.path.join(path, "benchmark", "limits"), exist_ok=True)
    with open(os.path.join(path, "benchmark", "configs", "tiny.json"), "w") as f:
        json.dump(cfg_file, f)
    traffic = {"clips": 2, "unrolls_per_step": 1, "window_opens_at_step": 2, "checked_steps": 2,
               "checked_control_step": [2, 1], "profiled_control_step": [2, 2]}
    with open(os.path.join(path, "benchmark", "traffic", "tiny.json"), "w") as f:
        json.dump(traffic, f)
    with open(os.path.join(HERE, "..", "BENCHMARK.json")) as f:
        manifest = json.load(f)
    w = next(x for x in manifest["workloads"] if x["config"] == config)
    manifest["configs"] = [dict(c, name="tiny", file="benchmark/configs/tiny.json") for c in manifest["configs"]
                           if c["name"] == config]
    manifest["workloads"] = [dict(w, name="tiny", config="tiny", traffic="tiny")]
    for m in manifest["per_layer"]:
        m["workloads"] = ["tiny"] if w["name"] in m.get("workloads", [w["name"]]) else []
    with open(os.path.join(path, "BENCHMARK.json"), "w") as f:
        json.dump(manifest, f)
    with open(os.path.join(HERE, "limits", w["name"] + ".json")) as f:
        lim = json.load(f)
    if limits:
        lim["limits"].update(limits)
    with open(os.path.join(path, "benchmark", "limits", "tiny.json"), "w") as f:
        json.dump(lim, f)
    metrics = os.path.join(path, "benchmark", "metrics")
    if not os.path.exists(metrics):
        shutil.copytree(os.path.join(HERE, "metrics"), metrics)
    return path
