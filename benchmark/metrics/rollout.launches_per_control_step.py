"""rollout.launches_per_control_step: device kernels the profiled control
step of the rollout ran (policy forward, env step, physics substeps)."""


def read(run):
    prof = run.get("profile")
    if not prof or not prof["kernels"]:
        return None
    return prof["kernels"]
